"""PyTorch port vs the JAX package: the SPT train step, the training loop,
checkpoints both ways and the tune CLI, on the CPU (tiny configs).

The same weights (the port's seeded init_params and surgery, LoRA right
factors drawn from numpy) and batches go through JAX's jitted
make_train_step and the port's. Adam moves each weight by about lr·sign(g)
on its first steps, so an entry whose true gradient is ~0 can move ±lr in
one implementation and not the other once two summation orders differ:
step 0 is held tightly (loss, metrics, gradients), later steps on their
losses and on the parameters whose step-0 gradient stands well above that
noise.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu import config as jcfg
from spt_proto_tpu.models.decoder import DecoderLM as JDecoderLM
from spt_proto_tpu.tuning import trainer as jtrainer
from spt_proto_tpu.tuning.partition import trainable_mask as jmask
from spt_proto_tpu.utils import checkpoint as jckpt
from spt_proto_tpu_torch import config as tcfg
from spt_proto_tpu_torch.cli import tune
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.models.decoder import DecoderLM
from spt_proto_tpu_torch.tuning import partition, surgery, trainer
from spt_proto_tpu_torch.utils import checkpoint as tckpt
from spt_proto_tpu_torch.utils.tree import flatten, unflatten

torch.set_num_threads(1)


def jax_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name in ('dtype', 'param_dtype'):
        kw[name] = jnp.dtype(str(kw[name]).removeprefix('torch.'))
    return jcfg.ModelConfig(**kw)


def tuned_tiny(arch='opt', seed=0, **kw):
    """A tiny config after the four stages (d_lora 4, blocks of 32), port
    params as numpy with random LoRA right factors."""
    base = dict(vocab_size=64, **kw)
    cfg = tcfg.tiny_config(arch, **base)
    params = surgery.init_params(cfg, seed, 'cpu')
    cfg, params = surgery.full_upgrade(cfg, params, seed + 1, d_lora=4,
                                       ffn_block_size=32)
    flat = flatten(bridge.params_to_numpy(params))
    r = np.random.RandomState(seed + 7)
    for path in flat:
        if 'lora_right' in path:
            flat[path] = (r.randn(*flat[path].shape) * 0.1).astype(np.float32)
    return cfg, unflatten(flat)


def make_batches(vocab, n, batch=4, seq=32, seed=0):
    """tests/test_train_e2e.py's learnable synthetic language: token t+1 =
    (3 t + 1) % V from a random start."""
    r = np.random.RandomState(seed)
    for _ in range(n):
        x = np.zeros((batch, seq), np.int32)
        x[:, 0] = r.randint(0, vocab, size=batch)
        for j in range(1, seq):
            x[:, j] = (x[:, j - 1] * 3 + 1) % vocab
        yield {'inputs': x[:, :-1], 'targets': x[:, 1:]}


def random_batches(vocab, n, batch=2, seq=32, seed=3):
    r = np.random.RandomState(seed)
    for _ in range(n):
        x = r.randint(0, vocab, size=(batch, seq)).astype(np.int32)
        yield {'inputs': x[:, :-1], 'targets': x[:, 1:]}


@pytest.mark.parametrize('arch,kw', [('opt', {}),
                                     ('llama', dict(n_kv_heads=2))],
                         ids=['opt', 'llama-gqa'])
def test_train_step_matches_jax(arch, kw):
    """make_train_step, 3 steps, port vs JAX (masked AdamW, clip 1.0, CE +
    1e-2 PQ aux, f32). Step 0: loss, ce, pq_loss and grad_norm to 1e-5
    relative, gradients to 1e-4 of each leaf's largest. Steps 1-2: losses
    to 1e-5 relative. After 3 steps, trainable entries whose step-0 |g| is
    above 1e-2 of their leaf's largest to 1e-6 (the others may differ by
    the Adam noise above, up to 3 lr)."""
    cfg, params = tuned_tiny(arch, **kw)
    batches = list(random_batches(cfg.vocab_size, 3))
    jc = jax_config(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    tx = jtrainer.make_optimizer(jp)
    jstep = jax.jit(jtrainer.make_train_step(jc, tx, trainable=jmask(jp)))
    jstate = jtrainer.TrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))

    # step-0 gradients of both, outside the steps
    def jloss(t, frozen):
        out = JDecoderLM(cfg=jc, train_quantizer=True).apply(
            {'params': unflatten({**t, **frozen})},
            jnp.asarray(batches[0]['inputs']))
        return jtrainer.lm_loss(out['logits'],
                                jnp.asarray(batches[0]['targets'])) + \
            jtrainer.AUX_LOSS_COEFF * out['pq_loss']
    flat = flatten(params)
    train = {k: v for k, v in flat.items() if partition.is_trainable_path(k)}
    frozen = {k: v for k, v in flat.items() if k not in train}
    jg = jax.jit(jax.grad(jloss))(train, frozen)
    state = trainer.create_train_state(
        cfg, bridge.params_from_numpy(params, 'cpu'))
    model = state.model
    model.train_quantizer = True
    out = model(torch.from_numpy(batches[0]['inputs']))
    (trainer.lm_loss(out['logits'], torch.from_numpy(batches[0]['targets']))
     + trainer.AUX_LOSS_COEFF * out['pq_loss']).backward()
    g0 = {k: p.grad.clone() for k, p in flatten(model.tree()).items()
          if p.requires_grad}
    model.zero_grad(set_to_none=True)
    assert g0.keys() == jg.keys()
    for k, w in jg.items():
        w = np.asarray(w)
        np.testing.assert_allclose(g0[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)

    step = trainer.make_train_step(cfg)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, batch)
        state, tm = step(state, batch)
        names = ('loss', 'ce', 'pq_loss', 'grad_norm') if i == 0 \
            else ('loss', 'ce')
        for name in names:
            np.testing.assert_allclose(tm[name].item(), float(jm[name]),
                                       rtol=1e-5, err_msg=f'{i} {name}')
    assert state.step == 3
    tp, jpf = flatten(state.params), flatten(jax.device_get(jstate.params))
    for k, w in jpf.items():
        got = tp[k].detach().numpy()
        if k not in jg:
            np.testing.assert_array_equal(got, w, err_msg=k)   # frozen
            continue
        g = np.abs(np.asarray(jg[k]))
        sure = g > 1e-2 * g.max()
        np.testing.assert_allclose(got[sure], w[sure], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert np.abs(got - w).max() <= 3 * 1e-4 + 1e-6, k


def clone(params):
    """A copy of a tree (train_loop trains the tensors it is given)."""
    return unflatten({k: v.clone() for k, v in flatten(params).items()})


def test_training_loss_decreases():
    """test_train_e2e.py's test_sparse_training_loss_decreases on the
    port: the full pipeline, 60 steps at lr 3e-3 on a learnable stream."""
    cfg = tcfg.tiny_config('opt', vocab_size=64)
    params = surgery.init_params(cfg, 0, 'cpu')
    cfg, params = surgery.full_upgrade(cfg, params, 1, d_lora=4,
                                       ffn_block_size=32)
    _, history = trainer.train_loop(cfg, params, make_batches(64, 60),
                                    lr=3e-3, max_steps=60, log_every=1)
    losses = [m['ce'] for _, m in history]
    assert len(losses) == 60 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_frozen_params_unchanged_lora_trained():
    """test_train_e2e.py's test_frozen_params_unchanged_lora_trained on the
    port: frozen leaves bit-exact after 10 steps at lr 1e-2, LoRA right
    factors, routers and codebooks moved; the loop trains the caller's
    tensors in place (the returned leaves are the caller's storage); the
    eval step's ce and ppl on the tuned tree."""
    cfg = tcfg.tiny_config('opt', vocab_size=64)
    params = surgery.init_params(cfg, 0, 'cpu')
    cfg, params = surgery.full_upgrade(cfg, params, 1, d_lora=4,
                                       ffn_block_size=32)
    before = {k: v.clone() for k, v in flatten(params).items()}
    tuned, _ = trainer.train_loop(cfg, params, make_batches(64, 10),
                                  lr=1e-2, max_steps=10)
    after = flatten(tuned)
    for k, v in flatten(params).items():
        assert after[k].data_ptr() == v.data_ptr(), f'{k} not in place'
        assert torch.equal(v, after[k]), k
    changed = {k for k in before if not torch.allclose(before[k], after[k])}
    for k in before:
        if not partition.is_trainable_path(k):
            assert torch.equal(before[k], after[k]), f'frozen {k} changed'
    for marker in ('lora_right', 'router', 'codebook'):
        assert any(marker in k for k in changed), marker
    batch = next(make_batches(64, 1, seed=1))
    ev = trainer.make_eval_step(cfg)(tuned, batch)
    want = trainer.lm_loss(DecoderLM(cfg, tuned)(
        torch.from_numpy(batch['inputs']))['logits'],
        torch.from_numpy(batch['targets']))
    assert ev['logits'].shape == (4, 31, 64) and not ev['ce'].requires_grad
    torch.testing.assert_close(ev['ce'], want.detach())
    torch.testing.assert_close(ev['ppl'], torch.exp(want.detach()))


def test_train_state_resume_continues_exactly(tmp_path):
    """4 steps straight equal 2 steps, a saved train state, and 2 resumed
    steps on the same stream (params, optimizer moments and step)."""
    cfg, params = tuned_tiny()
    params = bridge.params_from_numpy(params, 'cpu')
    stream = list(random_batches(64, 4))
    full, _ = trainer.train_loop(cfg, clone(params), stream, lr=1e-3)
    d = str(tmp_path / 'state')
    trainer.train_loop(cfg, clone(params), stream[:2], lr=1e-3,
                       checkpoint_dir=d)
    resumed, _ = trainer.train_loop(cfg, clone(params), stream[2:], lr=1e-3,
                                    checkpoint_dir=d, resume=True)
    for k, v in flatten(full).items():
        assert torch.equal(flatten(resumed)[k], v), k


def test_checkpoints_load_in_both_packages(tmp_path):
    """A port-tuned tiny checkpoint loaded by the JAX package's
    load_checkpoint gives the port's logits through JAX's DecoderLM, and a
    checkpoint JAX's save_checkpoint wrote loads in the port and gives
    JAX's logits (f32, 1e-5); the delta checkpoint restores the tuned
    tree."""
    cfg, params = tuned_tiny()
    base = bridge.params_from_numpy(params, 'cpu')
    tuned, _ = trainer.train_loop(cfg, clone(base), random_batches(64, 2),
                                  lr=1e-2)
    tokens = np.random.RandomState(5).randint(0, 64, (2, 31)).astype(np.int32)
    port_logits = DecoderLM(cfg, tuned)(torch.from_numpy(tokens))['logits']
    tckpt.save_checkpoint(str(tmp_path / 'port'), cfg, tuned)
    jc, jp = jckpt.load_checkpoint(str(tmp_path / 'port'))
    assert jc == jax_config(cfg)
    jl = jax.jit(JDecoderLM(cfg=jc).apply)({'params': jp},
                                           jnp.asarray(tokens))
    np.testing.assert_allclose(np.asarray(jl['logits']),
                               port_logits.detach().numpy(), rtol=0,
                               atol=1e-5)
    # the reverse: a checkpoint the JAX package wrote (LLaMA GQA) through
    # the port
    lc, lp = tuned_tiny('llama', n_kv_heads=2)
    jckpt.save_checkpoint(str(tmp_path / 'jax'), jax_config(lc), lp)
    tc, tp = tckpt.load_checkpoint(str(tmp_path / 'jax'), device='cpu')
    assert tc == lc
    want = jax.jit(JDecoderLM(cfg=jax_config(lc)).apply)(
        {'params': jax.tree.map(jnp.asarray, lp)}, jnp.asarray(tokens))
    got = DecoderLM(tc, tp)(torch.from_numpy(tokens))['logits']
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want['logits']), rtol=0, atol=1e-5)
    n = tckpt.save_delta_checkpoint(str(tmp_path / 'delta'), cfg, base,
                                    tuned)
    assert 0 < n < sum(v.numel() for v in flatten(base).values())
    _, restored = tckpt.load_delta_checkpoint(str(tmp_path / 'delta'), base,
                                              device='cpu')
    for k, v in flatten(tuned).items():
        assert torch.allclose(flatten(restored)[k], v, atol=1e-3), k


def test_tune_cli_two_steps(tmp_path, capsys):
    """cli.tune.main on the CPU at tiny-opt: 2 steps of the four-stage
    pipeline, the JSON lines, and a checkpoint the JAX package loads; the
    unported flags raise naming their slice (--int8_base runs: see
    test_torch_int8_base.py; --data_root: test_torch_cli.py)."""
    out = str(tmp_path / 'tuned')
    argv = ['--device', 'cpu', '--config', 'tiny-opt', '--steps', '2',
            '--seq_length', '33', '--batch_size', '2', '--out', out]
    tune.main(argv)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]['step'] == 0 and np.isfinite(lines[0]['loss'])
    assert lines[0]['pq_loss'] > 0
    assert lines[-1]['saved'] == out and lines[-1]['delta_params'] > 0
    jc, jp = jckpt.load_checkpoint(out)
    assert jc.attention == 'sparse_v2' and jc.ffn == 'routed'
    assert jc.d_lora == 16 and 'router' in jp['blocks']['ffn']
    for flag, slice_ in (('--mesh_sp=2', 'parallelism slice'),
                         ('--fsdp', 'parallelism slice')):
        with pytest.raises(NotImplementedError, match=slice_):
            tune.main(argv + [flag])
