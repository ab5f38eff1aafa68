"""PyTorch port vs the JAX package: DecoderLM at every upgrade stage, on
the CPU, and the port's staged upgrades.

The same weights (the port's seeded init_params, LoRA right factors set
from a numpy seed so that every trainable leaf gets a gradient) and tokens
go through `DecoderLM.apply` + `jax.value_and_grad` and through the port's
DecoderLM + autograd: logits, pq_loss, the training loss (CE + 1e-2 pq)
and the gradient of every trainable leaf, at tiny_config OPT and LLaMA
GQA. Sparse_v2 runs 'ref' (per-row) at S = 31 and 'pallas' at S = 256 (the
JAX kernels in interpret mode against the port's differentiable wrapper,
whose CPU path runs the forward and backward twins); the mha_v1 stage also
runs 'pallas' at S = 128, the smallest length that takes the dense flash
kernel (JAX's stock kernel forced into TPU interpret mode, the port's
flash-attention twins).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spt_proto_tpu import config as jcfg
from spt_proto_tpu.models.decoder import DecoderLM as JDecoderLM
from spt_proto_tpu.tuning import trainer as jtrainer
from spt_proto_tpu_torch import config as tcfg
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.models.decoder import DecoderLM
from spt_proto_tpu_torch.tuning import partition, surgery, trainer
from spt_proto_tpu_torch.utils.tree import flatten, unflatten

torch.set_num_threads(1)

ARCHS = {'opt': dict(vocab_size=64),
         'llama-gqa': dict(vocab_size=64, n_kv_heads=2)}
# cumulative stages: (name, stages applied, S, attn_impl)
STAGE_CASES = [('lora', ('lora',), 31, 'ref'),
               ('ffn', ('lora', 'ffn'), 31, 'ref'),
               ('mha_v1', ('lora', 'ffn', 'mha_v1'), 31, 'ref'),
               ('mha_v1-pallas', ('lora', 'ffn', 'mha_v1'), 128, 'pallas'),
               ('mha_v2-ref', surgery.STAGES, 31, 'ref'),
               ('mha_v2-pallas', surgery.STAGES, 256, 'pallas')]
STAGE_KW = {'lora': dict(d_lora=4), 'ffn': dict(ffn_block_size=32)}


def jax_config(cfg):
    """The port's ModelConfig as the JAX package's (jnp dtypes)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name in ('dtype', 'param_dtype'):
        kw[name] = jnp.dtype(str(kw[name]).removeprefix('torch.'))
    return jcfg.ModelConfig(**kw)


def staged_model(arch, stages, max_length=256, seed=0):
    """(port cfg, numpy params): the port's surgery from a seeded init,
    LoRA right factors drawn from numpy (they start at zero)."""
    base = arch.split('-')[0]
    cfg = tcfg.tiny_config(base, max_length=max_length, **ARCHS[arch])
    params = surgery.init_params(cfg, seed, 'cpu')
    for i, stage in enumerate(stages):
        cfg, params = surgery.upgrade(cfg, params, stage, seed + 1 + i,
                                      **STAGE_KW.get(stage, {}))
    flat = flatten(bridge.params_to_numpy(params))
    r = np.random.RandomState(seed + 7)
    for path in flat:
        if 'lora_right' in path:
            flat[path] = (r.randn(*flat[path].shape) * 0.1).astype(np.float32)
    return cfg, unflatten(flat)


def jax_loss_and_grads(cfg, params, tokens, targets):
    """JAX: (logits, pq_loss, loss, grads of the trainable leaves)."""
    jc = jax_config(cfg)
    model = JDecoderLM(cfg=jc, train_quantizer=True)
    flat = flatten(params)
    train = {k: jnp.asarray(v) for k, v in flat.items()
             if partition.is_trainable_path(k)}
    frozen = {k: jnp.asarray(v) for k, v in flat.items() if k not in train}

    def f(t):
        out = model.apply({'params': unflatten({**t, **frozen})},
                          jnp.asarray(tokens))
        ce = jtrainer.lm_loss(out['logits'], jnp.asarray(targets))
        return ce + jtrainer.AUX_LOSS_COEFF * out['pq_loss'], out
    (loss, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(train)
    return (np.asarray(out['logits']), float(out['pq_loss']), float(loss),
            {k: np.asarray(v) for k, v in grads.items()})


def port_loss_and_grads(cfg, params, tokens, targets):
    model = DecoderLM(cfg, bridge.params_from_numpy(params, 'cpu'),
                      train_quantizer=True,
                      trainable=partition.is_trainable_path)
    out = model(torch.from_numpy(tokens))
    loss = trainer.lm_loss(out['logits'], torch.from_numpy(targets)) + \
        trainer.AUX_LOSS_COEFF * out['pq_loss']
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in flatten(model.tree()).items()
             if p.requires_grad}
    return (out['logits'].detach().numpy(), out['pq_loss'].item(),
            loss.item(), grads)


def assert_grads_close(got, want):
    """Each trainable leaf to 1e-4 of its largest entry (XLA and torch sum
    in other orders; f32)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)


@pytest.mark.parametrize('arch', list(ARCHS))
@pytest.mark.parametrize('name,stages,s,impl', STAGE_CASES,
                         ids=[c[0] for c in STAGE_CASES])
def test_decoder_matches_jax_at_every_stage(arch, name, stages, s, impl):
    """Logits to 1e-5 of their largest, pq_loss and the loss to 1e-5
    relative, trainable gradients to 1e-4 of each leaf's largest (f32)."""
    cfg, params = staged_model(arch, stages)
    cfg = cfg.replace(attn_impl=impl)
    r = np.random.RandomState(len(name) + s)
    seq = r.randint(0, cfg.vocab_size, size=(2, s + 1)).astype(np.int32)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    # the stock flash kernel of dense attention runs on the TPU only unless
    # forced into interpret mode (the block-sparse kernels choose it
    # themselves off the TPU)
    dense_flash = impl == 'pallas' and 'mha_v2' not in stages
    with (pltpu.force_tpu_interpret_mode() if dense_flash
          else contextlib.nullcontext()):
        j_logits, j_pq, j_loss, j_grads = jax_loss_and_grads(
            cfg, params, tokens, targets)
    t_logits, t_pq, t_loss, t_grads = port_loss_and_grads(cfg, params,
                                                          tokens, targets)
    np.testing.assert_allclose(t_logits, j_logits, rtol=0,
                               atol=1e-5 * np.abs(j_logits).max())
    assert (j_pq > 0) == ('mha' in name)
    np.testing.assert_allclose(t_pq, j_pq, rtol=1e-5)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    assert_grads_close(t_grads, j_grads)


def test_upgrades_keep_leaves_and_outputs():
    """The lora stage keeps the logits exactly (zero right factors); every
    stage keeps each existing leaf bit-exact (the same tensor); mha_v2 is a
    param-free flip."""
    cfg = tcfg.tiny_config('opt', vocab_size=64)
    params = surgery.init_params(cfg, 0, 'cpu')
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, 64, size=(2, 31)))
    base = DecoderLM(cfg, params)(tokens)['logits']
    cfg2, params2 = surgery.upgrade(cfg, params, 'lora', 1, d_lora=4)
    assert torch.equal(DecoderLM(cfg2, params2)(tokens)['logits'], base)
    cfg4, params4 = surgery.full_upgrade(cfg, params, 1, d_lora=4,
                                         ffn_block_size=32)
    old, new = flatten(params), flatten(params4)
    assert all(new[k] is v for k, v in old.items())
    assert cfg4.attention == 'sparse_v2' and cfg4.ffn == 'routed'
    cfg1, p1 = surgery.upgrade(cfg, params, 'mha_v1', 2)
    cfg2, p2 = surgery.upgrade(cfg1, p1, 'mha_v2', 3)
    assert p2 is p1 and surgery.flatten_paths_equal(cfg1, cfg2)
    train, frozen = partition.count_trainable(params4)
    assert 0 < train < frozen
    with pytest.raises(ValueError, match='mha_v1'):
        surgery.upgrade(cfg, params, 'mha_v2', 4)


def test_remat_and_dropout_keep_the_gradients():
    """cfg.remat (each block recomputed in the backward) gives the same
    logits and trainable gradients as without it, dropout included: the
    recompute draws the same masks from the seeded generator. Dense
    attention with p_dropout 0.1 on the mha_v1 stage (aux loss on)."""
    cfg, params = staged_model('opt', ('lora', 'ffn', 'mha_v1'))
    cfg = cfg.replace(p_dropout=0.1)
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, size=(2, 31)))
    runs = []
    for remat in (False, True):
        model = DecoderLM(cfg.replace(remat=remat),
                          bridge.params_from_numpy(params, 'cpu'),
                          deterministic=False, train_quantizer=True,
                          trainable=partition.is_trainable_path)
        gen = torch.Generator()
        gen.manual_seed(5)
        out = model(tokens, generator=gen)
        (out['logits'].square().mean() + out['pq_loss']).backward()
        runs.append((out['logits'].detach(), {
            k: p.grad for k, p in flatten(model.tree()).items()
            if p.requires_grad}))
    (la, ga), (lb, gb) = runs
    assert torch.equal(la, lb)
    for k in ga:
        torch.testing.assert_close(gb[k], ga[k], rtol=1e-6, atol=1e-7)
