"""PyTorch port vs the JAX package: dense flash attention, on the CPU.

The port's flash-attention twins (ops/flash_attention.py) against the stock
TPU kernel (jax.experimental.pallas.ops.tpu.flash_attention, run in TPU
interpret mode) at [1, 2, 256, d], d 64 and 128, causal, f32 and bf16:
o, l and m, and dq / dk / dv against jax.grad of the stock kernel. Then
what the slice runs around it: the autograd Function and the backward
wrappers (contiguous and strided inputs) on CPU tensors against the
twins, remat_policy='dots' against JAX's, tuning.evaluate against JAX's
(its forward through the stock kernel in interpret mode), the profile CLI
in its forward, train-step and decode modes, and the tune CLI at the
dense stages.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as stock

from spt_proto_tpu.models.decoder import DecoderLM as JDecoderLM
from spt_proto_tpu.tuning import evaluate as jevaluate
from spt_proto_tpu_torch.cli import profile, tune
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.models.decoder import DecoderLM
from spt_proto_tpu_torch.ops import flash_attention as fa
from spt_proto_tpu_torch.tuning import evaluate, partition
from spt_proto_tpu_torch.utils.tree import flatten, unflatten

from test_torch_model import assert_grads_close, jax_config, staged_model

torch.set_num_threads(1)

SHAPE = (1, 2, 256)
BF16_TOL = 2 ** -7          # one bf16 step of the largest entry


def inputs(d, seed=0):
    """q, k, v and the output gradient do [1, 2, 256, d] f32 (numpy)."""
    r = np.random.RandomState(seed)
    return [(r.randn(*SHAPE, d) * s).astype(np.float32)
            for s in (2.0, 2.0, 1.0, 1.0)]


def close_to_max(got, want, rel):
    """|got - want| <= rel * max|want| everywhere."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('d', [64, 128])
def test_twins_match_stock_kernel(d, dtype):
    """o / l / m of the forward twin and dq / dk / dv of the autograd
    Function (the backward twin on CPU tensors) against the stock kernel:
    f32 o to 1e-6 of max|o|, l and m to 1e-6 relative, grads to 1e-5 of
    each max; bf16 everything to 2^-7 of its max."""
    q, k, v, do = inputs(d)
    scale = d ** -0.5
    jd = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        o, l, m = stock._flash_attention(
            jq, jk, jv, None, None, True, True, scale,
            stock.BlockSizes.get_default(*SHAPE, *SHAPE[2:], d), False)

        def f(q_, k_, v_):
            o_ = stock.flash_attention(q_, k_, v_, causal=True,
                                       sm_scale=scale)
            return jnp.sum(o_.astype(jnp.float32) * jdo.astype(jnp.float32))
        grads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jq, jk, jv)
    as_np = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    td = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    to, tl, tm = fa.flash_attention_fwd_ref(tq, tk, tv, causal=True,
                                            sm_scale=scale)
    f32 = dtype == 'float32'
    close_to_max(to.float(), as_np(o), 1e-6 if f32 else BF16_TOL)
    for got, want in ((tl, l), (tm, m)):
        if f32:
            np.testing.assert_allclose(got.numpy(), as_np(want), rtol=1e-6)
        else:
            close_to_max(got, as_np(want), BF16_TOL)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa.flash_attention(*leaves, causal=True, sm_scale=scale)
    (out.float() * tdo.float()).sum().backward()
    for leaf, want in zip(leaves, grads):
        close_to_max(leaf.grad.float(), as_np(want),
                     1e-5 if f32 else BF16_TOL)


def test_autograd_function_and_wrappers_equal_the_twins():
    """On CPU tensors the autograd Function's output and gradients are the
    twins' (bit for bit), flash_attention_fwd, the dq / dk/dv wrappers and
    flash_attention_bwd compute the twins', also from the layer's strided
    views, and no kernel launch is counted; the bf16 kernels' operands are
    such views in place and o is written in the layer's [B, S, H, d]
    layout, anything else (f32) a contiguous copy and a contiguous o."""
    q, k, v, do = (torch.from_numpy(a) for a in inputs(64, seed=1))
    kw = dict(causal=True, sm_scale=0.125)
    launches = [w.launches for w in (fa.flash_attention_fwd,
                                     fa.flash_attention_dq,
                                     fa.flash_attention_dkv)]
    o, l, m = fa.flash_attention_fwd_ref(q, k, v, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, o, l, m, do, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, **kw)
    out.backward(do)
    assert torch.equal(out.detach(), o)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    di = (o * do).sum(-1)
    assert torch.equal(fa.flash_attention_dq(q, k, v, l, m, do, di, **kw),
                       want[0])
    dk, dv = fa.flash_attention_dkv(q, k, v, l, m, do, di, **kw)
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])
    # the layer's operands: its [B, S, H, d] projections transposed
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v, do)]
    qs, ks, vs, dos = views
    assert not qs.is_contiguous()
    for got, w in zip(fa.flash_attention_fwd(qs, ks, vs, **kw), (o, l, m)):
        assert torch.equal(got, w)
    assert torch.equal(fa.flash_attention_dq(qs, ks, vs, l, m, dos, di, **kw),
                       want[0])
    dk, dv = fa.flash_attention_dkv(qs, ks, vs, l, m, dos, di, **kw)
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])
    for got, w in zip(fa.flash_attention_bwd(qs, ks, vs, o, l, m, dos, **kw),
                      want):
        assert torch.equal(got, w)
    # what the kernels read: a bf16 view in place, with its (batch, head,
    # row) strides; f32, a misaligned start or a broadcast d as a
    # contiguous copy
    bq = torch.zeros(1, 256, 2, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert fa._operand(bq) is bq
    assert fa._strides(bq, q) == [256 * 2 * 64, 64, 128,
                                  2 * 256 * 64, 256 * 64, 64]
    # the forward: bf16 views in place and o the [B, H, S, d] view of a
    # [B, S, H, d] tensor; f32 contiguous copies and a contiguous o
    *ins, bo = fa._fwd_operands(bq, bq, bq)
    assert all(t is bq for t in ins)
    assert bo.shape == bq.shape and bo.stride() == bq.stride()
    *ins, fo = fa._fwd_operands(qs, ks, vs)
    assert all(t.is_contiguous() and torch.equal(t, w)
               for t, w in zip(ins, (q, k, v)))
    assert fo.shape == q.shape and fo.is_contiguous()
    odd = torch.zeros(256 * 2 * 64 + 1, dtype=torch.bfloat16)[1:]
    for t in (qs, odd.view(1, 256, 2, 64).transpose(1, 2),
              bq[..., :1].expand(bq.shape)):
        assert fa._operand(t).is_contiguous() and torch.equal(
            fa._operand(t), t)
    with torch.no_grad():
        assert torch.equal(fa.flash_attention(q, k, v, **kw), o)
    assert [w.launches for w in (fa.flash_attention_fwd,
                                 fa.flash_attention_dq,
                                 fa.flash_attention_dkv)] == launches
    # the plain causal softmax attention of the layer's other path
    p = torch.softmax(torch.where(
        torch.ones(256, 256, dtype=torch.bool).tril(),
        q @ k.transpose(-1, -2) * 0.125, -torch.inf), -1)
    torch.testing.assert_close(o, p @ v, rtol=1e-5, atol=1e-6)


def test_remat_dots_matches_jax():
    """remat=True, remat_policy='dots' (matmul outputs saved, the rest
    recomputed): the trainable gradients equal JAX's under the same policy
    (1e-4 of each leaf's max), and the port's own no-remat ones (1e-6
    relative); the mha_v1 stage (aux loss on), tiny OPT, S 31."""
    cfg, params = staged_model('opt', ('lora', 'ffn', 'mha_v1'))
    cfg = cfg.replace(remat=True, remat_policy='dots')
    r = np.random.RandomState(4)
    seq = r.randint(0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    jc = jax_config(cfg)
    model = JDecoderLM(cfg=jc, train_quantizer=True)
    flat = flatten(params)
    train = {k: jnp.asarray(v) for k, v in flat.items()
             if partition.is_trainable_path(k)}
    frozen = {k: jnp.asarray(v) for k, v in flat.items() if k not in train}

    def loss(t):
        out = model.apply({'params': unflatten({**t, **frozen})},
                          jnp.asarray(tokens))
        lp = jax.nn.log_softmax(out['logits'].astype(jnp.float32))
        ce = -jnp.take_along_axis(lp, jnp.asarray(targets)[..., None],
                                  -1).mean()
        return ce + 1e-2 * out['pq_loss']
    j_grads = {k: np.asarray(v) for k, v in
               jax.jit(jax.grad(loss))(train).items()}
    runs = []
    for remat in (True, False):
        m = DecoderLM(cfg.replace(remat=remat),
                      bridge.params_from_numpy(params, 'cpu'),
                      train_quantizer=True,
                      trainable=partition.is_trainable_path)
        out = m(torch.from_numpy(tokens))
        ce = torch.nn.functional.cross_entropy(
            out['logits'].float().reshape(-1, cfg.vocab_size),
            torch.from_numpy(targets).long().reshape(-1))
        (ce + 1e-2 * out['pq_loss']).backward()
        runs.append({k: p.grad.numpy() for k, p in
                     flatten(m.tree()).items() if p.requires_grad})
    assert_grads_close(runs[0], j_grads)
    for k, g in runs[1].items():
        np.testing.assert_allclose(runs[0][k], g, rtol=1e-6,
                                   atol=1e-6 * np.abs(g).max())


def mmlu_batches(vocab, n, b, s, seed):
    """Synthetic batches shaped as data/datamodule.py gives them: rows of
    random tokens, padded past a random length (mask 0 there)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        row = r.randint(0, vocab, size=(b, s + 1)).astype(np.int32)
        lengths = r.randint(3, s + 1, size=b).astype(np.int32)
        mask = (np.arange(s)[None] < lengths[:, None] - 1).astype(np.int32)
        out.append({'inputs': row[:, :-1], 'targets': row[:, 1:],
                    'mask': mask, 'lengths': lengths})
    return out


def test_evaluate_matches_jax():
    """tuning.evaluate (ppl over the masked CE, MMLU answer-position
    accuracy, max_batches) against JAX's on the same weights and batches,
    JAX under attn_impl='pallas' (the stock flash kernel in interpret
    mode), the port's twins: ppl to 1e-5 relative, accuracy and n_examples
    equal. Stages lora,ffn,mha_v1 at S 128, 3 batches, max_batches 2."""
    cfg, params = staged_model('opt', ('lora', 'ffn', 'mha_v1'))
    cfg = cfg.replace(attn_impl='pallas')
    batches = mmlu_batches(cfg.vocab_size, 3, 2, 128, seed=6)
    jparams = jax.tree.map(jnp.asarray, params)
    with pltpu.force_tpu_interpret_mode():
        want = jevaluate.evaluate(jax_config(cfg), jparams, batches,
                                  max_batches=2)
    got = evaluate.evaluate(cfg, bridge.params_from_numpy(params, 'cpu'),
                            batches, max_batches=2)
    assert got['n_examples'] == want['n_examples'] == 4
    assert got['accuracy'] == want['accuracy']
    np.testing.assert_allclose(got['ppl'], want['ppl'], rtol=1e-5)


PROFILE_KEYS = {'config', 'tuning', 'mode', 'batch', 'seq', 'compile_s',
                'step_ms', 'tokens_per_s', 'memory'}


@pytest.mark.parametrize('tuning,flags,mode', [
    ('dense', [], 'forward'), ('dense', ['--backward'], 'train_step'),
    ('lora', [], 'forward'), ('lora', ['--backward'], 'train_step'),
    ('sparse', ['--decode', '--quantized_kv', '--spec_k', '2'], 'decode')])
def test_profile_cli_on_the_cpu(tuning, flags, mode, capsys, tmp_path):
    """cli.profile.main on the CPU twins at tiny-opt, S 128: the JSON line
    with the JAX CLI's keys, its mode and a positive step time (decode:
    the speculative block's keys too); the dense train step also with
    --trace_dir: the trace written, no device operations in it."""
    argv = ['--device', 'cpu', '--config', 'tiny-opt', '--seq_length',
            '128', '--batch_size', '2', '--iters', '2', '--tuning', tuning]
    traced = tuning == 'dense' and mode == 'train_step'
    if traced:
        flags = flags + ['--trace_dir', str(tmp_path)]
    out = profile.main(argv + flags)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and PROFILE_KEYS <= set(line)
    assert line['mode'] == mode and line['tuning'] == tuning
    assert line['seq'] == 128 and line['step_ms'] > 0
    assert line['memory'] == {}
    assert ('spec_block_ms' in line) == (mode == 'decode')
    assert line.get('trace_top') == ([] if traced else None)
    assert (tmp_path / 'trace.json').exists() == traced


def test_tune_cli_dense_stages(tmp_path, capsys):
    """cli.tune.main on the CPU, 2 steps at --stages lora,ffn,mha_v1 (the
    stages whose attention is dense): finite losses, the PQ warm-up's aux
    loss on, a saved sparse_v1 checkpoint."""
    out = str(tmp_path / 'tuned')
    tune.main(['--device', 'cpu', '--config', 'tiny-opt', '--steps', '2',
               '--seq_length', '129', '--batch_size', '2', '--stages',
               'lora,ffn,mha_v1', '--out', out])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert np.isfinite(lines[0]['loss']) and lines[0]['pq_loss'] > 0
    assert lines[-1]['saved'] == out and lines[-1]['delta_params'] > 0
    from spt_proto_tpu_torch.utils import checkpoint as ckpt_io
    cfg, _ = ckpt_io.load_checkpoint(out, 'cpu')
    assert cfg.attention == 'sparse_v1' and cfg.ffn == 'routed'
