"""PyTorch port vs the JAX package: int8-base (QLoRA-shape) training on the
CPU.

The frozen base kernels leave the param tree as int8 + per-column scales
(split_int8_base) and stream through int8_frozen_matmul in both passes:
int8_matmul forward, int8_matmul_t backward (the JAX kernels run in
interpret mode, the port's wrappers their plain twins on CPU tensors).
Held here: int8_matmul_t's twin against the TPU kernel, the autograd
Function against jax.grad of the custom_vjp, split_int8_base's trees, the
four routed int8 forms, 3 train steps of a tiny SPT model (OPT and LLaMA)
from the same carried-across weights, and the tune CLI with --int8_base.
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
from spt_proto_tpu.ops import routed_ffn as jrops
from spt_proto_tpu.ops.pallas import int8_matmul as jmm
from spt_proto_tpu.tuning import surgery as jsurgery
from spt_proto_tpu.tuning import trainer as jtrainer
from spt_proto_tpu.tuning.partition import trainable_mask as jmask
from spt_proto_tpu.utils import checkpoint as jckpt
from spt_proto_tpu_torch import config as tcfg
from spt_proto_tpu_torch.cli import tune
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference.weights import quantize_int8
from spt_proto_tpu_torch.ops import int8_matmul as tmm
from spt_proto_tpu_torch.ops import routed_ffn as trops
from spt_proto_tpu_torch.tuning import partition, surgery, trainer
from spt_proto_tpu_torch.utils.tree import flatten, unflatten

torch.set_num_threads(1)


def jax_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name in ('dtype', 'param_dtype'):
        kw[name] = jnp.dtype(str(kw[name]).removeprefix('torch.'))
    return jcfg.ModelConfig(**kw)


def to_torch(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    return t if dtype is None else t.to(dtype)


def int8_weight(r, k, n):
    """quantize_int8 of a random [k, n] f32 weight as numpy: q [k, N_pad]
    int8, scale [1, n] f32 (N padded to 256)."""
    w = torch.from_numpy((r.randn(k, n) * 0.05).astype(np.float32))
    q8 = quantize_int8(w)
    return q8['q'].numpy(), q8['scale'].numpy()


# (m, K, N): K and N off the 128 / 256 tiles; N spans one and three 256
# chunks; the scale is narrower than q (N_pad); m 130, K 200, N 264 cross
# the CUDA kernel's 128-row tiles and its 32 / 64-column steps
T_SHAPES = [(37, 300, 200), (70, 96, 600), (130, 200, 264)]


@pytest.mark.parametrize('shape', T_SHAPES, ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_int8_matmul_t_twin_matches_jax_kernel(shape, dtype):
    """int8_matmul_t_ref against the TPU kernel (interpret mode): f32 to
    1e-5 relative of the output's largest; bf16 within one bf16 step of
    it (both round only at the end, from f32 sums in other orders)."""
    m, k, n = shape
    r = np.random.RandomState(m)
    q, s = int8_weight(r, k, n)
    assert q.shape[1] > n
    g = (r.randn(m, n)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jmm.int8_matmul_t(jnp.asarray(g).astype(jdt),
                                        jnp.asarray(q), jnp.asarray(s),
                                        interpret=True)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = tmm.int8_matmul_t_ref(to_torch(g, tdt), torch.from_numpy(q),
                                torch.from_numpy(s))
    assert got.dtype == tdt and got.shape == (m, k)
    top = np.abs(want).max()
    tol = 1e-5 * top if dtype == 'float32' else 2 ** -7 * top
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_int8_frozen_matmul_grad_matches_jax():
    """Int8FrozenMatmul forward and dx against jax.grad of JAX's
    int8_frozen_matmul (f32, interpret mode), and no gradient reaches q or
    scale; x on the tiled path (m >= 64) and N off the 256 padding."""
    r = np.random.RandomState(3)
    q, s = int8_weight(r, 96, 200)
    x = r.randn(2, 40, 96).astype(np.float32)
    w = r.randn(2, 40, 200).astype(np.float32)

    def jloss(x_):
        y = jmm.int8_frozen_matmul(x_, jnp.asarray(q), jnp.asarray(s))
        return jnp.sum(jnp.tanh(y) * w), y
    (_, jy), jdx = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(x))
    xt = to_torch(x).requires_grad_(True)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    y = tmm.int8_frozen_matmul(xt, qt, st)
    (torch.tanh(y) * to_torch(w)).sum().backward()
    assert y.shape == (2, 40, 200)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    jdx = np.asarray(jdx)
    np.testing.assert_allclose(xt.grad.numpy(), jdx, rtol=0,
                               atol=1e-5 * np.abs(jdx).max())
    assert not qt.requires_grad and st.grad is None


def spt_tiny(arch, seed=0):
    """A tiny SPT model (tests/test_int8_base.py's: d_model 64, 4 heads,
    d_ff 128, vocab 128; the four stages, d_lora 4, blocks of 32) from the
    port's init, LoRA right factors from numpy: (port cfg, numpy params)."""
    cfg = tcfg.tiny_config(arch, d_model=64, n_heads=4, d_feedforward=128,
                           vocab_size=128)
    params = surgery.init_params(cfg, seed, 'cpu')
    cfg, params = surgery.full_upgrade(cfg, params, seed + 1, d_lora=4,
                                       ffn_block_size=32)
    flat = flatten(bridge.params_to_numpy(params))
    r = np.random.RandomState(seed + 7)
    for path in flat:
        if 'lora_right' in path:
            flat[path] = (r.randn(*flat[path].shape) * 0.1).astype(np.float32)
    return cfg, unflatten(flat)


def _q8_paths(tree):
    flat = {}

    def walk(d, prefix=''):
        for k, v in d.items():
            p = f'{prefix}/{k}' if prefix else k
            if isinstance(v, dict) and set(v) == {'q', 'scale'}:
                flat[p] = v
            elif isinstance(v, dict):
                walk(v, p)
    walk(tree)
    return flat


@pytest.mark.parametrize('arch,dtype', [('opt', 'float32'),
                                        ('llama', 'bfloat16')])
def test_split_int8_base_matches_jax(arch, dtype):
    """split_int8_base against JAX's on the same tree: cfg.int8_base, the
    kept params' paths and values, and frozen8's paths, int8 bytes and
    scales, exact (the scale as JAX's jitted split computes it); staged
    gives the same trees and releases the fp kernels."""
    cfg, params = spt_tiny(arch)
    cfg = cfg.replace(dtype=getattr(torch, dtype))
    jc8, jp, jf8 = jsurgery.split_int8_base(
        jax_config(cfg), jax.tree.map(jnp.asarray, params))
    tp = bridge.params_from_numpy(params, 'cpu')
    c8, p8, f8 = surgery.split_int8_base(cfg, tp)
    assert c8.int8_base and jc8.int8_base
    assert c8 == bridge.config_from(jc8)
    jp_flat, tp_flat = flatten(jax.device_get(jp)), flatten(p8)
    assert jp_flat.keys() == tp_flat.keys()
    for k, v in jp_flat.items():
        np.testing.assert_array_equal(tp_flat[k].numpy(), v, err_msg=k)
    jq, tq = _q8_paths(jax.device_get(jf8)), _q8_paths(f8)
    n_kernels = 7 if arch == 'llama' else 6
    assert jq.keys() == tq.keys() and len(tq) == n_kernels
    for k, v in jq.items():
        assert tq[k]['q'].dtype == torch.int8
        np.testing.assert_array_equal(tq[k]['q'].numpy(), v['q'], err_msg=k)
        np.testing.assert_array_equal(tq[k]['scale'].numpy(), v['scale'],
                                      err_msg=k)
    staged_src = bridge.params_from_numpy(params, 'cpu')
    kernel = flatten(staged_src)['blocks/mha/q/kernel']
    _, p_s, f_s = surgery.split_int8_base(cfg, staged_src, staged=True)
    assert kernel.untyped_storage().nbytes() == 0
    for k, v in flatten(f_s).items():
        assert torch.equal(v, flatten(f8)[k]), k
    assert flatten(p_s).keys() == tp_flat.keys()


def routed_inputs(gated, seed=5):
    """A routed FFN's inputs (numpy): x [24, 16], probs [24, 4] with a tie,
    dense-layout kernels (int8) and per-block views of the LoRA factors."""
    r = np.random.RandomState(seed)
    t, d, n, bs, rk = 24, 16, 4, 8, 4
    f = n * bs
    probs = 1 / (1 + np.exp(-r.randn(t, n)))
    probs[0, 1] = probs[0, 2]                      # a tie: lower id wins
    w = dict(x=r.randn(t, d), probs=probs, b1=r.randn(n, bs) * 0.1,
             b2=r.randn(d) * 0.1, ll1=r.randn(d, rk) * 0.5,
             lr1=r.randn(n, bs, rk) * 0.5, ll2=r.randn(n, bs, rk) * 0.5,
             lr2=r.randn(d, rk) * 0.5, lrs=r.randn(n, bs, rk) * 0.5,
             lls=r.randn(d, rk) * 0.5)
    w = {k: v.astype(np.float32) for k, v in w.items()}
    names = ('gate', 'side', 'down') if gated else ('fc1', 'fc2')
    shapes = {'gate': (d, f), 'side': (d, f), 'down': (f, d), 'fc1': (d, f),
              'fc2': (f, d)}
    q8 = {nm: int8_weight(r, *shapes[nm]) for nm in names}
    return w, q8


# form -> (gated, LoRA)
INT8_FORMS = {'masked': (False, False), 'lora': (False, True),
              'gated_masked': (True, False), 'gated_lora': (True, True)}


@pytest.mark.parametrize('form', list(INT8_FORMS))
def test_routed_int8_forms_match_jax(form):
    """routed_ffn_{masked,lora,gated_masked,gated_lora}_int8 against JAX's
    (f32): outputs to 1e-5 of their largest, gradients of x, probs and
    every float operand to 1e-4 of each one's largest."""
    gated, lora = INT8_FORMS[form]
    w, q8 = routed_inputs(gated)
    relu = jax.nn.relu if not gated else jax.nn.silu
    trelu = torch.relu if not gated else torch.nn.functional.silu
    jq = {k: {'q': jnp.asarray(q), 'scale': jnp.asarray(s)}
          for k, (q, s) in q8.items()}
    tq = {k: {'q': torch.from_numpy(q), 'scale': torch.from_numpy(s)}
          for k, (q, s) in q8.items()}
    if gated and lora:
        keys = ('x', 'probs', 'll1', 'lr1', 'lls', 'lrs', 'll2', 'lr2')
        jf = lambda a: jrops.routed_ffn_gated_lora_int8(
            a[0], a[1], 2, jq['gate'], jq['side'], jq['down'], *a[2:], relu)
        tf = lambda a: trops.routed_ffn_gated_lora_int8(
            a[0], a[1], 2, tq['gate'], tq['side'], tq['down'], *a[2:], trelu)
    elif gated:
        keys = ('x', 'probs')
        jf = lambda a: jrops.routed_ffn_gated_masked_int8(
            a[0], a[1], 1, jq['gate'], jq['side'], jq['down'], relu, 4)
        tf = lambda a: trops.routed_ffn_gated_masked_int8(
            a[0], a[1], 1, tq['gate'], tq['side'], tq['down'], trelu, 4)
    elif lora:
        keys = ('x', 'probs', 'b1', 'b2', 'll1', 'lr1', 'll2', 'lr2')
        jf = lambda a: jrops.routed_ffn_lora_int8(
            a[0], a[1], 2, jq['fc1'], a[2], jq['fc2'], *a[3:], relu)
        tf = lambda a: trops.routed_ffn_lora_int8(
            a[0], a[1], 2, tq['fc1'], a[2], tq['fc2'], *a[3:], trelu)
    else:
        keys = ('x', 'probs', 'b1', 'b2')
        jf = lambda a: jrops.routed_ffn_masked_int8(
            a[0], a[1], 2, jq['fc1'], a[2], jq['fc2'], a[3], relu)
        tf = lambda a: trops.routed_ffn_masked_int8(
            a[0], a[1], 2, tq['fc1'], a[2], tq['fc2'], a[3], trelu)
    args = [w[k] for k in keys]
    cot = np.random.RandomState(9).randn(24, 16).astype(np.float32)
    jy, vjp = jax.vjp(jax.jit(lambda *a: jf(a)), *map(jnp.asarray, args))
    jgrads = vjp(jnp.asarray(cot))
    targs = [to_torch(a).requires_grad_(True) for a in args]
    ty = tf(targs)
    (ty * to_torch(cot)).sum().backward()
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())
    for k, a, g in zip(keys, targs, jgrads):
        g = np.asarray(g)
        # the hard gates give probs no gradient without LoRA: None here
        got = a.grad.numpy() if a.grad is not None else np.zeros_like(g)
        np.testing.assert_allclose(got, g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


def random_batches(vocab, n, batch=2, seq=17, seed=3):
    r = np.random.RandomState(seed)
    for _ in range(n):
        x = r.randint(0, vocab, size=(batch, seq)).astype(np.int32)
        yield {'inputs': x[:, :-1], 'targets': x[:, 1:]}


# Step-0 gradients, port vs JAX, relative to each trainable leaf's largest
# entry: 1e-3 holds for OPT. Not for LLaMA: the int8 forward rounds every
# projection input to bf16 (int8_matmul's numerics, also in f32), and
# LLaMA's attention output (RoPE tables an ulp from XLA's, other sum
# orders) puts an o-projection input on a bf16 rounding boundary, so one
# operand lands a whole bf16 step (2^-8) apart: its logits differ by 1.4e-3
# of their largest (the same weights dequantized into fp kernels: 1.6e-6),
# one router-bias gradient entry by 1.8e-3 of its leaf's and the step-0
# loss by 1.3e-5 relative; after Adam's lr sign(g) steps on the gradients
# that differ, the step-2 loss by 1.5e-4. The bf16-step bounds hold there:
# 2^-7 of each leaf's largest, 1e-4 of the step-0 loss and 1e-3 of the
# later ones (the standing w8 drift, ROADMAP Queue 3).
GRAD_BOUND = {'opt': 1e-3, 'llama': 2 ** -7}
STEP0_LOSS_BOUND = {'opt': 1e-5, 'llama': 1e-4}
LOSS_BOUND = {'opt': 1e-4, 'llama': 1e-3}


@pytest.mark.parametrize('arch', ['opt', 'llama'])
def test_int8_base_train_steps_match_jax(arch):
    """3 int8_base train steps, port vs JAX's jitted step (frozen8 passed
    at call time), from JAX's split of the same tree carried across by
    int8_base_from_numpy (and back, unchanged). Step 0's loss, ce and
    pq_loss to STEP0_LOSS_BOUND relative; step 0's gradient of every
    trainable leaf to GRAD_BOUND of its largest entry; the later steps'
    losses to LOSS_BOUND."""
    cfg, params = spt_tiny(arch)
    jc8, jp, jf8 = jsurgery.split_int8_base(
        jax_config(cfg), jax.tree.map(jnp.asarray, params))
    p_np, f_np = jax.device_get(jp), jax.device_get(jf8)
    c8, tp, tf8 = bridge.int8_base_from_numpy(jc8, p_np, f_np, 'cpu')
    back_p, back_f = bridge.int8_base_to_numpy(tp, tf8)
    for a, b in ((back_p, p_np), (back_f, f_np)):
        fa, fb = flatten(a), flatten(b)
        assert fa.keys() == fb.keys()
        assert all(np.array_equal(fa[k], fb[k]) and fa[k].dtype == fb[k].dtype
                   for k in fa)
    batches = list(random_batches(c8.vocab_size, 3))

    # step-0 gradients of the trainable leaves
    flat = flatten(jp)
    train = {k: v for k, v in flat.items() if partition.is_trainable_path(k)}
    frozen = {k: v for k, v in flat.items() if k not in train}

    def jloss(t):
        out = JDecoderLM(cfg=jc8, train_quantizer=True).apply(
            {'params': unflatten({**t, **frozen}), 'frozen8': jf8},
            jnp.asarray(batches[0]['inputs']))
        return jtrainer.lm_loss(out['logits'],
                                jnp.asarray(batches[0]['targets'])) + \
            jtrainer.AUX_LOSS_COEFF * out['pq_loss']
    jg = jax.jit(jax.grad(jloss))(train)
    state = trainer.create_train_state(c8, tp, frozen8=tf8)
    model = state.model
    assert not any(b.requires_grad for b in model.buffers())
    assert all(not p.dtype == torch.int8 for p in model.parameters())
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
                                   atol=GRAD_BOUND[arch] * np.abs(w).max(),
                                   err_msg=k)

    tx = jtrainer.make_optimizer(jp)
    jstep = jax.jit(jtrainer.make_train_step(jc8, tx, trainable=jmask(jp)))
    jstate = jtrainer.TrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    step = trainer.make_train_step(c8)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, batch, jf8)
        state, tm = step(state, batch)
        names = ('loss', 'ce', 'pq_loss') if i == 0 else ('loss',)
        for name in names:
            np.testing.assert_allclose(tm[name].item(), float(jm[name]),
                                       rtol=STEP0_LOSS_BOUND[arch]
                                       if i == 0 else LOSS_BOUND[arch],
                                       err_msg=f'{i} {name}')
    assert state.step == 3
    assert not any(isinstance(v, dict) for v in flatten(state.params).values())


def test_tune_cli_int8_base(tmp_path, capsys):
    """cli.tune.main --int8_base on the CPU at tiny-opt: 2 steps, finite
    losses, and a saved checkpoint (and delta) with JAX's paths: the
    params without the moved kernels and cfg.int8_base set, as JAX's
    split of the same upgraded tree gives them."""
    out = str(tmp_path / 'tuned')
    tune.main(['--device', 'cpu', '--config', 'tiny-opt', '--steps', '2',
               '--seq_length', '33', '--batch_size', '2', '--out', out,
               '--int8_base'])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert np.isfinite(lines[0]['loss']) and lines[-1]['saved'] == out
    jc, jp = jckpt.load_checkpoint(out)
    assert jc.int8_base and jc.ffn == 'routed' and jc.d_lora == 16
    cfg = tcfg.tiny_config('opt')
    params = surgery.init_params(cfg, 0, 'cpu')
    for i, stage in enumerate(surgery.STAGES):
        kw = {'d_lora': 16} if stage == 'lora' else {}
        cfg, params = surgery.upgrade(cfg, params, stage, i + 1, **kw)
    _, want, _ = jsurgery.split_int8_base(
        jax_config(cfg), jax.tree.map(jnp.asarray,
                                      bridge.params_to_numpy(params)))
    assert flatten(jp).keys() == flatten(want).keys()
    assert not any(k.endswith(jsurgery.INT8_BASE_KERNELS) for k in
                   flatten(jp))
    with np.load(f'{out}-delta/delta.npz') as delta:
        assert delta.files and all(k in flatten(jp) for k in delta.files)
