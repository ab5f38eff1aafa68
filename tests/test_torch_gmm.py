"""PyTorch port vs the JAX package: the grouped-matmul routed FFN
(ffn_impl='gmm') and the capacity dispatch ('gather') on the CPU.

The port's gmm / tgmm twins against the stock megablox kernels (interpret
mode), the routed FFN's gmm and gather forms against JAX's (forward and
gradients), a tiny DecoderLM with ffn_impl='gmm', and an engine prefill of
>= 128 rows through a routed checkpoint, all from numpy inputs.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu.inference import engine as jeng
from spt_proto_tpu.inference.weights import InferenceWeights as JIW
from spt_proto_tpu.models.decoder import DecoderLM as JDecoderLM
from spt_proto_tpu.ops import routed_ffn as jrops
from spt_proto_tpu_torch import config as tcfg
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference import engine as teng
from spt_proto_tpu_torch.inference.weights import InferenceWeights as TIW
from spt_proto_tpu_torch.models.decoder import DecoderLM
from spt_proto_tpu_torch.ops import gmm as tgmm
from spt_proto_tpu_torch.ops import routed_ffn as trops
from spt_proto_tpu_torch.tuning import surgery
from spt_proto_tpu_torch.utils.tree import flatten, unflatten
from test_torch_engine import port_config
from test_torch_model import jax_config

torch.set_num_threads(1)

# the megablox backend module (megablox's package exports the VJP-wrapped
# gmm under the same name)
mb = importlib.import_module('jax.experimental.pallas.ops.tpu.megablox.gmm')

# m = 256 rows in 4 groups: group 0 ends mid-tile, group 1 is empty,
# group 2 starts mid-tile and spans a tile boundary
SIZES = np.array([100, 0, 130, 26], np.int32)
# (k, n): the FFN widths of tests/test_ffn_gmm.py, and the LoRA products'
# k = 16 and n = 16
KN = [(48, 40), (16, 40), (40, 16)]


@pytest.mark.parametrize('k,n', KN, ids=lambda v: str(v))
@pytest.mark.parametrize('transpose_rhs', [False, True])
def test_gmm_twin_matches_megablox(k, n, transpose_rhs):
    r = np.random.RandomState(k + n)
    lhs = r.randn(256, k).astype(np.float32)
    rhs = r.randn(4, *((n, k) if transpose_rhs else (k, n))).astype(
        np.float32)
    want = np.asarray(mb.gmm(jnp.asarray(lhs), jnp.asarray(rhs),
                             jnp.asarray(SIZES), jnp.float32,
                             transpose_rhs=transpose_rhs, interpret=True))
    got = tgmm.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs),
                   torch.from_numpy(SIZES), transpose_rhs=transpose_rhs)
    assert got.shape == (256, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('k,n', KN, ids=lambda v: str(v))
def test_tgmm_twin_matches_megablox(k, n):
    """tgmm [G, k, n] against megablox's (which takes lhs transposed): the
    empty group gives zeros."""
    r = np.random.RandomState(2 * k + n)
    lhs = r.randn(256, k).astype(np.float32)
    rhs = r.randn(256, n).astype(np.float32)
    want = np.asarray(mb.tgmm(jnp.asarray(lhs.T), jnp.asarray(rhs),
                              jnp.asarray(SIZES), jnp.float32,
                              interpret=True))
    got = tgmm.tgmm(torch.from_numpy(lhs), torch.from_numpy(rhs),
                    torch.from_numpy(SIZES))
    assert got.shape == (4, k, n) and not got[1].any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_grouped_matmul_vjp_matches_megablox():
    """GroupedMatmul's gradients (megablox's VJP: dlhs through gmm with the
    other rhs layout, drhs through tgmm, transposed for a transposed rhs)
    against jax.grad of megablox's ops.gmm, both layouts."""
    ops = importlib.import_module('jax.experimental.pallas.ops.tpu.megablox'
                                  '.ops')
    r = np.random.RandomState(11)
    lhs = r.randn(256, 16).astype(np.float32)
    cot = r.randn(256, 40).astype(np.float32)
    for t in (False, True):
        rhs = r.randn(4, *((40, 16) if t else (16, 40))).astype(np.float32)

        def f(a, b):
            return jnp.sum(ops.gmm(a, b, jnp.asarray(SIZES), jnp.float32,
                                   (128, 128, 128), None, None, t, True)
                           * cot)
        jl, jr = jax.grad(f, argnums=(0, 1))(jnp.asarray(lhs),
                                             jnp.asarray(rhs))
        a = torch.from_numpy(lhs).requires_grad_(True)
        b = torch.from_numpy(rhs).requires_grad_(True)
        out = tgmm.grouped_matmul(a, b, torch.from_numpy(SIZES),
                                  transpose_rhs=t)
        (out * torch.from_numpy(cot)).sum().backward()
        for got, want in ((a.grad, jl), (b.grad, jr)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def weights(seed, d_model=16, d_ff=32, n=4, r=4):
    """tests/test_ffn_gmm.py's shapes from numpy: 24 tokens, 4 blocks of 8,
    LoRA rank 4; probs with a tie (the lower block wins in both)."""
    g = np.random.RandomState(seed)
    bs = d_ff // n
    w = dict(x=g.randn(24, d_model), probs=1 / (1 + np.exp(-g.randn(24, n))),
             w1=g.randn(n, d_model, bs) * 0.3, b1=g.randn(n, bs) * 0.1,
             w2=g.randn(n, bs, d_model) * 0.3, b2=g.randn(d_model) * 0.1,
             ll1=g.randn(d_model, r) * 0.5, lr1=g.randn(n, bs, r) * 0.5,
             ll2=g.randn(n, bs, r) * 0.5, lr2=g.randn(d_model, r) * 0.5)
    w['probs'][3, 0] = w['probs'][3, 2]
    return {k: v.astype(np.float32) for k, v in w.items()}


# form -> (JAX fn, port fn, operand names after (x, probs, top_k))
FORMS = {
    'gmm': (jrops.routed_ffn_gmm, trops.routed_ffn_gmm,
            ('w1', 'b1', 'w2', 'b2')),
    'lora_gmm': (jrops.routed_ffn_lora_gmm, trops.routed_ffn_lora_gmm,
                 ('w1', 'b1', 'w2', 'b2', 'll1', 'lr1', 'll2', 'lr2')),
    'gather': (jrops.routed_ffn_gather, trops.routed_ffn_gather,
               ('w1', 'b1', 'w2', 'b2')),
}


@pytest.mark.parametrize('form', list(FORMS))
def test_routed_ffn_forms_match_jax(form):
    """routed_ffn_gmm / routed_ffn_lora_gmm / routed_ffn_gather against
    JAX's (megablox in interpret mode; JAX pads the gmm rows to 128, the
    port does not): forward to 1e-5, gradients of x, probs and every
    operand to 1e-4."""
    jf, tf, names = FORMS[form]
    w = weights(3)
    kw = {'interpret': True} if 'gmm' in form else {}
    args = [w['x'], w['probs']] + [w[n] for n in names]
    cot = np.random.RandomState(4).randn(24, 16).astype(np.float32)

    def jfun(*a):
        return jf(a[0], a[1], 2, *a[2:], jax.nn.relu, **kw)
    jy, vjp = jax.vjp(jfun, *map(jnp.asarray, args))
    jgrads = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ty = tf(targs[0], targs[1], 2, *targs[2:], torch.relu)
    (ty * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=1e-5)
    for name, a, g in zip(('x', 'probs') + names, targs, jgrads):
        # the hard dispatch gives probs no gradient without LoRA: None here
        got = a.grad.numpy() if a.grad is not None else np.zeros(a.shape)
        np.testing.assert_allclose(got, np.asarray(g), rtol=0, atol=1e-4,
                                   err_msg=name)


def _routed_lora_tiny(**kw):
    """tiny_config OPT with a routed FFN (blocks of 32) and LoRA (rank 4),
    the port's seeded init with numpy LoRA right factors."""
    cfg = tcfg.tiny_config('opt', ffn='routed', ffn_block_size=32, d_lora=4,
                           **kw)
    flat = flatten(bridge.params_to_numpy(surgery.init_params(cfg, 0,
                                                              'cpu')))
    r = np.random.RandomState(1)
    for path in flat:
        if 'lora_right' in path:
            flat[path] = (r.randn(*flat[path].shape) * 0.1).astype(np.float32)
    return cfg, unflatten(flat)


def test_model_with_gmm_ffn_matches_jax():
    """A tiny DecoderLM with ffn_impl='gmm' (B=4 x S=64 = 256 rows, so the
    FFN takes the grouped matmuls) against JAX's, logits to 5e-5, and
    against the port's masked form."""
    cfg, params = _routed_lora_tiny()
    cfg = cfg.replace(ffn_impl='gmm')
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 64))
    want = JDecoderLM(cfg=jax_config(cfg)).apply(
        {'params': jax.tree.map(jnp.asarray, params)},
        jnp.asarray(tokens))['logits']
    tp = bridge.params_from_numpy(params, 'cpu')
    tgmm.gmm.launches = 0
    got = DecoderLM(cfg, tp)(torch.from_numpy(tokens))['logits']
    masked = DecoderLM(cfg.replace(ffn_impl='masked'), tp)(
        torch.from_numpy(tokens))['logits']
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(got.detach().numpy(),
                               masked.detach().numpy(), rtol=0, atol=5e-5)
    assert tgmm.gmm.launches == 0           # CPU tensors: the twins


def test_engine_prefill_with_gmm_matches_jax():
    """A routed + LoRA checkpoint served with ffn_impl='gmm': a prefill of
    2 x 96 = 192 rows (>= 128: the grouped matmuls) and 4 greedy decode
    steps of 2 rows (the masked form), port vs JAX's engine: prefill logits
    to 1e-4 and the greedy tokens exactly."""
    cfg, params = _routed_lora_tiny(d_model=128, n_heads=2,
                                    d_feedforward=256, max_length=256,
                                    vocab_size=256)
    cfg = cfg.replace(ffn_impl='gmm', attention='dense')
    jc = jax_config(cfg)
    tokens = np.random.RandomState(2).randint(1, 256, (2, 96)).astype(
        np.int32)
    jiw = JIW.from_params(jc, jax.tree.map(jnp.asarray, params))
    cache = jeng.KVCache.create(jc, 2, 256, dtype=jnp.float32)
    jl, cache = jax.jit(jeng.prefill)(jiw, jnp.asarray(tokens), cache)
    tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    jtoks = []
    step = jax.jit(jeng.decode_step_greedy)
    for _ in range(4):
        tok, cache = step(jiw, tok, cache)
        jtoks.append(np.asarray(tok))
    tc = port_config(jc)
    tiw = TIW.from_params(tc, bridge.params_from_numpy(params, 'cpu'))
    tcache = teng.KVCache.create(tc, 2, 256, dtype=torch.float32,
                                 device='cpu')
    calls = []
    orig = trops.routed_ffn_lora_gmm
    trops.routed_ffn_lora_gmm = lambda *a: calls.append(a[0].shape[0]) or \
        orig(*a)
    try:
        tl, tcache = teng.prefill(tiw, torch.from_numpy(tokens), tcache)
        ttok = torch.argmax(tl[:, -1], -1).to(torch.int32)
        ttoks = []
        for _ in range(4):
            ttok, tcache = teng.decode_step_greedy(tiw, ttok, tcache)
            ttoks.append(ttok.numpy())
    finally:
        trops.routed_ffn_lora_gmm = orig
    assert calls == [192] * cfg.n_layers     # prefill only
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


# The wrapper's choice of kernel, tile shape and tgmm row split at OPT-125M's
# tune shape (8,192 sorted rows, d_model 768, 4 blocks of 768, LoRA rank
# 16): pure Python on CPU tensors of the layer's shapes and strides (the
# kernels themselves run only on the card, in chip_smoke.py phase 2).
def _tune_operands(dtype=torch.bfloat16):
    m, d, n_blk, r = 8192, 768, 4, 16
    fc1 = torch.empty((d, n_blk * d), dtype=dtype)
    return dict(x=torch.empty((m, d), dtype=dtype),
                xl=torch.empty((m, r), dtype=dtype),
                w1=fc1.reshape(d, n_blk, d).permute(1, 0, 2),
                w2=torch.empty((n_blk, d, d), dtype=dtype),
                lr1=torch.empty((n_blk, d, r), dtype=dtype),
                ll2=torch.empty((n_blk * d, r), dtype=dtype).reshape(
                    n_blk, d, r))


ROUTES = [('x', 'w1', False, 'wide'), ('x', 'w2', False, 'wide'),
          ('xl', 'lr1', True, 'thin k-major'), ('x', 'll2', False, 'narrow16'),
          ('x', 'w1', True, 'wide k-major'), ('x', 'w2', True, 'wide k-major'),
          ('x', 'lr1', False, 'narrow16'), ('xl', 'll2', True, 'thin k-major')]


@pytest.mark.parametrize('lhs,rhs,transpose_rhs,route', ROUTES,
                         ids=lambda v: str(v))
def test_gmm_route_at_tune_shape(lhs, rhs, transpose_rhs, route):
    """The eight products a layer of routed_ffn_lora_gmm runs (forward and
    dlhs) go to the tensor-core kernel in bf16, to the CUDA-core one in
    f32."""
    o = _tune_operands()
    assert tgmm.gmm_route(o[lhs], o[rhs],
                          transpose_rhs=transpose_rhs) == route
    o32 = _tune_operands(torch.float32)
    assert tgmm.gmm_route(o32[lhs], o32[rhs],
                          transpose_rhs=transpose_rhs) == 'cuda-core'


def test_gmm_route_off_the_rule():
    """Shapes the tensor-core kernel does not take: k or n not a multiple
    of 8, an rhs not 16-byte aligned, an f32 output from bf16 inputs."""
    bf = torch.bfloat16
    x = torch.empty((64, 768), dtype=bf)
    assert tgmm.gmm_route(torch.empty((64, 100), dtype=bf),
                          torch.empty((4, 100, 200), dtype=bf)) == 'cuda-core'
    assert tgmm.gmm_route(x, torch.empty((4, 768, 20), dtype=bf)) == \
        'cuda-core'
    shifted = torch.empty(4 * 768 * 16 + 1, dtype=bf)[1:].view(4, 768, 16)
    assert tgmm.gmm_route(x, shifted) == 'cuda-core'
    assert tgmm.gmm_route(x, torch.empty((4, 768, 16), dtype=bf),
                          out_dtype=torch.float32) == 'cuda-core'
    assert tgmm.gmm_route(x, torch.empty((4, 768, 32), dtype=bf)) == \
        'narrow32'


@pytest.mark.parametrize('m,k,n,plan', [
    # both LoRA gradients: R 256, 36 row tiles x 12 k tiles = 432 CTAs,
    # a 1.8 MB workspace
    (8192, 768, 16, (tgmm.NARROW16, 256, 36, 36)),
    (8192, 768, 32, (tgmm.NARROW32, 256, 36, 36)),
    # w1's full-width gradient: whole groups, no workspace
    (8192, 768, 768, (tgmm.WIDE, 8192, 5, 0)),
    (1000, 768, 16, (tgmm.NARROW16, 64, 20, 20)),
    (0, 768, 16, (tgmm.NARROW16, 64, 4, 0))], ids=str)
def test_tgmm_plan(m, k, n, plan):
    assert tgmm.tgmm_plan(m, k, n, 4, 132) == plan
    bk, bn, _ = tgmm.TGMM_TILES[plan[0]]
    ctas = plan[2] * -(-k // bk) * -(-n // bn)
    assert m < 8192 or ctas >= 2 * 132
    assert plan[3] * k * n * 4 <= 4 << 20      # workspace <= 4 MB
    assert tgmm.tgmm_takes_tc(torch.empty((m, k), dtype=torch.bfloat16),
                              torch.empty((m, n), dtype=torch.bfloat16))
