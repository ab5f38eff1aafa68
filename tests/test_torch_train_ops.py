"""PyTorch port vs the JAX package: the training slice's ops on the CPU.

The block-sparse forward with log-sum-exp and the backward twins against
the JAX kernels (`_fwd_dispatch(..., with_lse=True)`, `_bwd_kernels_v3`,
`_bwd_kernels`, `_fwd_dma`; interpret mode) and against autograd through
the plain forward; PQ training math; the routed FFN forms, values and
gradients. Inputs come from numpy seeds and go through both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu.ops import block_sparse as jbs
from spt_proto_tpu.ops import pq as jpq
from spt_proto_tpu.ops import routed_ffn as jrf
from spt_proto_tpu.ops.pallas import block_sparse_attention as jbsa
from spt_proto_tpu_torch.ops import block_sparse as tbs
from spt_proto_tpu_torch.ops import block_sparse_attention as tbsa
from spt_proto_tpu_torch.ops import pq as tpq
from spt_proto_tpu_torch.ops import routed_ffn as trf

torch.set_num_threads(1)


def t(a, grad=False):
    return torch.from_numpy(np.asarray(a).copy()).requires_grad_(grad)


def bsa_case(bq, mult, s=512, d=64, b=2, seed=11):
    """tests/test_block_sparse.py's backward case: codes shared by q and k,
    3 tiles a q tile; mult 4 drives >50% of logits past the clamp."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, s, d) * mult).astype(np.float32)
    k = (rng.randn(b, s, d) * mult).astype(np.float32)
    v = rng.randn(b, s, d).astype(np.float32)
    g = rng.randn(b, s, d).astype(np.float32)
    codes = rng.randint(0, 16, (b, s, 8)).astype(np.int32)
    ts = jbs.pq_tile_scores(jnp.asarray(codes), jnp.asarray(codes),
                            n_codewords=16, block_q=bq, block_k=128)
    sel = np.array(jbs.select_tiles(ts, 3, block_ratio=bq // 128))
    return q, k, v, g, sel


BSA_CASES = [(256, 1.0), (128, 4.0)]


@pytest.mark.parametrize('bq,mult', BSA_CASES)
def test_lse_and_backward_twins_match_jax_kernels(bq, mult):
    """The lse forward twin vs `_fwd_dispatch(with_lse=True)` and the
    backward twin vs `_bwd_kernels_v3` and `_bwd_kernels` (interpret), f32.
    Tolerance 2e-5 (lse, o) and 1e-4 (grads, whose sums over up to 3 tiles
    x 128 keys or 512 rows run in other orders) absolute."""
    q, k, v, g, sel = bsa_case(bq, mult)
    kw = dict(block_q=bq, block_k=128, scale=64 ** -0.5, clamp=10.0)
    jq, jk, jv, jg, jsel = map(jnp.asarray, (q, k, v, g, sel))
    jo, jlse = jbsa._fwd_dispatch(jq, jk, jv, jsel, interpret=True,
                                  with_lse=True, **kw)
    to, tlse = tbsa.block_sparse_attention_lse_ref(t(q), t(k), t(v), t(sel),
                                                   **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0],
                               atol=2e-5)
    # how often the clamp bites: the mult-4 case must exercise the mask
    s_pre = np.einsum('bqd,bkd->bqk', q, k) * kw['scale']
    sat = (np.abs(s_pre) > 10.0).mean()
    assert (sat > 0.5) == (mult > 1), sat
    want = tbsa.block_sparse_attention_bwd_ref(
        t(q), t(k), t(v), t(sel), to, tlse, t(g), **kw)
    for bwd in (jbsa._bwd_kernels_v3, jbsa._bwd_kernels):
        got = bwd(jq, jk, jv, jsel, jo, jlse, jg, interpret=True, **kw)
        for name, a, w in zip(('dq', 'dk', 'dv'), got, want):
            np.testing.assert_allclose(w.numpy(), np.asarray(a), atol=1e-4,
                                       err_msg=f'{bwd.__name__} {name}')


@pytest.mark.parametrize('bq,mult', BSA_CASES)
def test_backward_twin_matches_autograd_of_the_ref(bq, mult):
    """The differentiable wrapper (the twins on the CPU) vs autograd
    through ops.block_sparse.block_sparse_attention_ref, JAX's
    bwd_impl='ref' oracle: the loss of test_block_sparse.py (sum of sin)."""
    q, k, v, _, sel = bsa_case(bq, mult)
    kw = dict(block_q=bq, block_k=128, scale=64 ** -0.5, clamp=10.0)
    grads = []
    for fn in (tbsa.block_sparse_attention, tbs.block_sparse_attention_ref):
        ins = [t(x, grad=True) for x in (q, k, v)]
        torch.sin(fn(*ins, t(sel), **kw)).sum().backward()
        grads.append([x.grad for x in ins])
    for name, a, b in zip(('dq', 'dk', 'dv'), *grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   err_msg=name)


def test_reverse_table_and_bf16_backward():
    """reverse_table matches JAX's _reverse_table; the bf16 twin rounds
    where the kernels do and stays within one bf16 step of f32."""
    _, _, _, _, sel = bsa_case(128, 1.0, s=1024)
    sel = sel.copy()
    sel[0, 5] = [sel[0, 5, 1], sel[0, 5, 2], -1]   # a row with a -1 slot
    want = np.asarray(jbsa._reverse_table(jnp.asarray(sel), 8))
    got = tbsa.reverse_table(t(sel), 8).numpy()
    np.testing.assert_array_equal(got, want)
    q, k, v, g, sel = bsa_case(256, 1.0)
    kw = dict(block_q=256, block_k=128, scale=64 ** -0.5, clamp=10.0)
    f32 = [t(x) for x in (q, k, v)]
    bf = [x.to(torch.bfloat16) for x in f32]
    o, lse = tbsa.block_sparse_attention_lse_ref(*bf, t(sel), **kw)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = tbsa.block_sparse_attention_bwd_ref(*bf, t(sel), o, lse,
                                              t(g).to(torch.bfloat16), **kw)
    o32, lse32 = tbsa.block_sparse_attention_lse_ref(*f32, t(sel), **kw)
    want = tbsa.block_sparse_attention_bwd_ref(*f32, t(sel), o32, lse32,
                                               t(g), **kw)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        scale = w.abs().max().item()
        assert (a.float() - w).abs().max().item() < 2 ** -5 * scale


def test_fwd_dma_matches_forward_twin():
    """Row 7 (`_fwd_dma`, the in-kernel double-buffered DMA form) at its own
    test shape (d_head 128, block_q 256, as test_block_sparse.py's
    test_dma_kernel_matches_ref) against the port's forward twin, which the
    one forward kernel implements."""
    rng = np.random.RandomState(3)
    b, s, d = 2, 512, 128
    q, k, v = (rng.randn(b, s, d).astype(np.float32) for _ in range(3))
    cq = rng.randint(0, 16, (b, s, 8)).astype(np.int32)
    ck = rng.randint(0, 16, (b, s, 8)).astype(np.int32)
    ts = jbs.pq_tile_scores(jnp.asarray(cq), jnp.asarray(ck), n_codewords=16,
                            block_q=256, block_k=128)
    sel = np.asarray(jbs.select_tiles(ts, 3, block_ratio=2))
    kw = dict(block_q=256, block_k=128, scale=d ** -0.5, clamp=10.0)
    want = jbsa._fwd_dma(*map(jnp.asarray, (q, k, v, sel)), interpret=True,
                         **kw)
    got = tbsa.block_sparse_attention(t(q), t(k), t(v), t(sel), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# ---------------------------------------------------------------------------
# PQ training math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('metric', ['l1', 'l2'])
def test_pq_train_quantize_decode_match_jax(metric):
    """pq_train's loss, z_q and its gradients to z and the codebook, and
    pq_quantize / pq_decode, against JAX (f32, 1e-5 relative)."""
    rng = np.random.RandomState(5)
    z = rng.randn(3, 40, 16).astype(np.float32)
    cb = rng.randn(2, 16, 8).astype(np.float32)
    z[0, 0, :8] = cb[0, 3]                       # a zero distance (clamped)

    def jloss(z_, cb_):
        zq, loss = jpq.pq_train(z_, cb_, metric)
        return loss + 0.1 * jnp.sum(jnp.sin(zq)), (zq, loss)
    (jl, (jzq, jloss_only)), (jgz, jgc) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(z), jnp.asarray(cb))
    tz, tcb = t(z, grad=True), t(cb, grad=True)
    zq, loss = tpq.pq_train(tz, tcb, metric)
    (loss + 0.1 * torch.sin(zq).sum()).backward()
    np.testing.assert_allclose(loss.item(), float(jloss_only), rtol=1e-5)
    np.testing.assert_allclose(zq.detach().numpy(), np.asarray(jzq),
                               atol=1e-6)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgz), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tcb.grad.numpy(), np.asarray(jgc), rtol=1e-4,
                               atol=1e-6)
    codes = np.asarray(jpq.pq_encode(jnp.asarray(z), jnp.asarray(cb),
                                     metric))
    np.testing.assert_array_equal(
        tpq.pq_decode(t(codes), t(cb)).numpy(),
        np.asarray(jpq.pq_decode(jnp.asarray(codes), jnp.asarray(cb))))
    np.testing.assert_allclose(
        tpq.pq_quantize(t(z), t(cb), metric).numpy(),
        np.asarray(jpq.pq_quantize(jnp.asarray(z), jnp.asarray(cb), metric)),
        atol=0)


# ---------------------------------------------------------------------------
# routed FFN
# ---------------------------------------------------------------------------

def ffn_case(gated, lora, seed=2, t_=24, d=16, n=4, bs=8, r=4):
    rng = np.random.RandomState(seed)
    a = lambda *s: rng.randn(*s).astype(np.float32) * 0.5
    probs = 1 / (1 + np.exp(-a(t_, n) * 4))
    probs[0] = [0.7, 0.7, 0.7, 0.2]              # a top-2 tie: lower index wins
    probs[1] = [0.3, 0.6, 0.6, 0.6]
    x = a(t_, d)
    if gated:
        w = [a(n, d, bs), a(n, d, bs), a(n, bs, d)]
        lw = [a(d, r), a(n, bs, r), a(d, r), a(n, bs, r), a(n, bs, r),
              a(d, r)]
    else:
        w = [a(n, d, bs), a(n, bs), a(n, bs, d), a(d)]
        lw = [a(d, r), a(n, bs, r), a(n, bs, r), a(d, r)]
    return x, probs.astype(np.float32), w + (lw if lora else [])


@pytest.mark.parametrize('gated', [False, True])
@pytest.mark.parametrize('lora', [False, True])
def test_routed_ffn_forms_match_jax(gated, lora):
    """Values and gradients (to x, probs and every weight) of the four
    routed forms against jax.grad, with router ties. f32: the loss to 1e-5
    relative, each gradient to 1e-5 of its largest entry (XLA and torch sum
    the block einsums in other orders)."""
    x, probs, ws = ffn_case(gated, lora)
    top_k = 2
    name = ('routed_ffn_gated' if gated else 'routed_ffn') + \
        ('_lora' if lora else '_masked')
    jf, tf = getattr(jrf, name), getattr(trf, name)
    jact = jax.nn.silu if gated else jax.nn.relu
    tact = torch.nn.functional.silu if gated else torch.relu
    gates = np.asarray(jrf.router_gates(jnp.asarray(probs), top_k))
    np.testing.assert_array_equal(
        trf.router_gates(t(probs), top_k).numpy(), gates)
    assert gates[0].tolist() == [True, True, False, False]
    assert gates[1].tolist() == [False, True, True, False]

    def jloss(*args):
        return jnp.sum(jnp.sin(jf(args[0], args[1], top_k, *args[2:],
                                  jact)))
    jargs = [jnp.asarray(a) for a in (x, probs, *ws)]
    jl, jg = jax.value_and_grad(jloss, argnums=tuple(range(len(jargs))))(
        *jargs)
    targs = [t(a, grad=True) for a in (x, probs, *ws)]
    tl = torch.sin(tf(targs[0], targs[1], top_k, *targs[2:], tact)).sum()
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for i, (a, w) in enumerate(zip(targs, jg)):
        w = np.asarray(w)
        # the masked forms route by a non-differentiable gate: no grad to
        # probs in torch, zeros in JAX
        got = np.zeros_like(w) if a.grad is None else a.grad.numpy()
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f'{name} arg {i}')
