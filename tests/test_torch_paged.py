"""PyTorch port vs the JAX package: the paged KV cache on the CPU.

The paged-attention kernel's plain twin (ops/paged_attention.py) against
JAX's paged_attention_ref and, over int8 pages, paged_attention_op off the
TPU; the tile-pool decode-attention twin against JAX's Pallas kernel
(interpret mode) and its oracle; paged_sparse_attention against JAX's with
tied page scores; paged_prefill + paged_decode_step against JAX's for tiny
OPT (dense, sparse, int8 pages) and LLaMA GQA models. Inputs come from numpy
seeds; the model weights from the port's seeded init_params, handed to both
packages as numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu.config import tiny_config
from spt_proto_tpu.inference import paged as jpaged
from spt_proto_tpu.inference.weights import InferenceWeights as JIW
from spt_proto_tpu.ops.pallas import decode_attention as jattn
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference import paged as tpaged
from spt_proto_tpu_torch.inference.weights import InferenceWeights as TIW
from spt_proto_tpu_torch.ops import decode_attention as tattn
from spt_proto_tpu_torch.ops import paged_attention as tpa
from test_torch_engine import port_config

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)

BF16_STEP = 2.0 ** -7     # one bf16 step, relative


def t(a):
    return torch.from_numpy(np.array(a))


def bf16_close(got, want):
    """Within one bf16 step of the larger magnitude: the two round the same
    f32 sums to bf16, in different orders."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = BF16_STEP * np.maximum(np.abs(got), np.abs(want)) + 1e-6
    return bool((np.abs(got - want) <= bound).all())


# ---------------------------------------------------------------------------
# the paged-attention kernel's twin
# ---------------------------------------------------------------------------

def _paged_inputs(g, seed=0, b=4, kv=2, d=64, ps=16, n_pages=12, pps=4):
    """Random pools and tables: each slot's pages a random permutation;
    slot 1's table ends in -1 entries (read as page 0, masked by its
    length), slot 2's length sits on a page boundary, the others ragged."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, kv * g, d).astype(np.float32)
    k = rs.randn(kv, n_pages, ps, d).astype(np.float32)
    v = rs.randn(kv, n_pages, ps, d).astype(np.float32)
    tables = np.stack([rs.permutation(n_pages)[:pps]
                       for _ in range(b)]).astype(np.int32)
    tables[1, 2:] = -1
    lengths = np.array([3 * ps + 5, 2 * ps - 3, 2 * ps, 1], np.int32)
    return q, k, v, lengths, tables


@pytest.mark.parametrize('dtype,g', [('float32', 1), ('float32', 2),
                                     ('bfloat16', 1), ('bfloat16', 2)])
def test_paged_attention_twin_matches_jax_ref(dtype, g):
    """f32 to 1e-5; bf16 to one bf16 step (both round the same f32 sums and
    probabilities to bf16)."""
    q, k, v, lengths, tables = _paged_inputs(g)
    scale = q.shape[-1] ** -0.5
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jpaged.paged_attention_ref(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(lengths), jnp.asarray(tables), scale=scale)
    got = tpa.paged_attention(t(q).to(td), t(k).to(td), t(v).to(td),
                              t(lengths), t(tables), scale=scale)
    assert got.dtype == td and got.shape == q.shape
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert bf16_close(got, want), np.abs(got - want).max()
    assert tpa.paged_attention.launches == 0


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_paged_attention_int8_twin_matches_jax_op(dtype):
    """int8 pages with per-token scales (the stock kernel's QuantizedTensor
    form) through JAX's paged_attention_op off the TPU: the pages read back
    as (x * h) / 127.5 in q's dtype. The pools come from each side's
    _quantize_pages of the same values, which must agree exactly."""
    q, k, v, lengths, tables = _paged_inputs(2, seed=1)
    scale = q.shape[-1] ** -0.5
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jk, jks = jpaged._quantize_pages(jnp.asarray(k))
    jv, jvs = jpaged._quantize_pages(jnp.asarray(v))
    tk, tks = tpaged._quantize_pages(t(k))
    tv, tvs = tpaged._quantize_pages(t(v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    want = jpaged.paged_attention_op(
        jnp.asarray(q, jd), jk, jv, jnp.asarray(lengths),
        jnp.asarray(tables), scale=scale, k_scales=jks, v_scales=jvs)
    got = tpa.paged_attention(t(q).to(td), tk, tv, t(lengths), t(tables),
                              scale=scale, k_scales=tks, v_scales=tvs)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert bf16_close(got, want), np.abs(got - want).max()


def test_quantize_pages_saturates_as_xla():
    """A value whose scaled magnitude rounds to 128 saturates to 127, as
    XLA's int8 conversion does (torch alone would wrap it to -128)."""
    x = np.array([[1.0, -1.0, 0.5, 0.25]], np.float32)
    jq, jh = jpaged._quantize_pages(jnp.asarray(x))
    tq, th = tpaged._quantize_pages(t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert tq.numpy().max() == 127 and tq.numpy().min() == -128


# ---------------------------------------------------------------------------
# the tile-pool decode-attention kernel's twin
# ---------------------------------------------------------------------------

def _tile_pool_inputs(g, bk=6, d=64, ps=32, t_max=4, n_sub=4, seed=0):
    """tests/test_decode_attention_kernel.py's shapes and contract (each
    row owns a disjoint tile set; the write target is the last valid entry
    at the last valid lane), from a numpy seed."""
    rs = np.random.RandomState(seed)
    n_pool = bk * t_max
    q = rs.randn(bk, g, d).astype(np.float32)
    k_pool = rs.randn(n_pool, d, ps).astype(np.float32)
    v_pool = rs.randn(n_pool, d, ps).astype(np.float32)
    c_pool = rs.randint(0, 16, size=(n_pool, n_sub, ps)).astype(np.int32)
    perm = rs.permutation(n_pool)
    tables = np.stack([rs.permutation(perm[i * t_max:(i + 1) * t_max])
                       for i in range(bk)]).astype(np.int32)
    n_tiles = rs.randint(1, t_max + 1, size=bk).astype(np.int32)
    last_count = rs.randint(1, ps + 1, size=bk).astype(np.int32)
    write_tile = tables[np.arange(bk), n_tiles - 1].astype(np.int32)
    write_slot = (last_count - 1).astype(np.int32)
    k_new = rs.randn(bk, d).astype(np.float32)
    v_new = rs.randn(bk, d).astype(np.float32)
    c_new = rs.randint(0, 16, size=(bk, n_sub)).astype(np.int32)
    return (q, k_pool, v_pool, c_pool, tables, n_tiles, last_count, k_new,
            v_new, c_new, write_tile, write_slot)


@pytest.mark.parametrize('clamp', [0.0, 10.0])
@pytest.mark.parametrize('g', [1, 2])
def test_tile_pool_twin_matches_jax_kernel(g, clamp):
    """The twin against JAX's Pallas kernel (interpret mode) and its oracle:
    the appended pools equal, o to 2e-5 (the JAX kernel's online softmax
    against the oracle's and the twin's global one)."""
    args = _tile_pool_inputs(g)
    kw = dict(ps=32, scale=64 ** -0.5, clamp=clamp)
    jargs = [jnp.asarray(a) for a in args]
    o_k, kp_k, vp_k, cp_k = jattn.decode_attention(*jargs, interpret=True,
                                                   **kw)
    o_r = jattn.decode_attention_ref(*jargs, **kw)[0]
    got = tattn.decode_attention(*[t(a) for a in args], **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(o_k), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(o_r), atol=2e-5,
                               rtol=0)
    for g_, w_ in zip(got[1:], (kp_k, vp_k, cp_k)):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    assert tattn.decode_attention.launches == 0


def test_tile_pool_twin_wraps_negative_ids():
    """A -1 entry inside a row's n_tiles reads the pool's last tile, as the
    oracle's gather wraps it (the kernel wraps it the same way). That tile
    leaves the tables, so no row appends to it. The twin against JAX's
    oracle: o to 2e-5, the appended pools equal."""
    args = list(_tile_pool_inputs(2, seed=1))
    tables, n_tiles = args[4], args[5]
    n_pool = args[1].shape[0]
    n_tiles[0] = 3
    r, c = np.argwhere(tables == n_pool - 1)[0]
    tables[r, c] = tables[0, 1]
    tables[0, 1] = -1
    args[10] = tables[np.arange(len(n_tiles)), n_tiles - 1].astype(np.int32)
    kw = dict(ps=32, scale=64 ** -0.5, clamp=0.0)
    want = jattn.decode_attention_ref(*[jnp.asarray(a) for a in args], **kw)
    got = tattn.decode_attention(*[t(a) for a in args], **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-5, rtol=0)
    for g_, w_ in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


# ---------------------------------------------------------------------------
# paged sparse attention
# ---------------------------------------------------------------------------

def test_paged_sparse_attention_matches_jax_with_ties():
    """Two codewords, two subspaces and 4-token pages make tied page scores
    common; add dead pages (-1 entries, -inf) and the forced current page
    (+inf). The selection (a stable descending sort) must pick lax.top_k's
    pages, so o matches JAX's to 1e-5, and on these scores the port's order
    is lax.top_k's exactly."""
    rs = np.random.RandomState(3)
    b, kv, g, d, ps, n_sub, n_pages, pps = 3, 2, 2, 16, 4, 2, 24, 8
    qg = rs.randn(b, kv, g, d).astype(np.float32)
    codes_q = rs.randint(0, 2, size=(b, kv, g, n_sub)).astype(np.int32)
    k = rs.randn(kv, n_pages, ps, d).astype(np.float32)
    v = rs.randn(kv, n_pages, ps, d).astype(np.float32)
    c = rs.randint(0, 2, size=(kv, n_pages, ps, n_sub)).astype(np.int32)
    logical = np.stack([rs.permutation(n_pages)[:pps]
                        for _ in range(b)]).astype(np.int32)
    logical[2, 5:] = -1
    lengths = np.array([pps * ps, 5 * ps + 1, 3 * ps + 2], np.int32)
    phys = np.where(logical >= 0, logical, n_pages - 1).astype(np.int32)
    kw = dict(scale=d ** -0.5, clamp=4.0, sparse_coeff=4)
    want = jpaged.paged_sparse_attention(
        *(jnp.asarray(a) for a in (qg, codes_q, k, v, c, lengths, phys,
                                   logical)), **kw)
    got = tpaged.paged_sparse_attention(
        *(t(a) for a in (qg, codes_q, k, v, c, lengths, phys, logical)),
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # the page scores as both compute them, and the two selections
    match = (c[:, phys].transpose(1, 0, 2, 3, 4)[:, :, None]
             == codes_q[:, :, :, None, None, :]).sum(-1).astype(np.float32)
    cols = (np.arange(pps * ps)[None] < lengths[:, None]).reshape(b, pps, ps)
    pscore = np.where(cols[:, None, None], match, -1.0).mean(-1)
    live = (np.arange(pps)[None] * ps < lengths[:, None]) & (logical >= 0)
    pscore = np.where(live[:, None, None], pscore, -np.inf)
    cur = (np.maximum(lengths, 1) - 1) // ps
    pscore = np.where((np.arange(pps)[None] == cur[:, None])[:, None, None],
                      np.inf, pscore)
    nsel = pps // 4 + 1
    rounded = np.round(pscore[np.isfinite(pscore)] * ps)
    assert len(np.unique(rounded)) < rounded.size // 4   # many ties
    _, j_idx = jax.lax.top_k(jnp.asarray(pscore), nsel)
    t_idx = torch.sort(t(pscore), dim=-1, descending=True,
                       stable=True).indices[..., :nsel]
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


# ---------------------------------------------------------------------------
# paged prefill + decode steps
# ---------------------------------------------------------------------------

SPARSE = dict(attention='sparse_v2', d_codeword=4, n_codewords=8,
              sparse_coeff=4)
MODES = {
    'opt-dense': ('opt', {}, False),
    'opt-sparse': ('opt', SPARSE, False),
    'opt-dense-int8pages': ('opt', {}, True),
    'opt-sparse-int8pages': ('opt', SPARSE, True),
    'llama-gqa-dense': ('llama', dict(n_kv_heads=2), False),
}
B, S, PS, N_PAGES, MAX_LEN, STEPS = 2, 32, 4, 24, 48, 4


def _tables(rs):
    """Each slot's logical table, a disjoint random set of pages."""
    pps = MAX_LEN // PS
    perm = rs.permutation(N_PAGES)
    return np.stack([perm[i * pps:(i + 1) * pps]
                     for i in range(B)]).astype(np.int32)


@pytest.mark.parametrize('mode', list(MODES))
def test_paged_prefill_and_decode_match_jax(mode):
    """Prefill 32 tokens into 4-token pages (sparse_coeff 4 over 12 pages:
    4 selected), then 4 greedy steps on both sides: prefill logits to 1e-4
    and the pools equal (f32 to 1e-5; int8 within one step, as XLA and
    torch sum the k/v projections in different orders); the steps' logits
    to 1e-4 over f32 pages; greedy tokens exact."""
    arch, kw, quant = MODES[mode]
    cfg = tiny_config(arch, max_length=256, **kw).replace(dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.numpy(), bridge.init_params(
        port_config(cfg), 0, device='cpu'))
    j_iw = JIW.from_params(cfg, jax.tree.map(jnp.asarray, params),
                           dtype=jnp.float32)
    t_iw = TIW.from_params(port_config(cfg),
                           bridge.params_from_numpy(params, device='cpu'))
    rs = np.random.RandomState(7)
    tokens = rs.randint(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    tables = _tables(rs)
    jc = jpaged.PagedKVCache.create(cfg, B, N_PAGES, PS, MAX_LEN,
                                    dtype=jnp.float32, quantized=quant)
    jc = jpaged.PagedKVCache(jc.k_pages, jc.v_pages, jc.c_pages,
                             jnp.asarray(tables), jc.length,
                             k_scales=jc.k_scales, v_scales=jc.v_scales)
    tc = tpaged.PagedKVCache.create(t_iw.cfg, B, N_PAGES, PS, MAX_LEN,
                                    dtype=torch.float32, quantized=quant,
                                    device='cpu')
    tc.page_indices.copy_(t(tables))
    j_logits, jc = jax.jit(jpaged.paged_prefill)(j_iw, jnp.asarray(tokens),
                                                 jc)
    t_logits, tc = tpaged.paged_prefill(t_iw, t(tokens), tc)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=0)
    _pools_close(tc, jc, quant)
    j_step = jax.jit(jpaged.paged_decode_step)
    j_tok = jnp.argmax(j_logits[:, -1], -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits[:, -1], -1).to(torch.int32)
    for i in range(STEPS):
        j_lg, jc = j_step(j_iw, j_tok, jc)
        t_lg, tc = tpaged.paged_decode_step(t_iw, t_tok, tc)
        if not quant:
            # over int8 pages a value one int8 step away (above) moves the
            # logits by ~1e-3, so there the greedy tokens are the check, as
            # for the contiguous int8 cache (test_torch_engine.py)
            np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg),
                                       atol=1e-4, rtol=0, err_msg=f'step {i}')
        j_tok = jnp.argmax(j_lg, -1).astype(jnp.int32)
        t_tok = torch.argmax(t_lg, -1).to(torch.int32)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    assert tc.length.tolist() == [S + STEPS] * B
    if quant:
        # the steps' k/v come from hidden states that read such entries, so
        # after them more values sit one step apart, none further
        for name in ('k_pages', 'v_pages'):
            diff = (getattr(tc, name).numpy().astype(np.int32)
                    - np.asarray(getattr(jc, name)).astype(np.int32))
            assert np.abs(diff).max() <= 1, name
    else:
        _pools_close(tc, jc, quant)
    if 'sparse' in mode:
        assert tc.c_pages.numpy().any()


def _int8_pages_close(tc, jc):
    """int8 pages within one step in < 1% of the written entries (XLA and
    torch sum the k/v projections in different orders, so k and v differ
    by a few ulps, the scales by up to ~2e-6 relative, and a value on a
    rounding boundary of the int8 grid lands one step away: 32 of 8,145
    after this prefill)."""
    for name in ('k_pages', 'v_pages'):
        got = getattr(tc, name).numpy().astype(np.float32)
        want = np.asarray(getattr(jc, name)).astype(np.float32)
        assert np.abs(got - want).max() <= 1, name
        written = (got != 0) | (want != 0)
        assert (got != want).sum() < 1e-2 * written.sum(), name


def _pools_close(tc, jc, quant):
    """The pools equal: codes exactly, f32 pages to 1e-5; int8 pages as
    _int8_pages_close, their scales to 1e-5 relative."""
    np.testing.assert_array_equal(tc.c_pages.numpy(), np.asarray(jc.c_pages))
    if quant:
        _int8_pages_close(tc, jc)
        for name in ('k_scales', 'v_scales'):
            np.testing.assert_allclose(getattr(tc, name).numpy(),
                                       np.asarray(getattr(jc, name)),
                                       rtol=1e-5, atol=0, err_msg=name)
        return
    for name in ('k_pages', 'v_pages'):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=1e-5,
                                   rtol=0, err_msg=name)
