"""PyTorch port vs the JAX package: the decode-front and int8 decode
attention twins against the JAX Pallas kernels (interpret mode), on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu.ops.pallas.decode_attention import \
    decode_attention_rows_q_ms as j_attn_ms
from spt_proto_tpu.ops.pallas.decode_front import build_pq_bd as j_build_pq_bd
from spt_proto_tpu.ops.pallas.decode_front import decode_front as j_front
from spt_proto_tpu_torch.ops import decode_attention as tattn
from spt_proto_tpu_torch.ops import decode_front as tfront

TILE = 128


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _front_inputs(width, seed=0):
    """sparse_model geometry (d_model 128, 2 heads, d_head 64, 8 PQ
    subspaces of 16 codes), 2 layers of 8 tiles, slots at positions 300
    (partial current tile), 129 and 1000."""
    rng = np.random.RandomState(seed)
    b, d, kv, n_sub, n_code, nt, l = 3, 128, 2, 8, 16, 8, 2
    x = rng.randn(b, d).astype(np.float32)
    nsc = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    nbi = (0.1 * rng.randn(d)).astype(np.float32)
    w = (rng.randn(3, d, d) / np.sqrt(d)).astype(np.float32)
    bq = (0.1 * rng.randn(3, d)).astype(np.float32)
    cb = rng.randn(n_sub, n_code, 8).astype(np.float32)
    bd, cbn = (np.asarray(a) for a in j_build_pq_bd(jnp.asarray(cb)))
    # few distinct codes per subspace so tile scores tie often
    cc = rng.randint(0, 3, size=(b, kv, l * nt, width, TILE)).astype(np.int32)
    cc[:, :, :, n_sub:] = -2
    pos = np.array([300, 129, 1000], np.int32)
    return x, nsc, nbi, w, bq, bd, cbn, cc, pos, nt


@pytest.mark.parametrize('width,quantized', [(8, True), (16, True),
                                             (8, False)])
def test_decode_front_twin_matches_jax_kernel(width, quantized):
    x, nsc, nbi, w, bq, bd, cbn, cc, pos, nt = _front_inputs(width)
    nsel, base = 5, nt          # second layer's slab
    kw = dict(nt=nt, nsel=nsel, n_sub=8, ps=TILE, quantized=quantized)
    want = j_front(*(jnp.asarray(a) for a in (x, nsc, nbi, w, bq, bd, cbn,
                                              cc, pos)),
                   jnp.full((1,), base, jnp.int32), **kw)
    want = [np.asarray(a) for a in want]
    args = [t(a) for a in (x, nsc, nbi, w, bq, bd, cbn, cc, pos)]
    got = [a.numpy() for a in tfront.decode_front_ref(*args, base, **kw)]
    assert len(got) == len(want) == (9 if quantized else 5)
    # q/k/v: XLA and torch sum the norm statistics and the projection in
    # different orders (ULP-level differences)
    for g_, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g_, w_, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got[3], want[3])          # codes
    np.testing.assert_array_equal(got[4], want[4])          # tables
    tab = want[4]
    assert (((tab >= base) & (tab < base + nt)) | (tab == -1)).all()
    if quantized:
        for g_, w_ in zip(got[5:7], want[5:7]):             # k8 / v8
            np.testing.assert_array_equal(g_, w_)
        for g_, w_ in zip(got[7:], want[7:]):               # scales
            np.testing.assert_allclose(g_, w_, rtol=2e-6)
    # the wrapper on CPU tensors is the twin and launches nothing
    n0 = tfront.decode_front.launches
    wrapped = tfront.decode_front(*args, base, **kw)
    for a, g_ in zip(wrapped, got):
        np.testing.assert_array_equal(a.numpy(), g_)
    assert tfront.decode_front.launches == n0 == 0


def test_decode_front_twin_selects_off_diagonal_tiles():
    """Selection beyond the current tile: nsel-1 full tiles by mean match,
    -1 once the slot has fewer full tiles than that."""
    x, nsc, nbi, w, bq, bd, cbn, cc, pos, nt = _front_inputs(8, seed=1)
    args = [t(a) for a in (x, nsc, nbi, w, bq, bd, cbn, cc, pos)]
    tables = tfront.decode_front_ref(*args, 0, nt=nt, nsel=5, n_sub=8,
                                     ps=TILE)[4].numpy()
    cur = pos // TILE
    np.testing.assert_array_equal(tables[:, :, -1],
                                  np.broadcast_to(cur[:, None], (3, 2)))
    assert (tables[1, :, 1:4] == -1).all()     # slot at 129: one full tile
    assert (tables[0, :, :2] >= 0).all() and (tables[0, :, 2:4] == -1).all()
    assert len(set(tables[2, 0, :4])) == 4


def _attn_inputs(seed=0):
    rng = np.random.RandomState(seed)
    b, kv, g, d, nt, l, kvp = 3, 2, 1, 64, 8, 2, 8
    base = nt                                     # second layer
    q = rng.randn(b, kv, g, d).astype(np.float32)
    kc = rng.randint(-127, 128, size=(b, kv, l * nt, d, TILE)).astype(np.int8)
    vc = rng.randint(-127, 128, size=(b, kv, l * nt, d, TILE)).astype(np.int8)
    cc = rng.randint(0, 16, size=(b, kv, l * nt, 8, TILE)).astype(np.int32)
    ks = (rng.rand(b, l * nt, kvp, TILE) * 0.05).astype(np.float32)
    vs = (rng.rand(b, l * nt, kvp, TILE) * 0.05).astype(np.float32)
    # the pad heads past kv stay zero, as in every engine cache (the JAX
    # kernel rewrites their write column with the zero-padded new scale)
    ks[:, :, kv:] = vs[:, :, kv:] = 0.0
    pos =np.array([300, 129, 1000], np.int32)
    cur = pos // TILE
    tables = np.full((b, kv, 4), -1, np.int32)
    tables[0] = [[0, 1, -1, 2], [1, -1, -1, 2]]
    tables[1] = [[0, -1, -1, 1], [0, -1, -1, 1]]
    # slot 2 uses 3 of its 4 entries: the entry past n_tiles is empty, and
    # entry n_tiles-1 is the write tile (the kernels' table contract)
    tables[2] = [[6, 0, 7, 3], [2, 5, 7, 4]]
    tables = np.where(tables < 0, -1, tables + base).astype(np.int32)
    n_tiles = np.array([4, 4, 3], np.int32)
    last = tables[np.arange(b), :, n_tiles - 1]
    assert (last == cur[:, None] + base).all()
    kn = rng.randint(-127, 128, size=(b, kv, d)).astype(np.int8)
    vn = rng.randint(-127, 128, size=(b, kv, d)).astype(np.int8)
    cn = rng.randint(0, 16, size=(b, kv, 8)).astype(np.int32)
    ksn = (rng.rand(b, kv) * 0.05).astype(np.float32)
    vsn = (rng.rand(b, kv) * 0.05).astype(np.float32)
    tb = np.full((b,), base, np.int32)
    return (q, kc, vc, cc, ks, vs, tables, n_tiles, pos, kn, vn, cn, ksn,
            vsn, tb), nt


@pytest.mark.parametrize('clamp', [10.0, 0.0])
def test_decode_attention_twin_matches_jax_kernel(clamp):
    arrays, nt = _attn_inputs()
    kw = dict(ps=TILE, scale=64 ** -0.5, clamp=clamp)
    want = j_attn_ms(*(jnp.asarray(a) for a in arrays), tps=1, nt_layer=nt,
                     **kw)
    want = [np.asarray(a) for a in want]
    tens = [t(a) for a in arrays]
    got = tattn.decode_attention_rows_q_ref(*tens, **kw)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5, rtol=1e-5)
    for g_, w_ in zip(got[1:], want[1:]):           # appended caches: exact
        np.testing.assert_array_equal(g_.numpy(), w_)
    # updated in place: the returned caches are the inputs
    assert all(g_ is a for g_, a in zip(got[1:], tens[1:6]))
    tens = [t(a) for a in arrays]
    n0 = tattn.decode_attention_rows_q.launches
    wrapped = tattn.decode_attention_rows_q_ms(*tens, **kw)
    assert torch.equal(wrapped[0], got[0])
    assert tattn.decode_attention_rows_q.launches == n0 == 0
