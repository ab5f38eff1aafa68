"""PyTorch port vs the JAX package: the decode-front and decode attention
twins (bf16/f32 and int8 caches) against the JAX oracles and Pallas kernels
(interpret mode), on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu.inference.weights import quantize_int8 as j_quantize
from spt_proto_tpu.ops.pallas import decode_attention as jattn
from spt_proto_tpu.ops.pallas.decode_attention import \
    decode_attention_rows_q_ms as j_attn_ms
from spt_proto_tpu.ops.pallas.decode_front import build_pq_bd as j_build_pq_bd
from spt_proto_tpu.ops.pallas.decode_front import decode_front as j_front
from spt_proto_tpu_torch.ops import decode_attention as tattn
from spt_proto_tpu_torch.ops import decode_front as tfront

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)

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


def _packed_int8(w):
    """[3, D, D] -> the int8 weight build's packed form {'q': [D, 3D_pad]
    int8 (3 x 128 -> 512 columns), 'scale': [1, 3D] f32}, as numpy."""
    wq = j_quantize(jnp.concatenate([jnp.asarray(w[i]) for i in range(3)],
                                    axis=-1))
    return {k: np.asarray(a) for k, a in wq.items()}


@pytest.mark.parametrize('width,quantized,w_form', [
    (8, True, 'stack'), (16, True, 'stack'), (8, False, 'stack'),
    (8, True, 'packed_int8'), (16, False, 'packed_int8')],
    ids=['8-True', '16-True', '8-False', '8-True-packed_int8',
         '16-False-packed_int8'])
def test_decode_front_twin_matches_jax_kernel(width, quantized, w_form):
    """The twin vs the JAX kernel (interpret mode) in both weight forms:
    codes, tables and k8/v8 exact, q/k/v to ulps."""
    x, nsc, nbi, w, bq, bd, cbn, cc, pos, nt = _front_inputs(width)
    nsel, base = 5, nt          # second layer's slab
    kw = dict(nt=nt, nsel=nsel, n_sub=8, ps=TILE, quantized=quantized)
    if w_form == 'packed_int8':
        w = _packed_int8(w)
        assert w['q'].shape == (128, 512) and w['scale'].shape == (1, 384)
    j_w = jax.tree.map(jnp.asarray, w)
    want = j_front(*(jnp.asarray(a) for a in (x, nsc, nbi)), j_w,
                   *(jnp.asarray(a) for a in (bq, bd, cbn, cc, pos)),
                   jnp.full((1,), base, jnp.int32), **kw)
    want = [np.asarray(a) for a in want]
    args = [t(x), t(nsc), t(nbi), jax.tree.map(t, w)] + \
        [t(a) for a in (bq, bd, cbn, cc, pos)]
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


def _rows_inputs(g, mode, seed=1, b=3, kv=4, d=64, ps=32, n_sub=4, layers=1):
    """bf16-path inputs in the layout of tests/test_decode_attention_kernel.py
    (f32 caches of 8 tiles of 32 tokens a layer), from a numpy seed.
    mode 'dense' / 'dense-tps2' / 'dense-tps4': supertile starts 0, tps, ...
    covering the write tile, one table row for all heads, and zero codes;
    'sparse': per-head rows of 3 entries with -1 padding, current last."""
    rng = np.random.RandomState(seed)
    nt = 8
    tps = int(mode[len('dense-tps'):]) if mode.startswith('dense-tps') else 1
    q = rng.randn(b, kv, g, d).astype(np.float32)
    kc = rng.randn(b, kv, layers * nt, d, ps).astype(np.float32)
    vc = rng.randn(b, kv, layers * nt, d, ps).astype(np.float32)
    pos = rng.randint(ps, nt * ps - 1, size=b).astype(np.int32)
    cur = pos // ps
    if mode.startswith('dense'):
        cc = np.zeros((b, kv, layers * nt, 1, ps), np.int32)
        cn = np.zeros((b, kv, 1), np.int32)
        t_max = -(-nt // tps)
        tables = np.full((b, 1, t_max), -1, np.int32)
        n_tiles = cur // tps + 1
        for i in range(b):
            tables[i, 0, :n_tiles[i]] = np.arange(n_tiles[i]) * tps
    else:
        cc = rng.randint(0, 16, size=(b, kv, layers * nt, n_sub, ps)).astype(
            np.int32)
        cn = rng.randint(0, 16, size=(b, kv, n_sub)).astype(np.int32)
        tables = np.full((b, kv, 3), -1, np.int32)
        n_tiles = np.full(b, 3, np.int32)
        for i in range(b):
            for h in range(kv):
                k_n = min(2, cur[i])
                chosen = np.sort(rng.choice(cur[i], size=k_n, replace=False))
                tables[i, h] = list(chosen) + [-1] * (2 - k_n) + [cur[i]]
    kn = rng.randn(b, kv, d).astype(np.float32)
    vn = rng.randn(b, kv, d).astype(np.float32)
    return [q, kc, vc, cc, tables, n_tiles.astype(np.int32), pos, kn, vn,
            cn], tps


def _rows_both(arrays, tps, tile_base=None, clamp=0.0, ps=32):
    """The JAX oracle and the port's twin on the same inputs."""
    kw = dict(ps=ps, tps=tps, scale=64 ** -0.5, clamp=clamp)
    tb = () if tile_base is None else (tile_base,)
    want = jattn.decode_attention_rows_ref(
        *(jnp.asarray(a) for a in arrays + list(tb)), **kw)
    got = tattn.decode_attention_rows_ref(*(t(a) for a in arrays + list(tb)),
                                          **kw)
    return [np.asarray(a) for a in want], [a.numpy() for a in got], kw


@pytest.mark.parametrize('mode', ['dense', 'dense-tps2', 'dense-tps4',
                                  'sparse'])
@pytest.mark.parametrize('g', [1, 2])
def test_decode_attention_rows_twin_matches_jax_ref(mode, g):
    arrays, tps = _rows_inputs(g, mode)
    want, got, kw = _rows_both(arrays, tps,
                               clamp=10.0 if mode == 'sparse' else 0.0)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    for g_, w_ in zip(got[1:], want[1:]):          # appended caches: exact
        np.testing.assert_array_equal(g_, w_)
    # the wrapper on CPU tensors is the twin (in place) and launches nothing
    tens = [t(a) for a in arrays]
    n0 = tattn.decode_attention_rows.launches
    wrapped = tattn.decode_attention_rows_ms(*tens, **kw)
    np.testing.assert_array_equal(wrapped[0].numpy(), got[0])
    assert all(w_ is a for w_, a in zip(wrapped[1:], tens[1:4]))
    assert tattn.decode_attention_rows.launches == n0 == 0


def test_decode_attention_rows_grouped_tables_and_tile_base():
    """Two layers folded on the tile axis; the second slot reads layer 1
    (tile_base 8) through two table rows, each serving two of the 4 heads,
    and the first slot reads layer 0."""
    arrays, tps = _rows_inputs(1, 'sparse', seed=2, layers=2)
    base = np.array([0, 8, 8], np.int32)
    tables = arrays[4][:, ::2]                         # rows for heads 0, 2
    arrays[4] = np.where(tables >= 0, tables + base[:, None, None], -1)
    want, got, _ = _rows_both(arrays, tps, tile_base=base, clamp=10.0)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    for g_, w_ in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g_, w_)
    # a grouped row reads as the same row repeated per head
    per_head = list(arrays)
    per_head[4] = np.repeat(arrays[4], 2, axis=1)
    again = tattn.decode_attention_rows_ref(*(t(a) for a in per_head),
                                            t(base), ps=32, scale=0.125,
                                            clamp=10.0)
    np.testing.assert_allclose(again[0].numpy(), got[0], atol=1e-6)


def test_decode_attention_rows_twin_matches_jax_kernel():
    """The twin against the JAX Pallas kernel itself (interpret mode), dense
    supertiles of 2 with one table row for all heads."""
    arrays, tps = _rows_inputs(2, 'dense-tps2', seed=3)
    want = jattn.decode_attention_rows(
        *(jnp.asarray(a) for a in arrays), ps=32, tps=tps, scale=0.125,
        interpret=True)
    got = tattn.decode_attention_rows_ref(*(t(a) for a in arrays), ps=32,
                                          tps=tps, scale=0.125)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-5)
    for g_, w_ in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def test_decode_attention_q_twin_dense_supertiles_match_jax_ref():
    """The int8 twin with tps 4 and one table row for all heads, as dense
    decode over the int8 cache sends it, vs the JAX int8 oracle."""
    arrays, nt = _attn_inputs(seed=4)
    b, kv = 3, 2
    pos = arrays[8]
    n_sup = pos // TILE // 4 + 1
    tables = np.full((b, 1, 2), -1, np.int32)
    for i in range(b):
        tables[i, 0, :n_sup[i]] = np.arange(n_sup[i]) * 4 + nt
    arrays = list(arrays)
    arrays[3] = np.zeros((b, kv, 2 * nt, 1, TILE), np.int32)    # code cache
    arrays[6], arrays[7] = tables, n_sup.astype(np.int32)
    arrays[11] = np.zeros((b, kv, 1), np.int32)                 # c_new
    kw = dict(ps=TILE, tps=4, scale=64 ** -0.5, clamp=0.0)
    want = jattn.decode_attention_rows_q_ref(
        *(jnp.asarray(a) for a in arrays), **kw)
    got = tattn.decode_attention_rows_q_ref(*(t(a) for a in arrays), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-5)
    for g_, w_ in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
