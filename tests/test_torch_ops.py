"""PyTorch port vs the JAX package: PQ math, tile selection, the per-row
oracle, block-sparse attention, the greedy lm_head and the fused FFN tail,
on the CPU.

Inputs come from numpy seeds and go through both packages. The JAX Pallas
kernels run in interpret mode (as the JAX package's own tests run them);
the port's wrappers, handed CPU tensors, run their plain twins.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu.ops import block_sparse as jbs
from spt_proto_tpu.ops import lookup as jlookup
from spt_proto_tpu.ops import pq as jpq
from spt_proto_tpu.ops import sparse_attention as jsa
from spt_proto_tpu.ops.pallas import block_sparse_attention as jbsa
from spt_proto_tpu.ops.pallas import ffn_tail as jffn
from spt_proto_tpu.ops.pallas import lm_head as jlm
from spt_proto_tpu.ops.pallas.decode_front import build_pq_bd as j_build_pq_bd
from spt_proto_tpu_torch.ops import block_sparse as tbs
from spt_proto_tpu_torch.ops import block_sparse_attention as tbsa
from spt_proto_tpu_torch.ops import ffn_tail as tffn
from spt_proto_tpu_torch.ops import lm_head as tlm
from spt_proto_tpu_torch.ops import lookup as tlookup
from spt_proto_tpu_torch.ops import pq as tpq
from spt_proto_tpu_torch.ops import sparse_attention as tsa
from spt_proto_tpu_torch.ops.decode_front import build_pq_bd as t_build_pq_bd
from test_torch_engine import jitted

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize('metric', ['l1', 'l2'])
def test_pq_encode_matches_jax(metric):
    rng = np.random.RandomState(0)
    z = rng.randn(5, 40, 64).astype(np.float32)
    cb = rng.randn(8, 16, 8).astype(np.float32)
    want = np.asarray(jpq.pq_encode(jnp.asarray(z), jnp.asarray(cb), metric))
    got = tpq.pq_encode(t(z), t(cb), metric).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    d_want = np.asarray(jpq.pq_distances(jnp.asarray(z), jnp.asarray(cb),
                                         metric))
    np.testing.assert_allclose(tpq.pq_distances(t(z), t(cb), metric).numpy(),
                               d_want, rtol=1e-5, atol=1e-5)


def test_build_pq_bd_matches_jax():
    rng = np.random.RandomState(1)
    cb = rng.randn(8, 16, 8).astype(np.float32)
    bd_j, cbn_j = j_build_pq_bd(jnp.asarray(cb))
    bd_t, cbn_t = t_build_pq_bd(t(cb))
    np.testing.assert_array_equal(bd_t.numpy(), np.asarray(bd_j))
    np.testing.assert_allclose(cbn_t.numpy(), np.asarray(cbn_j), rtol=1e-6)
    # the block-diagonal form encodes exactly like pq_encode
    z = rng.randn(30, 64).astype(np.float32)
    score = (cbn_t - 2.0 * (t(z) @ bd_t)).reshape(30, 8, 16)
    np.testing.assert_array_equal(torch.argmin(score, -1).numpy(),
                                  tpq.pq_encode(t(z), t(cb), 'l2').numpy())


@pytest.mark.parametrize('n_code,block_q,n_sel', [(16, 128, 3), (2, 256, 3),
                                                  (2, 128, 4)])
def test_tile_scores_and_selection_match_jax(n_code, block_q, n_sel):
    """Two codewords make many tiles score the same: ties must go to the
    lowest tile index, as lax.top_k breaks them."""
    rng = np.random.RandomState(2)
    qc = rng.randint(0, n_code, size=(3, 1024, 8)).astype(np.int32)
    kc = rng.randint(0, n_code, size=(3, 1024, 8)).astype(np.int32)
    kw = dict(n_codewords=n_code, block_q=block_q, block_k=128)
    ts_j = np.asarray(jitted(jbs.pq_tile_scores, jnp.asarray(qc),
                             jnp.asarray(kc), **kw))
    ts_t = tbs.pq_tile_scores(t(qc), t(kc), **kw)
    np.testing.assert_array_equal(ts_t.numpy(), ts_j)
    ratio = block_q // 128
    sel_j = np.asarray(jitted(jbs.select_tiles, jnp.asarray(ts_j),
                              n_sel=n_sel, block_ratio=ratio))
    sel_t = tbs.select_tiles(ts_t, n_sel, ratio).numpy()
    np.testing.assert_array_equal(sel_t, sel_j)
    assert (sel_t < 0).any()
    # planted ties: every causal off-diagonal tile scores the same
    flat = np.zeros_like(ts_j)
    sel_j = np.asarray(jitted(jbs.select_tiles, jnp.asarray(flat),
                              n_sel=n_sel, block_ratio=ratio))
    np.testing.assert_array_equal(
        tbs.select_tiles(t(flat), n_sel, ratio).numpy(), sel_j)
    assert tbs.n_selected_tiles(2048, 128, 8) == \
        jbs.n_selected_tiles(2048, 128, 8)


def test_row_oracle_matches_jax():
    """pq_topk_indices + sparse_attention: the prefill fallback at prompt
    lengths that are not a tile multiple."""
    rng = np.random.RandomState(3)
    s = 300
    qc = rng.randint(0, 4, size=(4, s, 8)).astype(np.int32)
    kc = rng.randint(0, 4, size=(4, s, 8)).astype(np.int32)
    idx_j = np.asarray(jitted(jlookup.pq_topk_indices, jnp.asarray(qc),
                              jnp.asarray(kc), top_k=37, n_codewords=4))
    idx_t = tlookup.pq_topk_indices(t(qc), t(kc), top_k=37, n_codewords=4)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    q, k, v = (rng.randn(4, s, 64).astype(np.float32) for _ in range(3))
    o_j = jitted(jsa.sparse_attention, jnp.asarray(q * 4), jnp.asarray(k),
                 jnp.asarray(v), jnp.asarray(idx_j), scale=0.125, clamp=10.0)
    o_t = tsa.sparse_attention(t(q * 4), t(k), t(v), idx_t, scale=0.125,
                               clamp=10.0)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)


@pytest.mark.parametrize('block_q,n_sel,clamp', [(128, 3, 10.0),
                                                 (256, 3, 10.0),
                                                 (256, 4, None)])
def test_block_sparse_attention_matches_jax(block_q, n_sel, clamp):
    """The port's plain twin and its wrapper on CPU tensors vs the JAX Pallas
    forward (interpret) and the JAX reference, with a selection holding
    off-diagonal tiles and -1 entries."""
    rng = np.random.RandomState(4)
    b, s, d = 3, 1024, 64
    q = (rng.randn(b, s, d) * 3).astype(np.float32)
    k, v = (rng.randn(b, s, d).astype(np.float32) for _ in range(2))
    qc = rng.randint(0, 16, size=(b, s, 8)).astype(np.int32)
    kc = rng.randint(0, 16, size=(b, s, 8)).astype(np.int32)
    ts = jitted(jbs.pq_tile_scores, jnp.asarray(qc), jnp.asarray(kc),
                n_codewords=16, block_q=block_q, block_k=128)
    sel = np.asarray(jitted(jbs.select_tiles, ts, n_sel=n_sel,
                            block_ratio=block_q // 128))
    diag_lo = (np.arange(sel.shape[1]) * block_q // 128)[None, :, None]
    assert ((sel >= 0) & (sel < diag_lo)).any() and (sel < 0).any()
    kw = dict(block_q=block_q, block_k=128, scale=d ** -0.5, clamp=clamp)
    want = np.asarray(jbsa.block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sel),
        **kw))
    want_ref = np.asarray(jitted(
        jbs.block_sparse_attention_ref, jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(sel), **kw))
    got = tbs.block_sparse_attention_ref(t(q), t(k), t(v), t(sel), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=1e-5)
    n0 = tbsa.block_sparse_attention.launches
    wrapped = tbsa.block_sparse_attention(t(q), t(k), t(v), t(sel), **kw)
    assert torch.equal(wrapped, got)
    assert tbsa.block_sparse_attention.launches == n0 == 0


def test_lm_head_argmax_matches_jax():
    """Integer-valued inputs make every logit exact, so planted ties are
    real ties: the lowest index must win, also across V tiles, and a winner
    in the ragged last tile (V not a tile multiple) must be found."""
    rng = np.random.RandomState(5)
    b, d, v = 4, 64, 1000
    x = rng.randint(-3, 4, size=(b, d)).astype(np.float32)
    w = rng.randint(-3, 4, size=(d, v)).astype(np.float32)
    w[:, 300] = w[:, 700] = 20 * x[0]          # row 0: tie across tiles
    w[:, 990] = 20 * x[1]                       # row 1: ragged last tile
    w[:, 5] = w[:, 6] = 20 * x[2]               # row 2: tie inside a tile
    want = np.asarray(jlm.lm_head_argmax(jnp.asarray(x), jnp.asarray(w)))
    got = tlm.lm_head_argmax_ref(t(x), t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist()[:3] == [300, 990, 5]
    n0 = tlm.lm_head_argmax.launches
    assert torch.equal(tlm.lm_head_argmax(t(x), t(w)), got)
    assert tlm.lm_head_argmax.launches == n0 == 0
    # the serving dtype rounds logits before the compare
    xb = (torch.from_numpy(rng.randn(b, d).astype(np.float32))
          .to(torch.bfloat16))
    wb = (torch.from_numpy(rng.randn(d, v).astype(np.float32))
          .to(torch.bfloat16))
    want_b = np.asarray(jlm.lm_head_argmax(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16)))
    np.testing.assert_array_equal(tlm.lm_head_argmax_ref(xb, wb).numpy(),
                                  want_b)


def _ffn_inputs(m, d, f, seed=6):
    """tests/test_ffn_tail.py's shapes and scales, from a numpy seed."""
    rng = np.random.RandomState(seed)
    return [rng.randn(m, d).astype(np.float32),
            rng.randn(m, d).astype(np.float32),
            (rng.randn(d, f) * 0.05).astype(np.float32),
            rng.randn(f).astype(np.float32),
            (rng.randn(f, d) * 0.05).astype(np.float32),
            rng.randn(d).astype(np.float32)]


@pytest.mark.parametrize('m,d,f', [(8, 128, 256), (3, 256, 512)])
def test_ffn_tail_matches_jax(m, d, f):
    """The twin and its wrapper on CPU tensors vs the JAX oracle."""
    arrays = _ffn_inputs(m, d, f)
    want = np.asarray(jffn.ffn_tail_ref(*(jnp.asarray(a) for a in arrays),
                                        act='relu'))
    got = tffn.ffn_tail_ref(*(t(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    n0 = tffn.ffn_tail.launches
    assert torch.equal(tffn.ffn_tail(*(t(a) for a in arrays)), got)
    assert tffn.ffn_tail.launches == n0 == 0


def test_ffn_tail_matches_jax_kernel():
    """The twin against the JAX Pallas kernel (interpret mode)."""
    arrays = _ffn_inputs(5, 128, 384, seed=7)
    want = np.asarray(jffn.ffn_tail(*(jnp.asarray(a) for a in arrays),
                                    act='relu', interpret=True))
    got = tffn.ffn_tail_ref(*(t(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# The fused tails' kernel plan (ffn_tail_plan), pure Python: bf16 takes the
# tensor-core streams for every m up to MAX_ROWS (a tile whose warps hold
# all the rows, a ring that fits the card's shared memory), f32 and shapes
# off the rule (d or d_ff % 8, unaligned operands) the CUDA-core pair; the
# splits are whole 64-row stages, keep every K row, fill at most one wave.
@pytest.mark.parametrize('m,d,f,dtype,aligned,int8,route', [
    (8, 768, 3072, torch.bfloat16, True, False, 'tc'),      # OPT-125M
    (8, 768, 3072, torch.bfloat16, True, True, 'tc'),
    (8, 2048, 8192, torch.bfloat16, True, True, 'tc'),      # OPT-1.3B
    (1, 768, 3072, torch.bfloat16, True, False, 'tc'),
    (17, 768, 3072, torch.bfloat16, True, True, 'tc'),
    (63, 2048, 8192, torch.bfloat16, True, False, 'tc'),
    (64, 2048, 8192, torch.bfloat16, True, True, 'tc'),
    (65, 640, 2944, torch.bfloat16, True, True, 'tc'),
    (256, 768, 3072, torch.bfloat16, True, False, 'tc'),    # MAX_ROWS
    (8, 768, 3072, torch.float32, True, False, 'cuda_core'),
    (8, 2048, 8192, torch.float32, True, True, 'cuda_core'),
    (8, 772, 3072, torch.bfloat16, True, False, 'cuda_core'),  # d % 8
    (8, 768, 3076, torch.bfloat16, True, True, 'cuda_core'),   # d_ff % 8
    (8, 768, 3072, torch.bfloat16, False, False, 'cuda_core')], ids=str)
def test_ffn_tail_plan(m, d, f, dtype, aligned, int8, route):
    from spt_proto_tpu_torch.ops import weight_stream as ws
    plan = tffn.ffn_tail_plan(m, d, f, dtype, aligned, int8=int8)
    assert plan['route'] == route
    if route == 'cuda_core':
        assert plan['ft'] in (32, 64)
        return
    item = 1 if int8 else 2
    for name, n_w, n_x, k, n in (('up', 1, 1, d, f), ('down', 1, 2, f, d)):
        p = plan[name]
        cw, ng, stages = p['cw'], p['ng'], p['stages']
        assert (8 // cw) * ng * 8 >= m                 # every row held
        assert (stages, ng) in ((4, 1), (4, 2), (4, 4), (3, 1), (2, 4))
        smem = stages * ws.stage_bytes(item, n_w, n_x, cw, m)
        assert smem <= ws.MAX_SMEM
        kslice, slices = p['kslice'], p['slices']
        assert kslice % 64 == 0 and (slices - 1) * kslice < k <= \
            slices * kslice
        tiles = -(-n // (16 * cw))
        assert slices == 1 or slices * tiles <= ws.wave(smem)


# The decode front's kernel plan (front_plan), pure Python: bf16 takes the
# norm, one weight stream over q | k | v and the per-head tail at every
# serving form and width, f32 and the shapes off the rule the fused kernel;
# a column tile never straddles two parts, the warps hold every slot, the
# K slices keep every row and are whole K blocks in the int8 forms.
FRONT_WIDTHS = {'opt-125m': (768, [768] * 3), 'llama-7b': (4096, [4096] * 3),
                'llama-3-8b': (4096, [4096, 1024, 1024]),
                'tiny': (128, [128] * 3), 'tiny-gqa': (128, [128, 64, 64]),
                'd-not-256': (384, [384] * 3)}


@pytest.mark.parametrize('model', sorted(FRONT_WIDTHS))
@pytest.mark.parametrize('int8w', [False, True])
@pytest.mark.parametrize('b', [1, 3, 8, 9, 16])
def test_front_plan(model, int8w, b):
    from spt_proto_tpu_torch.ops import decode_front as tfront
    from spt_proto_tpu_torch.ops import weight_stream as ws
    d, widths = FRONT_WIDTHS[model]
    lds = [n + (-n % 256) if int8w else n for n in widths]
    plan = tfront.front_plan(b, d, widths, torch.bfloat16, int8w, lds)
    assert plan['route'] == 'stream'
    cw, ng, kslice = plan['cw'], plan['ng'], plan['kslice']
    assert all(n % (16 * cw) == 0 for n in widths)     # no tile straddles
    assert plan['tiles'] == sum(widths) // (16 * cw)
    assert (8 // cw) * ng * 8 >= b                     # every slot held
    assert (plan['stages'], ng) in ((4, 1), (4, 2), (4, 4), (3, 1), (2, 4))
    assert kslice % 64 == 0 and (plan['slices'] - 1) * kslice < d <= \
        plan['slices'] * kslice
    if int8w:
        assert kslice % tfront._front_block_k(d) == 0  # whole K blocks
    smem = plan['stages'] * ws.stage_bytes(1 if int8w else 2, 1, 1, cw, b)
    assert smem <= ws.MAX_SMEM
    # f32, an unaligned operand, a row stride off 16 bytes: the fused kernel
    for args in ((b, d, widths, torch.float32, int8w, lds),
                 (b, d, widths, torch.bfloat16, int8w, lds, False),
                 (b, d, widths, torch.bfloat16, int8w,
                  [lds[0] + 4] + lds[1:])):
        assert tfront.front_plan(*args)['route'] == 'fused'


def test_front_plan_off_rule_shapes():
    from spt_proto_tpu_torch.ops import decode_front as tfront
    bf = torch.bfloat16
    # a part no 16-column tile divides; D off 8; more slots than a tile holds
    assert tfront.front_plan(4, 64, [64, 24, 24], bf, False)['route'] == \
        'fused'
    assert tfront.front_plan(4, 68, [68] * 3, bf, False)['route'] == 'fused'
    assert tfront.front_plan(257, 768, [768] * 3, bf, False)['route'] == \
        'fused'
    assert tfront.front_plan(256, 768, [768] * 3, bf, False)['route'] == \
        'stream'


# The int8-KV decode attention's kernel rule (q_route) and the split walk's
# chunks, pure Python: bf16 at the serving tiles takes the split kernel for
# any table length, f32 and the shapes off the rule the kernels rows_walk
# names; the chunks cover every entry of a row once.
@pytest.mark.parametrize('g,d,n_ent,rows', [
    (1, 64, 3, 96),        # OPT-125M sparse
    (1, 64, 16, 96),       # OPT-125M dense, tps 4 (4 entries x 4)
    (4, 128, 3, 64),       # Llama-3-8B sparse
    (4, 128, 17, 64),      # Llama-3-8B dense
    (4, 128, 96, 64),      # a dense table past the one-pass kernel
    (8, 128, 5, 8)])
def test_q_route_and_split_chunks(g, d, n_ent, rows):
    from spt_proto_tpu_torch.ops import decode_attention as tattn
    assert tattn.q_route(torch.bfloat16, g, d, 128, n_ent) == 'split'
    assert tattn.q_route(torch.float32, g, d, 128, n_ent) == \
        tattn.rows_walk(g, d, 128, n_ent, 1)
    assert tattn.q_route(torch.bfloat16, g, d, 128, n_ent, False) == \
        tattn.rows_walk(g, d, 128, n_ent, 1)
    assert tattn.q_route(torch.bfloat16, g, 32, 128, n_ent) != 'split'
    assert tattn.q_route(torch.bfloat16, g, d, 64, n_ent) != 'split'
    e = tattn.q_split_entries(rows, n_ent)
    assert 1 <= e <= tattn.SPLIT_MAX_ENTRIES
    chunks = tattn.q_split_chunks(n_ent, e)
    assert (chunks - 1) * e < n_ent <= chunks * e     # every entry, once
    assert e == 1 or rows * chunks >= tattn.SPLIT_CTAS // 2


# The bf16-KV decode attention's kernel rule (rows_route) and the split
# walk's plan (rows_split_plan), pure Python: bf16 at the serving tiles
# takes the split kernel for any table length, f32 and the shapes off the
# rule the kernels rows_walk names; a row's chunks (one cluster) cover its
# entries once, about ROWS_CHUNK each. Cases: (G, d_head, entries,
# expected chunks x entries).
@pytest.mark.parametrize('g,d,n_ent,plan', [
    (1, 64, 3, (1, 3)),        # OPT-125M sparse
    (1, 64, 16, (3, 6)),       # OPT-125M dense, tps 4 (4 entries x 4)
    (1, 64, 17, (3, 6)),       # OPT-125M dense T=17 (B=8: 96 rows)
    (4, 128, 3, (1, 3)),       # Llama-3-8B sparse
    (4, 128, 17, (3, 6)),      # Llama-3-8B dense T=17 (B=8: 64 rows)
    (4, 128, 96, (8, 12)),     # dense T=96: past the one-pass kernel
    (8, 128, 5, (1, 5)),
    (8, 128, 401, (8, 51))])   # a row of 401 tiles, one cluster of 8
def test_rows_route_and_split_plan(g, d, n_ent, plan):
    from spt_proto_tpu_torch.ops import decode_attention as tattn
    bf, f32 = torch.bfloat16, torch.float32
    assert tattn.rows_route(bf, g, d, 128, n_ent) == 'split'
    assert tattn.rows_route(f32, g, d, 128, n_ent) == \
        tattn.rows_walk(g, d, 128, n_ent, 4)
    assert tattn.rows_route(bf, g, d, 128, n_ent, False) == \
        tattn.rows_walk(g, d, 128, n_ent, 2)
    assert tattn.rows_route(bf, g, 32, 128, n_ent) != 'split'
    assert tattn.rows_route(bf, g, d, 64, n_ent) != 'split'
    assert tattn.rows_route(bf, 9, d, 128, 3) != 'split'
    chunks, e = tattn.rows_split_plan(n_ent)
    assert (chunks, e) == plan
    assert 1 <= chunks <= tattn.ROWS_CLUSTER
    assert (chunks - 1) * e < n_ent <= chunks * e     # every entry, once


def _fake_lib(monkeypatch, module, name, record, **entries):
    """CPU tensors reported as CUDA ones, and a stand-in for the library
    whose entry `name` records its arguments (other `entries` as given)."""
    import types
    monkeypatch.setattr(module._build, 'on_cuda', lambda *ts: True)
    monkeypatch.setattr(module._build, 'lib', lambda: types.SimpleNamespace(
        **{name: lambda *a: record.append(a) or 0}, **entries))
    monkeypatch.setattr(module._build, 'stream', lambda: 0)


@pytest.mark.parametrize('dtype,d,g,t_max,aligned,walk,spill', [
    (torch.bfloat16, 64, 1, 17, True, 2, 0),
    (torch.bfloat16, 128, 4, 96, True, 2, 0),
    (torch.bfloat16, 128, 8, 401, True, 2, 51 * 8 * 132),
    (torch.bfloat16, 128, 4, 17, False, 0, 0),
    (torch.bfloat16, 128, 4, 96, False, 1, 0),
    (torch.float32, 64, 1, 17, True, 0, 0),
    (torch.float32, 128, 4, 96, True, 1, 0)])
def test_decode_attention_rows_launches_the_rule(monkeypatch, dtype, d, g,
                                                 t_max, aligned, walk,
                                                 spill):
    """decode_attention_rows hands the library the kernel rows_route names
    (walk 2: the split walk, with rows_split_plan's chunks and entries,
    a global score buffer of B x KV x chunks rows only where the library's
    spt_rows_split_scores asks for one, and split_writer's chunks or the
    caller's), one launch a call; an unaligned bf16 cache takes the
    kernels rows_walk names."""
    from spt_proto_tpu_torch.ops import decode_attention as tattn
    calls, asked = [], []
    _fake_lib(monkeypatch, tattn, 'spt_decode_attention', calls,
              spt_rows_split_scores=lambda *a: asked.append(a) or spill)
    tattn.rows_split_scores.cache_clear()
    b, kv, ps = 1, 1, 128
    q = torch.zeros((b, kv, g, d), dtype=dtype)
    flat = torch.zeros(t_max * d * ps + 8, dtype=dtype)
    k = (flat[:t_max * d * ps] if aligned else flat[1:1 + t_max * d * ps])
    k = k.view(b, kv, t_max, d, ps)
    codes = torch.zeros((b, kv, t_max, 1, ps), dtype=torch.int32)
    tables = torch.arange(t_max, dtype=torch.int32)[None, None]
    ints = torch.zeros((b,), dtype=torch.int32)
    given = torch.zeros((b, 1), dtype=torch.int64)     # the engine's
    tattn.decode_attention_rows.launches = 0
    for writer_in in (None, given):
        tattn.decode_attention_rows(
            q, k, k, codes, tables, ints + t_max, ints,
            torch.zeros((b, kv, d), dtype=dtype),
            torch.zeros((b, kv, d), dtype=dtype),
            torch.zeros((b, kv, 1), dtype=torch.int32), writer=writer_in)
    assert tattn.decode_attention_rows.launches == 2
    tattn.decode_attention_rows.launches = 0
    tattn.rows_split_scores.cache_clear()
    args, args_given = calls
    assert args[1] == walk
    e, chunks, scores, writer = args[-5], args[-4], args[-3], args[-2]
    if walk == 2:
        assert (chunks, e) == tattn.rows_split_plan(t_max)
        assert asked == [(e, g, d, 1)]
        assert (scores is not None) == (spill > 0)
        # the appending chunk, [B, 1], or the one the caller names
        assert writer is not None and args_given[-2] == given.data_ptr()
    else:
        assert e == chunks == 0 and scores is None and not asked
        assert writer is None and args_given[-2] is None


def _writer_loop(row, n_t, wt, tps, e):
    """The split walks' append rule as a loop over one table row: the
    chunk of the first valid entry j = t * tps + u on the write tile."""
    for j in range(len(row) * tps):
        t, u = divmod(j, tps)
        if row[t] >= 0 and t < n_t and row[t] + u == wt:
            return j // e
    return 0


# The split walks' writer chunk (split_writer), pure Python: the chunk of
# the row's first valid entry on the write tile, chunk 0 when none covers
# it. Cases: (rows of a table, n_tiles, pos, tile_base, tps, entries a
# chunk, expected writers).
@pytest.mark.parametrize('rows,n_t,pos,base,tps,e,want', [
    ([[16, 3, 5]], 3, 16 * 128 + 7, 0, 1, 3, [0]),      # chunk 0
    ([[0, 1, 2, 3, 4, 5, 6, 7]], 8, 6 * 128, 0, 1, 3, [2]),   # later
    ([[0, 1, 2, 3]], 4, 9 * 128, 0, 1, 2, [0]),         # no entry covers
    ([[-1, 2, -1, 9]], 4, 9 * 128 + 3, 0, 1, 1, [3]),   # behind -1
    ([[3, 9, 9]], 1, 9 * 128, 0, 1, 1, [0]),            # past n_tiles
    ([[0, 4, 8, 12]], 4, 9 * 128 + 1, 0, 4, 6, [1]),    # supertiles
    ([[-1, 4, 8, 12]], 4, 2 * 128 + 1, 0, 4, 1, [0]),   # -1 supertile
    ([[1, 5], [5, 1]], 2, 5 * 128, 20, 1, 1, [0, 0]),   # write tile 25
    ([[21, 25], [25, 21]], 2, 5 * 128, 20, 1, 1, [1, 0])])
def test_split_writer(rows, n_t, pos, base, tps, e, want):
    """split_writer names the chunk the append rule names for each row
    (held to the rule written as a loop), for the int8-KV and bf16-KV split
    walks, on any device and without a host sync."""
    from spt_proto_tpu_torch.ops import decode_attention as tattn
    tables = torch.tensor([rows], dtype=torch.int32)
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    got = tattn.split_writer(tables, i32([n_t]), i32([pos]), i32([base]),
                             ps=128, tps=tps, e=e)
    wt = base + pos // 128
    assert got.tolist() == [want]
    assert want == [_writer_loop(r, n_t, wt, tps, e) for r in rows]


# The verify split walk's writer chunk (verify_writer), pure Python: the
# chunk that holds the row's first valid entry on a tile the block's
# columns land in, held to that rule written as a loop over the engine's
# own tables (_Block): union and dense, blocks inside one tile and across a
# tile boundary (two write tiles; a first write entry that repeats the
# second carries sel_mask 0). Cases: (block positions of the slots, K,
# tiles a layer, sparse, d_head, entries a chunk the plan aims at).
@pytest.mark.parametrize('pos,kk,nt,sparse,d,chunk', [
    ([2046, 2000, 1000, 127], 5, 18, True, 64, 3),   # across 2048, union
    ([2046, 2000, 1000, 127], 5, 18, False, 128, 4),  # dense T = 20
    ([2047, 130, 255, 3], 30, 18, True, 128, 2),     # K = 30
    ([12286, 300, 128, 129], 5, 97, False, 64, 3),   # dense T = 99
    ([256, 511, 700, 1023], 1, 9, True, 128, 1)])    # K = 1
def test_verify_writer(monkeypatch, pos, kk, nt, sparse, d, chunk):
    """verify_writer names the chunk of the row's first valid entry on a
    landing tile for every row of the engine's tables, and
    verify_split_plan keeps the two write entries in that chunk."""
    from spt_proto_tpu_torch.inference.engine import _Block
    from spt_proto_tpu_torch.ops import decode_attention as tattn
    monkeypatch.setitem(tattn.VERIFY_CHUNK, d, chunk)
    tattn.verify_split_plan.cache_clear()
    kv, base, ps = 2, nt, 128
    pos_t = torch.tensor(pos, dtype=torch.int32)
    nsel = min(nt, max(1, nt // 8) + 1)
    keep = None
    if sparse:
        g = torch.Generator().manual_seed(len(pos) + kk)
        ar = torch.arange(nt)
        own = (pos_t.long()[:, None] + torch.arange(kk)) // ps
        r = torch.rand((len(pos), kv, kk, nt), generator=g)
        r = r.masked_fill(ar >= own[:, None, :, None], 2.0)
        keep = torch.zeros(r.shape, dtype=torch.bool)
        keep.scatter_(-1, r.argsort(-1)[..., :nsel - 1], True)
        keep |= ar == own[:, None, :, None]
    tables, bits = _Block(pos_t, kk, nt, kv, nsel).tables(keep, base)
    t_max = tables.shape[2]
    _, _, chunks, e = tattn.verify_split_plan(kk, t_max, d)
    tattn.verify_split_plan.cache_clear()
    writer = tattn.verify_writer(t_max, e)
    assert (t_max - 2) // e == (t_max - 1) // e == writer == chunks - 1
    n_all = 2 * nt
    for bi, p in enumerate(pos):
        lands = {base + (p + j) // ps for j in range(kk)}
        for h in range(kv):
            row, rb = tables[bi, h].tolist(), bits[bi, h].tolist()
            lands_h = lands & {max(row[-2], 0), max(row[-1], 0)}
            first = next(j for j, t in enumerate(row)
                         if 0 <= t < n_all and rb[j] and t in lands_h)
            assert first // e == writer


# The paged split walk's rule and plan (paged_route, paged_split_plan),
# pure Python: bf16 takes the split kernel, f32 the walk; a slot's chunks
# (one cluster) cover its positions once in steps of 64, about 8 steps a
# chunk over bf16 pages and 4 over int8 ones. Cases: (pages a slot, page
# size, int8 pages, expected chunks x steps).
@pytest.mark.parametrize('pps,ps,quant,plan', [
    (34, 64, False, (5, 7)),      # the serving shape: 2,176 positions
    (34, 64, True, (7, 5)),
    (136, 16, False, (5, 7)),
    (17, 128, True, (7, 5)),
    (1, 16, False, (1, 1)),
    (2, 64, True, (1, 2)),
    (256, 64, False, (8, 32)),    # 16,384 positions
    (384, 128, True, (8, 96))])   # 49,152 positions
def test_paged_route_and_split_plan(pps, ps, quant, plan):
    from spt_proto_tpu_torch.ops import paged_attention as tpa
    assert tpa.paged_route(torch.bfloat16) == 'split'
    assert tpa.paged_route(torch.float32) == 'walk'
    chunks, steps = tpa.paged_split_plan(pps, ps, quant)
    assert (chunks, steps) == plan
    n_steps = -(-pps * ps // tpa.PAGED_STEP)
    assert 1 <= chunks <= tpa.PAGED_CLUSTER
    assert (chunks - 1) * steps < n_steps <= chunks * steps


# The verify split walk's rule and plan (verify_route, verify_split_plan):
# bf16 at 128-token tiles, d_head 64 / 128, G <= 8, K <= 30 and aligned
# caches; the rows in equal groups of at most VERIFY_ROWS, a row's entries
# in one cluster of chunks covering them once. Cases: (G, K, d_head,
# entries, expected (groups, rows, chunks, entries a chunk)).
@pytest.mark.parametrize('g,kk,d,t_max,plan', [
    (1, 5, 64, 12, (1, 5, 4, 3)),         # OPT-125M n-gram union
    (1, 5, 64, 20, (1, 5, 7, 3)),         # OPT-125M dense T=20
    (4, 5, 128, 12, (1, 20, 3, 4)),       # Llama-3-8B union
    (4, 5, 128, 20, (1, 20, 5, 4)),       # dense T=20
    (4, 30, 128, 20, (2, 60, 5, 4)),      # K = 30 at G = 4
    (8, 30, 128, 20, (4, 60, 5, 4)),      # K = 30 at G = 8: 240 rows
    (8, 1, 64, 99, (1, 8, 8, 13)),        # dense T = 96 + 3
    (4, 5, 64, 13, (1, 20, 3, 5)),        # 3 x 4 would leave 1 entry
    (4, 5, 128, 17, (1, 20, 4, 5)),       # 5 x 4 would leave 1 entry
    (1, 1, 128, 2, (1, 1, 1, 2))])
def test_verify_route_and_split_plan(g, kk, d, t_max, plan):
    from spt_proto_tpu_torch.ops import decode_attention as tattn
    bf, f32 = torch.bfloat16, torch.float32
    assert tattn.verify_route(bf, g, d, 128, kk) == 'split'
    assert tattn.verify_route(f32, g, d, 128, kk) == 'walk'
    assert tattn.verify_route(bf, g, d, 128, kk, False) == 'walk'
    assert tattn.verify_route(bf, g, d, 64, kk) == 'walk'
    assert tattn.verify_route(bf, g, 80, 128, kk) == 'walk'
    assert tattn.verify_route(bf, 9, d, 128, kk) == 'walk'
    groups, rows, chunks, e = tattn.verify_split_plan(g * kk, t_max, d)
    assert (groups, rows, chunks, e) == plan
    assert rows <= tattn.VERIFY_ROWS and (groups - 1) * rows < g * kk \
        <= groups * rows
    assert chunks <= tattn.VERIFY_CLUSTER
    assert (chunks - 1) * e < t_max <= chunks * e


@pytest.mark.parametrize('dtype,quant,ps,d,g,spill', [
    (torch.bfloat16, False, 64, 64, 1, 0),
    (torch.bfloat16, True, 128, 128, 8, 8 * 6148),
    (torch.float32, False, 64, 128, 4, 0),
    (torch.float32, True, 16, 64, 1, 0)])
def test_paged_attention_launches_the_rule(monkeypatch, dtype, quant, ps, d,
                                           g, spill):
    """paged_attention hands the library the kernel paged_route names (bf16:
    the split walk, with paged_split_plan's steps and chunks and a global
    score buffer of B x KV x chunks rows only where the library's
    spt_paged_split_scores asks for one; f32: the walk), one launch a
    call."""
    from spt_proto_tpu_torch.ops import paged_attention as tpa
    calls, asked = [], []
    _fake_lib(monkeypatch, tpa, 'spt_paged_attention', calls,
              spt_paged_split_scores=lambda *a: asked.append(a) or spill)
    tpa.paged_split_scores.cache_clear()
    b, kv, pps = 2, 1, 3
    kt = torch.int8 if quant else dtype
    pages = torch.zeros((kv, b * pps, ps, d), dtype=kt)
    sc = (dict(k_scales=torch.ones((kv, b * pps, ps, 1)),
               v_scales=torch.ones((kv, b * pps, ps, 1))) if quant else {})
    tpa.paged_attention.launches = 0
    tpa.paged_attention(torch.zeros((b, kv * g, d), dtype=dtype), pages,
                        pages, torch.tensor([1, ps * pps]),
                        torch.arange(b * pps).reshape(b, pps), scale=0.1,
                        **sc)
    assert tpa.paged_attention.launches == 1
    tpa.paged_attention.launches = 0
    tpa.paged_split_scores.cache_clear()
    (args,) = calls
    assert args[1] == int(quant)
    steps, chunks, scores = args[-4], args[-3], args[-2]
    if dtype == torch.bfloat16:
        assert (chunks, steps) == tpa.paged_split_plan(pps, ps, quant)
        assert asked == [(steps, g, d, ps, int(quant))]
        assert (scores is not None) == (spill > 0)
    else:
        assert steps == chunks == 0 and scores is None and not asked


@pytest.mark.parametrize('dtype,g,kk,d,ps,split', [
    (torch.bfloat16, 1, 5, 64, 128, 1),
    (torch.bfloat16, 8, 30, 128, 128, 1),
    (torch.bfloat16, 4, 5, 128, 64, 0),
    (torch.float32, 4, 5, 128, 128, 0)])
def test_verify_attention_rows_launches_the_rule(monkeypatch, dtype, g, kk,
                                                 d, ps, split):
    """verify_attention_rows hands the library the kernel verify_route
    names: the split walk with verify_split_plan's rows, entries and chunks
    and verify_writer's chunk, or the walk kernel with
    verify_rows_per_cta's rows; one launch a call."""
    from spt_proto_tpu_torch.ops import decode_attention as tattn
    calls = []
    _fake_lib(monkeypatch, tattn, 'spt_verify_attention', calls,
              spt_verify_split_scores=lambda *a: 0)
    tattn.verify_split_scores.cache_clear()
    b, kv, t_max = 1, 2, 4
    q = torch.zeros((b, kv, g * kk, d), dtype=dtype)
    k = torch.zeros((b, kv, 4, d, ps), dtype=dtype)
    tables = torch.tensor([[[0, 1, 2, 2]] * kv], dtype=torch.int32)
    tattn.verify_attention_rows.launches = 0
    tattn.verify_attention_rows(
        q, k, k.clone(), torch.zeros((b, kv, 4, 1, ps), dtype=torch.int32),
        tables, torch.ones_like(tables), torch.tensor([2 * ps - 1]),
        torch.zeros((b, kv, d, kk), dtype=dtype),
        torch.zeros((b, kv, d, kk), dtype=dtype),
        torch.zeros((b, kv, 1, kk), dtype=torch.int32), ps=ps)
    assert tattn.verify_attention_rows.launches == 1
    tattn.verify_attention_rows.launches = 0
    tattn.verify_split_scores.cache_clear()
    (args,) = calls
    assert args[1] == split
    rows, e, chunks, scores, writer = args[-6:-1]
    if split:
        assert (rows, chunks, e) == tattn.verify_split_plan(g * kk, t_max,
                                                            d)[1:]
        assert scores is None and writer == tattn.verify_writer(t_max, e)
    else:
        assert rows == tattn.verify_rows_per_cta(g * kk, d, ps, t_max,
                                                 q.element_size())
        assert e == chunks == writer == 0


@pytest.mark.parametrize('dtype,d,block_q,aligned,route', [
    (torch.bfloat16, 64, 256, True, 'tc'),      # OPT prefill
    (torch.bfloat16, 128, 256, True, 'tc'),     # LLaMA prefill
    (torch.bfloat16, 64, 128, True, 'tc'),      # training, short prompts
    (torch.bfloat16, 128, 128, False, 'cuda_core'),
    (torch.bfloat16, 64, 64, True, 'cuda_core'),
    (torch.float32, 64, 256, True, 'cuda_core'),
    (torch.float32, 128, 128, True, 'cuda_core')])
def test_block_sparse_forward_route(monkeypatch, dtype, d, block_q, aligned,
                                    route):
    """Which forward a block_sparse_attention(_lse) call takes (fwd_route):
    the tensor-core kernel for bf16 at d_head 64 / 128, block_k 128, a
    block_q multiple of 128 and aligned q/k/v; the CUDA-core kernel else.
    Both wrappers hand the library the rule's pick, one launch a call."""
    assert tbsa.fwd_route(dtype, d, block_q, 128, aligned) == route
    assert tbsa.fwd_route(dtype, d, block_q, 64, aligned) == 'cuda_core'
    calls = []
    _fake_lib(monkeypatch, tbsa, 'spt_block_sparse_fwd', calls)
    s = 256
    flat = torch.zeros(3 * s * d + 8, dtype=dtype)
    off = 0 if aligned else 1
    q, k, v = (flat[off + i * s * d:off + (i + 1) * s * d].view(1, s, d)
               for i in range(3))
    sel = torch.zeros((1, s // block_q, 2), dtype=torch.int32)
    kw = dict(block_q=block_q, block_k=128, scale=0.1)
    tbsa.block_sparse_attention.launches = 0
    tbsa.block_sparse_attention_lse.launches = 0
    tbsa.block_sparse_attention(q, k, v, sel, **kw)
    tbsa.block_sparse_attention_lse(q, k, v, sel, **kw)
    assert tbsa.block_sparse_attention.launches == 1
    assert tbsa.block_sparse_attention_lse.launches == 1
    tbsa.block_sparse_attention.launches = 0
    tbsa.block_sparse_attention_lse.launches = 0
    assert [a[1] for a in calls] == [
        tbsa.FWD_WARPS[d] if route == 'tc' else 0] * 2
    assert calls[0][7] is None and calls[1][7] is not None     # lse


@pytest.mark.parametrize('dtype,d,block_q,aligned,route', [
    (torch.bfloat16, 64, 256, True, 'tc'),      # OPT training
    (torch.bfloat16, 128, 256, True, 'tc'),     # LLaMA training
    (torch.bfloat16, 64, 128, True, 'tc'),
    (torch.bfloat16, 128, 128, False, 'cuda_core'),
    (torch.bfloat16, 64, 64, True, 'cuda_core'),
    (torch.bfloat16, 96, 256, True, 'cuda_core'),
    (torch.float32, 64, 256, True, 'cuda_core'),
    (torch.float32, 128, 128, True, 'cuda_core')])
def test_block_sparse_backward_route(dtype, d, block_q, aligned, route):
    """Which pair a backward launch takes (bwd_route): the tensor-core dq
    and dk/dv kernels for bf16 at d_head 64 / 128, block_k 128, a block_q
    multiple of 128 and aligned operands; the CUDA-core pair else. The
    library holds a tensor-core instance for each d_head's plan."""
    assert tbsa.bwd_route(dtype, d, block_q, 128, aligned) == route
    assert tbsa.bwd_route(dtype, d, block_q, 64, aligned) == 'cuda_core'
    if route == 'tc':
        assert tbsa.BWD_DQ_KEYS[d] in ((32, 64) if d == 64 else (32,))
        assert tbsa.BWD_DKV_ROWS[d] in ((16, 32, 64) if d == 64
                                        else (16, 32))


@pytest.mark.parametrize('dtype,d,block_q,aligned,route', [
    (torch.bfloat16, 64, 256, True, 'tc'),
    (torch.bfloat16, 128, 128, True, 'tc'),
    (torch.bfloat16, 64, 128, False, 'cuda_core'),
    (torch.bfloat16, 128, 64, True, 'cuda_core'),
    (torch.float32, 64, 256, True, 'cuda_core')])
def test_block_sparse_backward_launches_the_route(monkeypatch, dtype, d,
                                                  block_q, aligned, route):
    """block_sparse_attention_bwd hands the library bwd_route's pick (the
    tensor-core plan, BWD_DQ_KEYS / BWD_DKV_ROWS, or 0 and 0 for the
    CUDA-core pair): one dq launch, then one dk/dv launch over the reverse
    table, each counted once a call."""
    calls = []
    _fake_lib(monkeypatch, tbsa, 'spt_block_sparse_bwd', calls)
    s = 256
    flat = torch.zeros(4 * s * d + 8, dtype=dtype)
    off = 0 if aligned else 1
    q, k, v, o = (flat[off + i * s * d:off + (i + 1) * s * d].view(1, s, d)
                  for i in range(4))
    sel = torch.zeros((1, s // block_q, 2), dtype=torch.int32)
    lse = torch.zeros((1, s), dtype=torch.float32)
    g = torch.zeros((1, s, d), dtype=dtype)
    tbsa.block_sparse_attention_dq.launches = 0
    tbsa.block_sparse_attention_dkv.launches = 0
    tbsa.block_sparse_attention_bwd(q, k, v, sel, o, lse, g, block_q=block_q,
                                    block_k=128, scale=0.1)
    assert tbsa.block_sparse_attention_dq.launches == 1
    assert tbsa.block_sparse_attention_dkv.launches == 1
    tbsa.block_sparse_attention_dq.launches = 0
    tbsa.block_sparse_attention_dkv.launches = 0
    plan = ((tbsa.BWD_DQ_KEYS[d], tbsa.BWD_DKV_ROWS[d]) if route == 'tc'
            else (0, 0))
    assert [a[1:3] for a in calls] == [plan] * 2
    # dq first (rsel, dk, dv null), then dk/dv (dq null)
    assert calls[0][10] is None and calls[0][11] is not None
    assert calls[0][12] is None and calls[0][13] is None
    assert calls[1][10] is not None and calls[1][11] is None
    assert calls[1][12] is not None and calls[1][13] is not None
