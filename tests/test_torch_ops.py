"""PyTorch port vs the JAX package: PQ math, tile selection, the per-row
oracle, block-sparse attention, the greedy lm_head and the fused FFN tail,
on the CPU.

Inputs come from numpy seeds and go through both packages. The JAX Pallas
kernels run in interpret mode (as the JAX package's own tests run them);
the port's wrappers, handed CPU tensors, run their plain twins.
"""
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
    ts_j = np.asarray(jbs.pq_tile_scores(jnp.asarray(qc), jnp.asarray(kc),
                                         **kw))
    ts_t = tbs.pq_tile_scores(t(qc), t(kc), **kw)
    np.testing.assert_array_equal(ts_t.numpy(), ts_j)
    ratio = block_q // 128
    sel_j = np.asarray(jbs.select_tiles(jnp.asarray(ts_j), n_sel, ratio))
    sel_t = tbs.select_tiles(ts_t, n_sel, ratio).numpy()
    np.testing.assert_array_equal(sel_t, sel_j)
    assert (sel_t < 0).any()
    # planted ties: every causal off-diagonal tile scores the same
    flat = np.zeros_like(ts_j)
    sel_j = np.asarray(jbs.select_tiles(jnp.asarray(flat), n_sel, ratio))
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
    idx_j = np.asarray(jlookup.pq_topk_indices(
        jnp.asarray(qc), jnp.asarray(kc), top_k=37, n_codewords=4))
    idx_t = tlookup.pq_topk_indices(t(qc), t(kc), top_k=37, n_codewords=4)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    q, k, v = (rng.randn(4, s, 64).astype(np.float32) for _ in range(3))
    o_j = jsa.sparse_attention(jnp.asarray(q * 4), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(idx_j),
                               scale=0.125, clamp=10.0)
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
    ts = jbs.pq_tile_scores(jnp.asarray(qc), jnp.asarray(kc), n_codewords=16,
                            block_q=block_q, block_k=128)
    sel = np.asarray(jbs.select_tiles(ts, n_sel, block_q // 128))
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
