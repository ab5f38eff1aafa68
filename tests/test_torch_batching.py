"""PyTorch port vs the JAX package: chunked prefill and the continuous
batching engine on the CPU.

prefill_chunk against JAX's (dense and sparse, f32 and int8 KV: chunk
logits and cache) and against one-shot prefill; the native scheduler and
page pool through the port's own ctypes binding; and
ContinuousBatchingEngine in every mode, each held to what the JAX test of
the same mode (tests/test_batching.py, tests/test_prefix_cache.py) holds
JAX's engine to: JAX's greedy generate() token for token, or the same
engine without the feature. The port's own generate() must agree too. Tiny
f32 models (tiny_config); weights from the port's seeded init_params,
handed to both packages as numpy; prompts from numpy seeds.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu.config import tiny_config
from spt_proto_tpu.inference import engine as jeng
from spt_proto_tpu.inference.weights import InferenceWeights as JIW
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference import engine as teng
from spt_proto_tpu_torch.inference.batching import (ContinuousBatchingEngine,
                                                    native_scheduler_lib)
from spt_proto_tpu_torch.inference.paged import PageAllocator
from spt_proto_tpu_torch.inference.weights import InferenceWeights as TIW
from test_torch_engine import port_config

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)

TILE = teng.TILE
SPARSE = dict(attention='sparse_v2', d_codeword=4, n_codewords=8)


def t(a):
    return torch.from_numpy(np.array(a))


def _weights(max_length=512, **kw):
    """(JAX weights, port weights) of a tiny f32 OPT model."""
    cfg = tiny_config('opt', max_length=max_length, **kw).replace(
        dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.numpy(), bridge.init_params(
        port_config(cfg), 0, device='cpu'))
    j_iw = JIW.from_params(cfg, jax.tree.map(jnp.asarray, params),
                           dtype=jnp.float32)
    t_iw = TIW.from_params(port_config(cfg),
                           bridge.params_from_numpy(params, device='cpu'))
    return j_iw, t_iw


def _references(j_iw, t_iw, prompts, n, max_len):
    """Each prompt's greedy continuation from JAX's generate(), checked
    against the port's generate() on the way."""
    out = []
    for p in prompts:
        j = np.asarray(jeng.generate(j_iw, jnp.asarray([p], jnp.int32), n,
                                     max_len=max_len))[0, len(p):]
        got = teng.generate(t_iw, t([p]), n, max_len=max_len)[0, len(p):]
        np.testing.assert_array_equal(got.numpy(), j)
        out.append(list(j))
    return out


def _serve(iw, prompts, n, **kw):
    """Run every prompt through an engine; returns (completions in prompt
    order, engine)."""
    eng = ContinuousBatchingEngine(iw, **kw)
    rids = [eng.submit(p, max_new_tokens=n) for p in prompts]
    done = {c.request_id: c.tokens for c in eng.run_until_done()}
    assert set(done) == set(rids)
    return [done[r] for r in rids], eng


# ---------------------------------------------------------------------------
# the native scheduler and page pool
# ---------------------------------------------------------------------------

def test_native_scheduler_lifecycle():
    lib = native_scheduler_lib()
    s = lib.sched_create(2, 32)
    try:
        ids = [lib.sched_submit(s, 4, 4) for _ in range(3)]
        assert all(i > 0 for i in ids)
        slots = (ctypes.c_int32 * 2)()
        rids = (ctypes.c_int64 * 2)()
        assert lib.sched_admit(s, slots, rids) == 2
        assert lib.sched_queue_depth(s) == 1
        mask = (ctypes.c_int8 * 2)()
        assert lib.sched_decode_mask(s, mask) == 0    # not before prefill
        lib.sched_prefill_done(s, 0)
        lib.sched_prefill_done(s, 1)
        assert lib.sched_decode_mask(s, mask) == 2
        done = 0
        for _ in range(4):
            done = lib.sched_token_decoded(s, 0, 0)
        assert done == 1                               # max_new_tokens
        assert lib.sched_admit(s, slots, rids) == 1 and int(slots[0]) == 0
        assert lib.sched_queue_depth(s) == 0
        assert lib.sched_token_decoded(s, 1, 1) == 1   # eos ends early
        assert lib.sched_num_active(s) == 1
    finally:
        lib.sched_destroy(s)


def test_oversized_requests_rejected():
    lib = native_scheduler_lib()
    s = lib.sched_create(1, 16)
    try:
        assert lib.sched_submit(s, 10, 10) == -1
        assert lib.sched_submit(s, 0, 4) == -1
    finally:
        lib.sched_destroy(s)
    _, iw = _weights(max_length=128)
    eng = ContinuousBatchingEngine(iw, n_slots=1, max_len=64,
                                   prefill_bucket=8, paged=True,
                                   page_size=8, n_pages=2)
    with pytest.raises(ValueError, match='pages'):
        eng.submit([1] * 10, max_new_tokens=20)     # 30 tokens > 16 slots
    eng = ContinuousBatchingEngine(iw, n_slots=1, max_len=16)
    with pytest.raises(ValueError, match='max_len'):
        eng.submit([1] * 10, max_new_tokens=10)


def test_page_allocator():
    alloc = PageAllocator(n_pages=8, n_slots=2)
    assert alloc.free_count == 8
    assert alloc.ensure(0, tokens=5, page_size=4) == 2      # lazy growth
    assert alloc.free_count == 6
    assert alloc.ensure(0, tokens=8, page_size=4) == 0
    tab = alloc.table(0, 4)
    assert (tab[:2] >= 0).all() and (tab[2:] == -1).all()
    assert len(set(tab[:2])) == 2
    assert alloc.ensure(1, tokens=24, page_size=4) == 6
    with pytest.raises(MemoryError):                         # rolls back
        alloc.ensure(0, tokens=100, page_size=4)
    assert alloc.free_count == 0
    alloc.release(1)
    assert alloc.free_count == 6
    assert (alloc.table(1, 4) == -1).all()


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('sparse', [False, True])
@pytest.mark.parametrize('quantized', [False, True])
def test_prefill_chunk_matches_jax(sparse, quantized):
    """One chunk of 128 tokens at offset 128 of slot 1, over a cache both
    sides start from (JAX's prefill of the first 128 tokens into a 2-slot
    cache of 384): the chunk logits to 1e-4 and the cache after it (codes
    and lengths equal; f32 K/V to 1e-5; int8 within one step in < 1e-3 of
    the entries, and the scales to 1e-5 relative, as XLA and torch sum the
    projections in different orders)."""
    j_iw, t_iw = _weights(**(SPARSE if sparse else {}))
    rs = np.random.RandomState(4)
    tokens = rs.randint(1, 256, size=(2, 2 * TILE)).astype(np.int32)
    jc = jeng.KVCache.create(j_iw.cfg, 2, 3 * TILE, dtype=jnp.float32,
                             quantized=quantized)
    _, jc = jax.jit(jeng.prefill)(j_iw, jnp.asarray(tokens[:, :TILE]), jc)
    tc = teng.KVCache(**{f: None if getattr(jc, f) is None
                         else t(np.asarray(getattr(jc, f)))
                         for f in ('k', 'v', 'codes', 'length', 'k_scale',
                                   'v_scale')})
    chunk = tokens[1:, TILE:]
    j_logits, jc = jax.jit(jeng.prefill_chunk, static_argnums=4)(
        j_iw, jnp.asarray(chunk), jc, jnp.int32(1), TILE)
    t_logits, tc = teng.prefill_chunk(t_iw, t(chunk), tc, 1, TILE)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=0)
    for name in ('codes', 'length'):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    assert tc.length.tolist() == [TILE, 2 * TILE]
    for name in ('k', 'v'):
        got = getattr(tc, name).numpy().astype(np.float32)
        want = np.asarray(getattr(jc, name)).astype(np.float32)
        if quantized:
            assert np.abs(got - want).max() <= 1, name
            assert (got != want).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=name)
    if quantized:
        for name in ('k_scale', 'v_scale'):
            np.testing.assert_allclose(getattr(tc, name).numpy(),
                                       np.asarray(getattr(jc, name)),
                                       rtol=1e-5, atol=0, err_msg=name)


def test_prefill_chunk_matches_one_shot_prefill():
    """Dense: two chunks of 128 equal one-shot prefill of 256 tokens in
    logits (1e-4) and cache (1e-5), as JAX's engine contracts."""
    _, iw = _weights()
    tokens = t(np.random.RandomState(5).randint(1, 256, size=(1, 2 * TILE)))
    one = teng.KVCache.create(iw.cfg, 1, 2 * TILE, dtype=torch.float32,
                              device='cpu')
    want, one = teng.prefill(iw, tokens, one)
    two = teng.KVCache.create(iw.cfg, 1, 2 * TILE, dtype=torch.float32,
                              device='cpu')
    lg0, two = teng.prefill_chunk(iw, tokens[:, :TILE], two, 0, 0)
    lg1, two = teng.prefill_chunk(iw, tokens[:, TILE:], two, 0, TILE)
    np.testing.assert_allclose(torch.cat([lg0, lg1], 1).numpy(),
                               want.numpy(), atol=1e-4, rtol=0)
    for name in ('k', 'v', 'codes'):
        np.testing.assert_allclose(getattr(two, name).numpy(),
                                   getattr(one, name).numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert two.length.tolist() == [2 * TILE]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def short():
    """The tiny OPT model, five short prompts and JAX's greedy
    continuations of 8 tokens at max_len 64."""
    j_iw, t_iw = _weights(max_length=128)
    rs = np.random.RandomState(0)
    prompts = [list(map(int, rs.randint(1, 256, size=n)))
               for n in (5, 9, 3, 7, 6)]
    return t_iw, prompts, _references(j_iw, t_iw, prompts, 8, 64)


def test_engine_more_requests_than_slots_matches_generate(short):
    iw, prompts, want = short
    got, _ = _serve(iw, prompts, 8, n_slots=2, max_len=64,
                    prefill_bucket=16)
    assert got == want


def test_paged_engine_matches_generate(short):
    iw, prompts, want = short
    got, eng = _serve(iw, prompts, 8, n_slots=2, max_len=64,
                      prefill_bucket=16, paged=True, page_size=16)
    assert got == want
    assert eng.alloc.free_count == eng.alloc.n_pages   # all released


def test_paged_tiny_pool_admission_and_preemption(short):
    """6 pages of 8 tokens for 4 slots of up to 17 tokens: admission waits
    for pages, tables grow lazily, and pool exhaustion preempts the
    youngest request (recomputed later); every completion still equals
    generate()."""
    iw, prompts, want = short
    got, eng = _serve(iw, prompts, 8, n_slots=4, max_len=64,
                      prefill_bucket=8, paged=True, page_size=8, n_pages=6)
    assert got == want
    assert eng.n_preemptions >= 1
    assert eng.alloc.free_count == 6
    assert (eng.cache.page_indices == -1).all()


def test_paged_sparse_engine_matches_generate():
    """PQ-sparse served paged: at sparse_coeff 1 every page is selected, so
    completions equal unpaged generate()."""
    j_iw, t_iw = _weights(max_length=128, sparse_coeff=1, **SPARSE)
    rs = np.random.RandomState(5)
    prompts = [list(map(int, rs.randint(1, 256, size=n))) for n in (9, 6, 4)]
    want = _references(j_iw, t_iw, prompts, 5, 32)
    got, _ = _serve(t_iw, prompts, 5, n_slots=2, max_len=32,
                    prefill_bucket=8, paged=True, page_size=8, n_pages=8)
    assert got == want


@pytest.fixture(scope='module')
def long():
    """The tiny OPT model at max_length 512, JAX's greedy continuations of
    three prompts (300, 140 and 5 tokens: three chunks, two, none) and of
    three prompts that share a 128-token prefix."""
    j_iw, t_iw = _weights()
    rs = np.random.RandomState(7)
    chunked = [list(map(int, rs.randint(1, 256, size=n)))
               for n in (300, 140, 5)]
    shared = list(map(int, rs.randint(1, 256, size=TILE)))
    prefixed = [shared + list(map(int, rs.randint(1, 256, size=n)))
                for n in (9, 17, 4)]
    return (t_iw, chunked, _references(j_iw, t_iw, chunked, 4, 448), shared,
            prefixed, _references(j_iw, t_iw, prefixed, 5, 384))


def test_chunked_prefill_matches_generate(long):
    iw, prompts, want = long[:3]
    got, _ = _serve(iw, prompts, 4, n_slots=2, max_len=448,
                    prefill_bucket=16, prefill_chunk=128)
    assert got == want


def test_chunked_prefill_bounds_step_work_and_interleaves(long):
    """A long admission does not stall the decode batch: a step prefills at
    most one chunk plus one short prompt, and a short request admitted
    beside the 300-token prompt completes while that one is still
    chunking."""
    iw, prompts = long[:2]
    eng = ContinuousBatchingEngine(iw, n_slots=2, max_len=448,
                                   prefill_bucket=16, prefill_chunk=128)
    eng.submit(prompts[0], max_new_tokens=2)
    eng.submit(prompts[2], max_new_tokens=2)
    short_done_while_chunking, max_prefill, steps = False, 0, 0
    while (eng.num_active or eng.queue_depth) and steps < 100:
        eng.step()
        steps += 1
        max_prefill = max(max_prefill, eng.last_step_prefill_tokens)
        short_done_while_chunking |= bool(eng.completions and eng._chunking)
    assert len(eng.run_until_done()) == 2
    assert short_done_while_chunking
    assert max_prefill <= 128 + 16, max_prefill


def test_pinned_prefix_matches_generate(long):
    iw, shared, prompts, want = long[0], *long[3:]
    eng = ContinuousBatchingEngine(iw, n_slots=2, max_len=384,
                                   prefill_bucket=16, prefix_cache=True)
    assert eng.cache_prefix(shared) == TILE
    rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    done = {c.request_id: c.tokens for c in eng.run_until_done()}
    assert [done[r] for r in rids] == want
    assert eng.prefix_hits == 3 and eng.prefix_tokens_reused == 3 * TILE


def test_automatic_prefix_insertion_and_reuse(long):
    """The first request's TILE-aligned head is stored by itself; a later
    request sharing it prefills only its tail (through prefill_chunk)."""
    iw, shared, prompts, want = long[0], *long[3:]
    eng = ContinuousBatchingEngine(iw, n_slots=2, max_len=384,
                                   prefill_bucket=16, prefix_cache=True)
    got = []
    for p in prompts[:2]:
        rid = eng.submit(p, max_new_tokens=5)
        got.append({c.request_id: c.tokens
                    for c in eng.run_until_done()}[rid])
    assert got == want[:2]
    assert len(eng._prefix_store) == 1
    assert eng.prefix_hits == 1 and eng.prefix_tokens_reused == TILE


def test_prefix_cache_lru_eviction():
    _, iw = _weights()
    rs = np.random.RandomState(13)
    eng = ContinuousBatchingEngine(iw, n_slots=1, max_len=384,
                                   prefill_bucket=16, prefix_cache=True,
                                   prefix_cache_entries=2)
    keys = []
    for _ in range(3):
        toks = list(map(int, rs.randint(1, 256, size=TILE)))
        assert eng.cache_prefix(toks) == TILE
        keys.append(tuple(toks))
    assert list(eng._prefix_store) == keys[1:]        # the oldest evicted
    assert eng.cache_prefix([1, 2, 3]) == 0           # shorter than a tile


def test_prefix_cache_int8_kv_matches_jax_engine(long):
    """Prefix reuse over the int8 KV cache (scale pools spliced too). JAX's
    test holds this engine to the same engine without the prefix cache; on
    these prompts that does not hold in either package (the tail attends
    over the dequantized prefix, the one-shot prompt over exact k/v, and
    request 0's fourth token parts), so the port is held to JAX's engine
    with the prefix cache, token for token."""
    from spt_proto_tpu.inference.batching import \
        ContinuousBatchingEngine as JaxEngine
    iw, shared, prompts = long[0], long[3], long[4][:2]
    j_iw, _ = _weights()
    got = []
    for make, weights in ((JaxEngine, j_iw), (ContinuousBatchingEngine, iw)):
        eng = make(weights, n_slots=2, max_len=384, prefill_bucket=16,
                   quantized_kv=True, prefix_cache=True)
        eng.cache_prefix(shared)
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        done = {c.request_id: c.tokens for c in eng.run_until_done()}
        assert eng.prefix_hits == 2
        got.append([done[r] for r in rids])
    assert got[1] == got[0]


def test_speculative_engine_matches_generate(short):
    """speculative=3 (n-gram drafts + block verify) across slot churn gives
    plain greedy's tokens, with repetitive prompts for acceptances."""
    j_iw, t_iw = _weights(max_length=128)
    rs = np.random.RandomState(7)
    prompts = [list(map(int, rs.randint(1, 6, size=n))) * 2
               for n in (4, 6, 3)]
    want = _references(j_iw, t_iw, prompts, 6, 64)
    got, eng = _serve(t_iw, prompts, 6, n_slots=2, max_len=64,
                      prefill_bucket=16, speculative=3)
    assert got == want
    assert eng.spec_stats['rounds'] >= 1 and eng.spec_stats['accepted'] > 0


def test_stop_ids_end_generation(short):
    """submit(stop_ids=...) ends a request at its first stop token (kept in
    the completion); a request without stop ids is unaffected."""
    iw, prompts, want = short
    full = want[1]
    idx, stop = next((i, tok) for i, tok in enumerate(full)
                     if i > 0 and tok not in full[:i])
    eng = ContinuousBatchingEngine(iw, n_slots=1, max_len=64,
                                   prefill_bucket=16)
    rid = eng.submit(prompts[1], max_new_tokens=8, stop_ids=[stop])
    rid2 = eng.submit(prompts[1], max_new_tokens=8)
    done = {c.request_id: c.tokens for c in eng.run_until_done()}
    assert done[rid] == full[:idx + 1] and done[rid2] == full
    assert eng._stop_ids == {}


def test_sampled_engine_repeats_itself_for_a_seed(short):
    """temperature > 0: the same seed gives the same tokens (JAX's draws
    cannot be reproduced, so no parity), all inside the vocabulary; the
    paged engine samples too."""
    iw, prompts, _ = short

    def run(seed, **kw):
        got, _ = _serve(iw, prompts[:3], 6, n_slots=2, max_len=64,
                        prefill_bucket=16, temperature=0.8, seed=seed, **kw)
        return got

    a, b = run(3), run(3)
    assert a == b
    assert all(0 <= tok < iw.cfg.vocab_size for r in a for tok in r)
    assert run(4) != a
    assert run(3, paged=True, page_size=16) == run(3, paged=True,
                                                   page_size=16)
