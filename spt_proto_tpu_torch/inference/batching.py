"""Continuous batching engine: slot-based prefill/decode interleaving (port
of spt_proto_tpu/inference/batching.py).

The scheduler core (request queue, slot allocation, decode-batch
composition, completion accounting) and the page pool are native C++
(runtime/scheduler.cc), loaded through ctypes; the Python side moves
tensors. If the shared library is missing it is built on first use with the
repository's Makefile (g++, no other dependency).

Flow per `step()`:
  1. admit queued requests into free slots (the scheduler decides),
  2. prefill each newly admitted slot (bucketed prompt lengths; long
     prompts a chunk per step with `prefill_chunk`; a cached prefix spliced
     in first) and splice its KV into the shared batch cache,
  3. one batched decode step over all slots (or one speculative verify
     round), inactive lanes held back,
  4. report tokens back to the scheduler; finished slots free at once.

The engine runs on the weights' device (engine.weights_device). On CUDA
tensors every step goes through the port's kernels: the contiguous greedy
decode through decode_step_greedy (the fused lm_head argmax), the paged
dense decode through the paged-attention kernel. Unlike the JAX engine,
which threads new caches through donated jit calls, the caches here are
updated in place (the splices are copies into views). Host syncs: one read
of the sampled tokens a step, and one per admission (its first token).

mesh=: tensor- and data-parallel serving, one process a rank, every rank
running the same scheduler on the same submissions (the host Python and
the native scheduler are deterministic, so every rank takes the same
decisions). The weights are a rank's shard (parallel/infer_sharding.py);
the contiguous cache holds the rank's kv heads and, when the slots divide
over 'data', its data coordinate's slots (else all of them; the paged pools
hold all slots' pages at the rank's heads). A prompt's prefill runs on
every rank (the JAX engine's mini cache is replicated over 'data' too) and
lands in the slot's owner; a chunked prefill reads the slot's cached
context, so only its owner's data group runs it, and the first token's
logits are broadcast over 'data' from it. Each step's sampled tokens (or,
when sampling, the logits) are gathered over 'data', so that every rank
holds every slot's token and reads the same values back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
from typing import Dict, List, Optional

import numpy as np
import torch

from spt_proto_tpu_torch.inference.engine import (
    DECODE_BUCKET, TILE, KVCache, decode_step, decode_step_greedy,
    grow_cache, heads, mesh_weights, new_cache, prefill,
    prefill_chunk_compute, prefill_chunk_past, round_up, sample, verify_step,
    weights_device)
from spt_proto_tpu_torch.inference.weights import InferenceWeights

_RUNTIME_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), 'runtime')


def _load_native():
    lib_path = os.path.join(_RUNTIME_DIR, 'libsptrt.so')
    # make is a no-op when the .so is newer than the sources
    subprocess.run(['make', '-C', _RUNTIME_DIR], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    i32, i64, ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    sigs = {
        'sched_create': (ptr, [i32, i32]),
        'sched_destroy': (None, [ptr]),
        'sched_submit': (i64, [ptr, i32, i32]),
        'sched_admit': (i32, [ptr, ctypes.POINTER(i32),
                              ctypes.POINTER(i64)]),
        'sched_prefill_done': (None, [ptr, i32]),
        'sched_decode_mask': (i32, [ptr, ctypes.POINTER(ctypes.c_int8)]),
        'sched_token_decoded': (i32, [ptr, i32, ctypes.c_int8]),
        'sched_num_active': (i32, [ptr]),
        'sched_queue_depth': (i32, [ptr]),
        'sched_slot_request': (i64, [ptr, i32]),
        'sched_requeue': (None, [ptr, i32, i32, i32]),
        'pages_create': (ptr, [i32, i32]),
        'pages_destroy': (None, [ptr]),
        'pages_free_count': (i32, [ptr]),
        'pages_alloc': (i32, [ptr, i32]),
        'pages_ensure': (i32, [ptr, i32, i32, i32]),
        'pages_table': (i32, [ptr, i32, ctypes.POINTER(i32), i32]),
        'pages_release': (None, [ptr, i32]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


_LIB = None


def native_scheduler_lib():
    global _LIB
    if _LIB is None:
        _LIB = _load_native()
    return _LIB


# ---------------------------------------------------------------------------
# serving steps (caches updated in place)
# ---------------------------------------------------------------------------

def _hold_back(cache, active: torch.Tensor):
    """Inactive lanes keep their length: their column write lands at the
    held-back position and is overwritten before it can ever become
    attention-visible."""
    return dataclasses.replace(
        cache, length=torch.where(active, cache.length, cache.length - 1))


def _all_rows(t):
    return t


def _decode_and_sample(iw, tokens, cache, active, generator, *,
                       temperature, all_rows=_all_rows):
    """Decode + inactive-lane hold-back + sampling. Greedy goes through
    decode_step_greedy (the fused lm_head argmax kernel on the card).
    tokens / cache / active are the rank's slots; all_rows gathers a
    per-slot tensor over 'data' (the identity without a data split), and
    the returned tokens are every slot's."""
    if temperature == 0.0:
        tok, new = decode_step_greedy(iw, tokens, cache)
        tok = all_rows(tok)
    else:
        logits, new = decode_step(iw, tokens, cache)
        tok = sample(all_rows(logits), generator, temperature=temperature)
    return tok, _hold_back(new, active)


def _paged_decode_and_sample(iw, tokens, cache, active, generator, *,
                             temperature, all_rows=_all_rows):
    from spt_proto_tpu_torch.inference.paged import paged_decode_step
    logits, new = paged_decode_step(iw, tokens, cache)
    tok = sample(logits, generator, temperature=temperature)
    return tok, _hold_back(new, active)


def _verify_and_accept(iw, block, cache, active, generator, *, temperature,
                       rows=slice(None), all_rows=_all_rows):
    """Speculative round for the batching engine: block verify
    (engine.verify_step: the block-verify kernel over a bf16/f32 cache),
    greedy or rejection-sampling acceptance, and rollback. Inactive lanes
    roll back fully. block [B, K] holds every slot's; the cache and active
    the rank's (its `rows` of them). Returns (n_acc [B], correction token
    [B], cache), every slot's acceptance."""
    b, kk = block.shape
    logits, new = verify_step(iw, block[rows].contiguous(), cache)
    logits = all_rows(logits)
    len0 = new.length - kk
    if temperature == 0.0:
        t_hat = torch.argmax(logits, dim=-1).to(torch.int32)
        match = (t_hat[:, :kk - 1] == block[:, 1:]).long()
        n_acc = torch.cumprod(match, dim=1).sum(1)
        corr = t_hat[torch.arange(b, device=block.device), n_acc]
    else:
        from spt_proto_tpu_torch.inference.speculative import spec_accept
        n_acc, corr = spec_accept(logits, None, block[:, 1:], generator,
                                  temperature=temperature)
    new = dataclasses.replace(
        new, length=torch.where(active, len0 + 1 + n_acc[rows],
                                len0).to(torch.int32))
    return n_acc, corr, new


def _splice_slot(cache: KVCache, slot: int, mk, mv, mc, new_len: int,
                 n_layers: int) -> KVCache:
    """Copy a prefilled mini-cache ([1, KV, L*NTm, ., T] tile-major) into
    `slot` of the shared cache, in place. Layer blocks are strided (NTm vs
    NT tiles a layer), so the copy goes through [B, KV, L, NT, ., T]
    views."""
    nt = cache.tiles_per_layer(n_layers)
    nt_m = mk.shape[2] // n_layers
    for big, mini in ((cache.k, mk), (cache.v, mv), (cache.codes, mc)):
        b, h = big.shape[:2]
        view = big.view(b, h, n_layers, nt, *big.shape[3:])
        view[slot, :, :, :nt_m] = mini.view(h, n_layers, nt_m,
                                            *mini.shape[3:])
    cache.length[slot] = new_len
    return cache


def _splice_slot_q(cache: KVCache, slot: int, mk, mv, mc, mks, mvs,
                   new_len: int, n_layers: int) -> KVCache:
    """_splice_slot for the int8 cache: also copies the mini scale pools
    ([1, L*NTm, KV_pad, T]) into the slot's row."""
    _splice_slot(cache, slot, mk, mv, mc, new_len, n_layers)
    nt = cache.tiles_per_layer(n_layers)
    nt_m = mks.shape[1] // n_layers
    for big, mini in ((cache.k_scale, mks), (cache.v_scale, mvs)):
        view = big.view(big.shape[0], n_layers, nt, *big.shape[2:])
        view[slot, :, :nt_m] = mini.view(n_layers, nt_m, *mini.shape[2:])
    return cache


def _slice_tiles(arr, nt_p: int, n_layers: int):
    """A copy of the first `nt_p` tiles of each layer block of a [1, KV,
    L*NTm, ., T] mini-cache array (prefix extraction for the prefix
    cache)."""
    one, h = arr.shape[:2]
    nt_m = arr.shape[2] // n_layers
    view = arr.view(one, h, n_layers, nt_m, *arr.shape[3:])[:, :, :, :nt_p]
    return view.reshape(one, h, n_layers * nt_p, *arr.shape[3:]).clone()


def _slice_tiles_sc(arr, nt_p: int, n_layers: int):
    """_slice_tiles for the int8 scale pools ([1, L*NTm, KV_pad, T])."""
    one = arr.shape[0]
    nt_m = arr.shape[1] // n_layers
    view = arr.view(one, n_layers, nt_m, *arr.shape[2:])[:, :, :nt_p]
    return view.reshape(one, n_layers * nt_p, *arr.shape[2:]).clone()


@dataclasses.dataclass
class _Live:
    request_id: int
    tokens: List[int]
    last_token: int
    prompt_len: int = 0      # tokens in the cache right after prefill
    carried: int = 0         # tokens in `tokens` that predate this prefill
                             # (preemption carry: already inside prompt_len)


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: List[int]       # generated tokens (prompt excluded)


class ContinuousBatchingEngine:
    """Serve generate() requests with continuous batching over fixed slots,
    on the weights' device."""

    def __init__(self, iw: InferenceWeights, *, n_slots: int = 8,
                 max_len: int = 256, prefill_bucket: int = 64,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 paged: bool = False, page_size: int = 64,
                 n_pages: Optional[int] = None, seed: int = 0,
                 prefill_chunk: Optional[int] = None,
                 quantized_kv: bool = False,
                 speculative: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefix_cache_entries: int = 8,
                 mesh=None):
        # mesh: tensor-parallel serving (the module doc): weights sharded
        # on 'model', the contiguous cache's slots on 'data' when they
        # divide
        self.mesh = mesh
        self._rows, self._split = slice(None), False
        if mesh is not None:
            iw = mesh_weights(iw, mesh)
            if not paged:
                from spt_proto_tpu_torch.parallel.infer_sharding import \
                    data_rows
                self._rows, self._split = data_rows(mesh, n_slots)
        self.iw = iw
        self.dev = weights_device(iw)
        self.n_slots = n_slots
        self.max_len = max_len
        self.bucket = prefill_bucket
        self.temperature = temperature
        self.eos_id = eos_id
        self.paged = paged
        # chunked prefill: prompts longer than `prefill_chunk` are split
        # across engine steps (one chunk a step) so a long admission cannot
        # stall the decode batch. Contiguous cache only.
        if prefill_chunk is not None:
            if paged:
                raise ValueError('prefill_chunk requires the contiguous cache')
            if prefill_chunk % TILE:
                raise ValueError(
                    f'prefill_chunk must be a multiple of {TILE}')
        self.chunk = prefill_chunk
        # int8 KV cache (per-token scales): half the cache bytes
        self.quantized_kv = quantized_kv
        # speculative=k: each engine step runs ONE verify block of k n-gram
        # proposals a slot instead of one decode step (greedy output equals
        # plain greedy). Contiguous cache only (verify_step's contract).
        if speculative is not None:
            if paged:
                raise ValueError('speculative requires the contiguous cache')
            if speculative < 1:
                raise ValueError('speculative takes k >= 1 proposals')
        self.spec_k = speculative
        self.spec_stats = dict(rounds=0, proposed=0, accepted=0)
        # prefix caching: the KV of TILE-aligned prompt prefixes is kept in
        # an LRU store and spliced into a slot at admission, so requests
        # that share a system prompt only prefill their tail (through
        # prefill_chunk's offset contract). Contiguous cache only. Dense
        # configs reproduce uncached outputs; sparse_v2 follows
        # prefill_chunk's per-row selection contract.
        if prefix_cache and paged:
            raise ValueError('prefix_cache requires the contiguous cache')
        self.prefix_on = prefix_cache
        self.prefix_entries = prefix_cache_entries
        self._prefix_store: Dict[tuple, dict] = {}
        self._prefix_lru: List[tuple] = []
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self._chunking: Dict[int, dict] = {}   # slot -> chunked-prefill state
        self.last_step_prefill_tokens = 0
        self._lib = native_scheduler_lib()
        self._sched = self._lib.sched_create(n_slots, max_len)
        cfg = iw.cfg
        if paged:
            from spt_proto_tpu_torch.inference.paged import (PageAllocator,
                                                             PagedKVCache)
            self.page_size = page_size
            if n_pages is None:
                n_pages = n_slots * (-(-max_len // page_size))
            self.alloc = PageAllocator(n_pages, n_slots)
            self.cache = PagedKVCache.create(cfg, n_slots, n_pages,
                                             page_size, max_len,
                                             dtype=cfg.dtype,
                                             quantized=quantized_kv,
                                             device=self.dev,
                                             kv_heads=heads(iw)[1])
            self._decode_fn = _paged_decode_and_sample
        else:
            # the contiguous cache starts at one bucket and grows with the
            # longest live sequence (decode cost tracks context, not
            # max_len)
            self.cap = min(max_len, DECODE_BUCKET)
            n_local = n_slots // mesh.shape['data'] if self._split \
                else n_slots
            self.cache = new_cache(iw, n_local, self.cap,
                                   quantized=quantized_kv)
            self._decode_fn = _decode_and_sample
        self._prompts: Dict[int, List[int]] = {}
        self._max_new: Dict[int, int] = {}
        self._stop_ids: Dict[int, set] = {}     # rid -> per-request stops
        self._carry: Dict[int, List[int]] = {}  # preempted partial outputs
        self._live: Dict[int, _Live] = {}       # slot -> live state
        self._tokens = np.zeros((n_slots,), np.int32)
        self._gen = torch.Generator(device=self.dev)
        self._gen.manual_seed(seed)
        self.completions: List[Completion] = []
        self.n_preemptions = 0

    def __del__(self):
        try:
            self._lib.sched_destroy(self._sched)
        except Exception:
            pass

    # ------------------------------------------------------------------
    def submit(self, prompt_tokens: List[int],
               max_new_tokens: int = 32,
               stop_ids: Optional[List[int]] = None) -> int:
        """Queue a request. `stop_ids`: per-request stop tokens; the
        generation ends at the first one produced (included in the
        completion, like the engine-wide eos_id)."""
        if self.paged:
            # the worst case the request ever needs as the pool's sole
            # occupant: its bucketed prompt at prefill, or its final length
            total = len(prompt_tokens) + max_new_tokens
            worst = max(total, min(self._bucketed(total), self.max_len))
            if -(-worst // self.page_size) > self.alloc.n_pages:
                raise ValueError('request needs more pages than the pool '
                                 'holds: it could never be scheduled')
        rid = self._lib.sched_submit(self._sched, len(prompt_tokens),
                                     max_new_tokens)
        if rid < 0:
            raise ValueError('request cannot fit in max_len')
        self._prompts[rid] = list(prompt_tokens)
        self._max_new[rid] = max_new_tokens
        if stop_ids:
            self._stop_ids[rid] = {int(t) for t in stop_ids}
        return int(rid)

    @property
    def num_active(self) -> int:
        return self._lib.sched_num_active(self._sched)

    @property
    def queue_depth(self) -> int:
        return self._lib.sched_queue_depth(self._sched)

    # ------------------------------------------------------------------
    def _bucketed(self, n: int) -> int:
        return max(self.bucket, -(-n // self.bucket) * self.bucket)

    def _on_device(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int32)).to(self.dev)

    # ------------------------------------------------------------------
    # prefix cache (contiguous engine only)
    def cache_prefix(self, tokens: List[int]) -> int:
        """Prefill and pin a shared prefix (e.g. a system prompt) in the
        prefix cache. Only the TILE-aligned head is cacheable; returns the
        number of tokens cached (0 if shorter than one tile)."""
        if not self.prefix_on:
            raise ValueError('engine built without prefix_cache=True')
        p_len = (len(tokens) // TILE) * TILE
        if p_len == 0:
            return 0
        key = tuple(int(t) for t in tokens[:p_len])
        if key in self._prefix_store:
            return p_len
        mini = new_cache(self.iw, 1, p_len, quantized=self.quantized_kv)
        _, mini = prefill(self.iw, self._on_device([key]), mini)
        self._store_prefix(key, dict(k=mini.k, v=mini.v, codes=mini.codes,
                                     k_scale=mini.k_scale,
                                     v_scale=mini.v_scale))
        return p_len

    def _store_prefix(self, key: tuple, entry: dict) -> None:
        if key not in self._prefix_store:
            self._prefix_store[key] = entry
            self._prefix_lru.append(key)
            if len(self._prefix_lru) > self.prefix_entries:
                del self._prefix_store[self._prefix_lru.pop(0)]
        else:
            self._prefix_lru.remove(key)
            self._prefix_lru.append(key)

    def _lookup_prefix(self, cache_tokens: List[int]) -> Optional[tuple]:
        """The longest stored key that is a STRICT prefix of the prompt (at
        least one tail token must remain to produce sampling logits)."""
        best = None
        for key in self._prefix_store:
            if len(key) < len(cache_tokens) and \
                    (best is None or len(key) > len(best)) and \
                    list(key) == cache_tokens[:len(key)]:
                best = key
        if best is not None:
            self._prefix_lru.remove(best)
            self._prefix_lru.append(best)
        return best

    # ------------------------------------------------------------------
    # a data split: which rank holds a slot
    def _local(self, slot: int) -> Optional[int]:
        """The slot's row in this rank's cache, None when another data
        coordinate holds it."""
        if not self._split:
            return slot
        j = slot - self._rows.start
        return j if 0 <= j < self._rows.stop - self._rows.start else None

    def _all_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A per-slot tensor of the rank's slots -> every slot's, gathered
        over 'data' (the identity without a split)."""
        if not self._split:
            return t
        from spt_proto_tpu_torch.parallel import comm
        return comm.gather(self.mesh, t, 'data', dim=0)

    def _splice(self, slot: int, e: dict, new_len: int) -> None:
        local = self._local(slot)
        if local is None:
            return
        nl = self.iw.cfg.n_layers
        if self.quantized_kv:
            _splice_slot_q(self.cache, local, e['k'], e['v'], e['codes'],
                           e['k_scale'], e['v_scale'], new_len, nl)
        else:
            _splice_slot(self.cache, local, e['k'], e['v'], e['codes'],
                         new_len, nl)

    def _prefill_slot(self, slot: int, rid: int) -> None:
        prompt = self._prompts[rid]
        carry = self._carry.pop(rid, [])   # preempted partial generation
        cache_tokens = prompt + carry
        s = len(cache_tokens)
        sb = min(self._bucketed(s), self.max_len)
        padded = np.zeros((1, sb), np.int32)
        padded[0, :s] = cache_tokens
        if self.paged:
            from spt_proto_tpu_torch.inference.paged import (PagedKVCache,
                                                             paged_prefill)
            # admission control: the padded prompt needs ceil(sb/ps) pages
            # now; further pages are allocated lazily as the sequence grows
            if self.alloc.free_count < -(-sb // self.page_size):
                # the pool cannot hold the prompt yet: requeue at the front
                # (FCFS kept) and retry when other slots release pages
                if carry:
                    self._carry[rid] = carry
                self._lib.sched_requeue(self._sched, slot, s,
                                        self._max_new[rid] - len(carry))
                return
            self.alloc.ensure(slot, sb, self.page_size)
            c = self.cache
            c.page_indices[slot] = self._on_device(
                self.alloc.table(slot, c.page_indices.shape[1]))
            # a one-slot view of the shared pools: the prefill writes land
            # in them
            mini = PagedKVCache(c.k_pages, c.v_pages, c.c_pages,
                                c.page_indices[slot:slot + 1],
                                torch.zeros((1,), dtype=torch.int32,
                                            device=self.dev),
                                k_scales=c.k_scales, v_scales=c.v_scales)
            logits, _ = paged_prefill(self.iw, self._on_device(padded), mini)
            c.length[slot] = s
        else:
            hit = (self._lookup_prefix(cache_tokens) if self.prefix_on
                   else None)
            if hit is not None:
                # splice the cached prefix KV into the slot, then run only
                # the tail through the chunked-prefill path (offset starts
                # at the prefix length), padded to a power-of-two multiple
                # of TILE as the JAX engine pads it
                p_len = len(hit)
                tail_pad = TILE
                while p_len + tail_pad < s:
                    tail_pad *= 2
                pad_len = min(p_len + tail_pad,
                              -(-self.max_len // TILE) * TILE)
                if pad_len > self.cap:
                    self._grow(pad_len)
                self._splice(slot, self._prefix_store[hit], p_len)
                self.prefix_hits += 1
                self.prefix_tokens_reused += p_len
                toks = np.zeros((1, pad_len), np.int32)
                toks[0, :s] = cache_tokens
                self._chunking[slot] = dict(rid=rid, tokens=toks,
                                            true_len=s, carry=carry,
                                            done=p_len)
                self._advance_chunk(slot)
                return
            if self.chunk and s > self.chunk:
                # chunked path: stash the prompt, process a chunk per engine
                # step (the first now); other slots decode between chunks
                pad_len = -(-s // TILE) * TILE
                if pad_len > self.cap:
                    self._grow(pad_len)
                toks = np.zeros((1, pad_len), np.int32)
                toks[0, :s] = cache_tokens
                self._chunking[slot] = dict(
                    rid=rid, tokens=toks, true_len=s, carry=carry, done=0)
                self._advance_chunk(slot)
                return
            if sb > self.cap:
                self._grow(sb)
            mini = new_cache(self.iw, 1, sb, quantized=self.quantized_kv)
            logits, mini = prefill(self.iw, self._on_device(padded), mini)
            # automatic prefix insertion: keep this prompt's TILE-aligned
            # head so later requests sharing it skip that prefill work
            if self.prefix_on:
                p_len = (s // TILE) * TILE
                key = tuple(int(t) for t in cache_tokens[:p_len])
                if p_len and key not in self._prefix_store:
                    nt_p, nl = p_len // TILE, self.iw.cfg.n_layers
                    q = self.quantized_kv
                    self._store_prefix(key, dict(
                        k=_slice_tiles(mini.k, nt_p, nl),
                        v=_slice_tiles(mini.v, nt_p, nl),
                        codes=_slice_tiles(mini.codes, nt_p, nl),
                        k_scale=_slice_tiles_sc(mini.k_scale, nt_p, nl)
                        if q else None,
                        v_scale=_slice_tiles_sc(mini.v_scale, nt_p, nl)
                        if q else None))
            # the slot's true length is s, not the padded sb
            self._splice(slot, dict(k=mini.k, v=mini.v, codes=mini.codes,
                                    k_scale=mini.k_scale,
                                    v_scale=mini.v_scale), s)
        self._start(slot, rid, logits[:, s - 1], s, carry)

    def _start(self, slot: int, rid: int, last_logits: torch.Tensor, s: int,
               carry: List[int]) -> None:
        """Sample a prefilled slot's first token (the admission's one host
        sync) and join the decode batch."""
        tok = int(sample(last_logits, self._gen,
                         temperature=self.temperature)[0])
        self._live[slot] = _Live(request_id=rid, tokens=carry + [tok],
                                 last_token=tok, prompt_len=s,
                                 carried=len(carry))
        self._tokens[slot] = tok
        self._lib.sched_prefill_done(self._sched, slot)
        self._report_token(slot, tok)

    def _advance_chunk(self, slot: int) -> None:
        """Process the next prompt chunk of a slot in chunked prefill; after
        the last one, sample the first token and join the decode batch."""
        st = self._chunking[slot]
        total = st['tokens'].shape[1]
        offset = st['done']
        # self.chunk is None when only the prefix cache routed us here: the
        # whole tail is one chunk
        c = min(self.chunk or (total - offset), total - offset)
        st['done'] = offset + c
        self.last_step_prefill_tokens += c
        s = st['true_len']
        # the slot's cached context lives on its owner: only the owner's
        # data group runs the chunk (a data split broadcasts its last
        # logits below)
        local = self._local(slot)
        if local is not None:
            chunk = self._on_device(st['tokens'][:, offset:offset + c])
            past = prefill_chunk_past(self.iw, self.cache, local, offset)
            logits, self.cache = prefill_chunk_compute(
                self.iw, chunk, self.cache, past, local, offset)
        if st['done'] < total:
            return
        del self._chunking[slot]
        if local is not None:
            # the cache length was set to the padded total: the true length
            self.cache.length[local] = s
            last = logits[:, (s - 1) - offset]
        if self._split:
            from spt_proto_tpu_torch.parallel import comm
            n_local = self._rows.stop - self._rows.start
            if local is not None:
                last = last.float()
            else:
                last = torch.empty((1, self.iw.cfg.vocab_size),
                                   dtype=torch.float32, device=self.dev)
            last = comm.broadcast(self.mesh, last, slot // n_local, 'data')
        self._start(slot, st['rid'], last, s, st['carry'])

    def _release_pages(self, slot: int) -> None:
        self.alloc.release(slot)
        self.cache.page_indices[slot] = -1

    def _report_token(self, slot: int, tok: int) -> None:
        stops = self._stop_ids.get(self._live[slot].request_id)
        eos = 1 if ((self.eos_id is not None and tok == self.eos_id)
                    or (stops is not None and tok in stops)) else 0
        done = self._lib.sched_token_decoded(self._sched, slot,
                                             ctypes.c_int8(eos))
        if done:
            live = self._live.pop(slot)
            self.completions.append(Completion(live.request_id, live.tokens))
            self._prompts.pop(live.request_id, None)
            self._max_new.pop(live.request_id, None)
            self._stop_ids.pop(live.request_id, None)
            if self.paged:
                self._release_pages(slot)

    def _grow(self, needed: int) -> None:
        """Grow the contiguous cache to the next bucket covering `needed`."""
        self.cap = min(round_up(needed, DECODE_BUCKET), self.max_len)
        self.cache = grow_cache(self.cache, self.cap, self.iw.cfg.n_layers)

    def _cache_len(self, live: _Live) -> int:
        """Tokens in the slot's KV cache: the prefilled context plus every
        decode step since (the freshly sampled token is written by the NEXT
        decode step, so it does not count yet)."""
        return live.prompt_len + len(live.tokens) - live.carried - 1

    def _preempt(self, slot: int) -> None:
        """Preemption by recompute: release the slot's pages and requeue
        prompt + generated-so-far at the front of the queue with the
        remaining token budget."""
        live = self._live.pop(slot)
        rid = live.request_id
        self._carry[rid] = list(live.tokens)
        remaining = self._max_new[rid] - len(live.tokens)
        self._lib.sched_requeue(self._sched, slot,
                                len(self._prompts[rid]) + len(live.tokens),
                                remaining)
        self._release_pages(slot)
        self.n_preemptions += 1

    def _grow_pages(self) -> None:
        """Extend page tables lazily so every live slot can write its next
        token. When the pool runs out, preempt the youngest request (the
        largest id) until the oldest ones fit."""
        order = sorted(self._live.items(), key=lambda kv: kv[1].request_id)
        for slot, live in order:
            if slot not in self._live:      # preempted earlier this round
                continue
            while True:
                try:
                    added = self.alloc.ensure(slot, self._cache_len(live) + 1,
                                              self.page_size)
                except MemoryError:
                    victims = [s for s in self._live if s != slot]
                    victim = max(victims,
                                 key=lambda s: self._live[s].request_id) \
                        if victims else slot
                    self._preempt(victim)
                    if victim == slot:
                        break
                    continue
                if added:
                    pi = self.cache.page_indices
                    pi[slot] = self._on_device(
                        self.alloc.table(slot, pi.shape[1]))
                break

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Admit + prefill + one decode step. Returns the tokens produced."""
        self.last_step_prefill_tokens = 0
        slots = (ctypes.c_int32 * self.n_slots)()
        ids = (ctypes.c_int64 * self.n_slots)()
        n_adm = self._lib.sched_admit(self._sched, slots, ids)
        admitted = set()
        for i in range(n_adm):
            self._prefill_slot(int(slots[i]), int(ids[i]))
            admitted.add(int(slots[i]))
        # advance in-flight chunked prefills by exactly one chunk each
        # (slots admitted this step already got their first chunk)
        for slot in list(self._chunking):
            if slot not in admitted:
                self._advance_chunk(slot)
        if self.paged:
            self._grow_pages()

        mask = (ctypes.c_int8 * self.n_slots)()
        n_dec = self._lib.sched_decode_mask(self._sched, mask)
        if n_dec == 0:
            return 0
        active = np.frombuffer(mask, dtype=np.int8).astype(bool).copy()
        if self.spec_k:
            return self._spec_round(active)
        if not self.paged and self._live:
            need = max(self._cache_len(l) for l in self._live.values()) + 1
            if need > self.cap and self.cap < self.max_len:
                self._grow(need)
        rows = self._rows
        toks, self.cache = self._decode_fn(
            self.iw, self._on_device(self._tokens[rows]), self.cache,
            torch.from_numpy(active[rows]).to(self.dev), self._gen,
            temperature=self.temperature, all_rows=self._all_rows)
        toks = toks.cpu().numpy()              # the step's one host sync
        produced = 0
        for slot in range(self.n_slots):
            if not active[slot] or slot not in self._live:
                continue
            tok = int(toks[slot])
            self._live[slot].tokens.append(tok)
            self._live[slot].last_token = tok
            self._tokens[slot] = tok
            self._report_token(slot, tok)
            produced += 1
        return produced

    def _spec_round(self, active: np.ndarray) -> int:
        """One speculative round over the active decode batch: n-gram
        proposals a slot (host-side, over prompt + generated), one verify,
        per-slot acceptance and emission. A slot that completes mid-block
        drops the rest of its block; its cache columns past the emitted
        tokens are dead and get overwritten by the next admission."""
        from spt_proto_tpu_torch.inference.speculative import ngram_propose
        lives = [(s, l) for s, l in self._live.items() if active[s]]
        if not lives:
            return 0
        max_need = max(self._cache_len(l) for _, l in lives)
        # near max_len the block shrinks so writes never exceed capacity
        kk_r = min(self.spec_k + 1, self.max_len - max_need)
        k_r = kk_r - 1
        if max_need + kk_r > self.cap and self.cap < self.max_len:
            self._grow(max_need + kk_r)
        stream = np.zeros((self.n_slots, self.max_len), np.int64)
        lens = np.zeros((self.n_slots,), np.int64)
        for slot, live in lives:
            seq = (self._prompts[live.request_id] + live.tokens
                   )[-self.max_len:]
            stream[slot, :len(seq)] = seq
            lens[slot] = len(seq)
        props = (ngram_propose(stream, lens, k_r) if k_r > 0
                 else np.zeros((self.n_slots, 0), np.int64))
        block = self._on_device(np.concatenate(
            [self._tokens[:, None], props.astype(np.int32)], axis=1))
        # a lane with no request (a finished one can sit at the cache's
        # end) is moved to where its dead block lands inside the cache:
        # the verify kernel cannot drop columns past it as the JAX
        # engine's scatter does. A lane in chunked prefill is live and
        # keeps its length (its cached prompt ends there): its block,
        # rolled back after the round, lies below the cache's end on the
        # kernel's route (its length is at most the padded prompt less a
        # whole chunk, and K <= 30 < TILE), and verify_step's plain path
        # drops the columns past the cache (engine._Block.write_at)
        rows = self._rows
        free = [s for s in range(self.n_slots)
                if s not in self._live and s not in self._chunking]
        if free:
            lane = torch.zeros((self.n_slots,), dtype=torch.bool)
            lane[free] = True
            self.cache = dataclasses.replace(self.cache, length=torch.where(
                lane[rows].to(self.dev), self.cache.length.clamp(
                    max=self.cap - block.shape[1]), self.cache.length))
        n_acc, corr, self.cache = _verify_and_accept(
            self.iw, block, self.cache,
            torch.from_numpy(active[rows]).to(self.dev), self._gen,
            temperature=self.temperature, rows=rows,
            all_rows=self._all_rows)
        # the round's one host sync
        n_acc, corr = torch.stack([n_acc.long(), corr.long()]).cpu().numpy()
        produced = 0
        self.spec_stats['rounds'] += 1
        for slot, _ in lives:
            self.spec_stats['proposed'] += k_r
            self.spec_stats['accepted'] += int(n_acc[slot])
            emitted = list(props[slot, :n_acc[slot]]) + [int(corr[slot])]
            for tok in emitted:
                live = self._live.get(slot)
                if live is None:
                    break               # completed mid-block
                tok = int(tok)
                live.tokens.append(tok)
                live.last_token = tok
                self._tokens[slot] = tok
                self._report_token(slot, tok)
                produced += 1
            if slot in self._live:
                self._tokens[slot] = int(corr[slot])
        return produced

    def live_progress(self) -> Dict[int, List[int]]:
        """Snapshot of in-flight generations: {request_id: tokens so far}
        (prompt excluded; tokens carried across preemptions included).
        Completed requests appear in `completions`, not here."""
        return {l.request_id: list(l.tokens) for l in self._live.values()}

    def run_until_done(self, max_steps: int = 10_000) -> List[Completion]:
        steps = 0
        while (self.num_active or self.queue_depth) and steps < max_steps:
            self.step()
            steps += 1
        out, self.completions = self.completions, []
        return out
