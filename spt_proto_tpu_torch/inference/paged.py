"""Paged KV cache: pools of pages + per-slot page tables (port of
spt_proto_tpu/inference/paged.py).

Instead of one contiguous cache row per slot, K/V live in a fixed pool of
pages and each slot owns a LOGICAL page table; memory then scales with the
sequences' actual lengths. Page ownership (free list, lazy growth, release)
is the native allocator of runtime/scheduler.cc (`PageAllocator`, through
ctypes).

Pool layout (the JAX package's): the layer dimension is merged into the page
axis. Pools are [KV, L*n_pages + 1, page_size, D] and layer l's copy of
logical page p lives at physical page l*n_pages + p; the last page is a
shared write sink for slots without a table (released continuous-batching
lanes). A parallel code pool [KV, L*n_pages + 1, ps, n_sub] lets the pages
double as PQ selection tiles: sparse decode scores pages by PQ match count
and reads only the top pages of K/V (`paged_sparse_attention`, plain
PyTorch as the JAX package writes it in jnp).

Dense paged decode attends through the paged-attention kernel
(ops/paged_attention.py, csrc/paged_attention.cu) once a layer a step on
CUDA tensors; its plain twin runs on CPU tensors. Unlike the JAX package,
whose steps return new pools, paged_prefill and paged_decode_step write the
pools in place.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from spt_proto_tpu_torch.config import ATTN_SPARSE_V2, ModelConfig
from spt_proto_tpu_torch.inference.bridge import resolve_device
from spt_proto_tpu_torch.inference.engine import (TILE, NEG_INF,
                                                  _apply_rope, _bd_of,
                                                  _embed, _encode_codes,
                                                  _ffn_residual, _layer,
                                                  _lm_logits, _norm, _o_proj,
                                                  _qkv_proj, heads, new_cache,
                                                  prefill)
from spt_proto_tpu_torch.inference.weights import InferenceWeights
from spt_proto_tpu_torch.layers.common import rope_cos_sin
from spt_proto_tpu_torch.ops.paged_attention import (MAX_INT8,
                                                     dequantize_pages,
                                                     paged_attention)

__all__ = ['PagedKVCache', 'PageAllocator', 'paged_sparse_attention',
           'paged_prefill', 'paged_decode_step']


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor       # [KV, L*n_pages + 1, page_size, D]
    v_pages: torch.Tensor       # [KV, L*n_pages + 1, page_size, D]
    c_pages: torch.Tensor       # [KV, L*n_pages + 1, page_size, n_sub] int32
    page_indices: torch.Tensor  # [B, pages_per_seq] int32 LOGICAL, -1 = none
    length: torch.Tensor        # [B] int32
    # int8 mode: per-token scales in the stock paged-attention
    # QuantizedTensor layout (trailing head dim reduced); None = fp pages
    k_scales: Optional[torch.Tensor] = None   # [KV, L*n_pages+1, ps, 1] f32
    v_scales: Optional[torch.Tensor] = None   # [KV, L*n_pages+1, ps, 1] f32

    @staticmethod
    def create(cfg: ModelConfig, batch: int, n_pages: int, page_size: int,
               max_len: int, dtype=torch.bfloat16, quantized: bool = False,
               device='cuda', kv_heads: Optional[int] = None
               ) -> 'PagedKVCache':
        """L*n_pages + 1 physical pages: the last is the reserved write
        sink, where decode writes of slots with no page table (-1 entries)
        land instead of corrupting a real page. kv_heads: the heads a rank
        holds under a mesh (default all)."""
        dev = resolve_device(device)
        l, h, d = cfg.n_layers, kv_heads or cfg.kv_heads, cfg.d_head
        n_sub = cfg.n_subspaces if cfg.attention == ATTN_SPARSE_V2 else 1
        pps = -(-max_len // page_size)
        n_phys = l * n_pages + 1
        kv_dtype = torch.int8 if quantized else dtype
        scales = {}
        if quantized:
            scales = {name: torch.zeros((h, n_phys, page_size, 1),
                                        dtype=torch.float32, device=dev)
                      for name in ('k_scales', 'v_scales')}
        return PagedKVCache(
            k_pages=torch.zeros((h, n_phys, page_size, d), dtype=kv_dtype,
                                device=dev),
            v_pages=torch.zeros((h, n_phys, page_size, d), dtype=kv_dtype,
                                device=dev),
            c_pages=torch.zeros((h, n_phys, page_size, n_sub),
                                dtype=torch.int32, device=dev),
            page_indices=torch.full((batch, pps), -1, dtype=torch.int32,
                                    device=dev),
            length=torch.zeros((batch,), dtype=torch.int32, device=dev),
            **scales)

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    def n_logical(self, n_layers: int) -> int:
        return (self.k_pages.shape[1] - 1) // n_layers


class PageAllocator:
    """ctypes wrapper over the native page pool (runtime/scheduler.cc)."""

    def __init__(self, n_pages: int, n_slots: int):
        from spt_proto_tpu_torch.inference.batching import \
            native_scheduler_lib
        self._lib = native_scheduler_lib()
        self._pool = self._lib.pages_create(n_pages, n_slots)
        self.n_pages = n_pages
        self.n_slots = n_slots

    def __del__(self):
        try:
            self._lib.pages_destroy(self._pool)
        except Exception:
            pass

    @property
    def free_count(self) -> int:
        return self._lib.pages_free_count(self._pool)

    def ensure(self, slot: int, tokens: int, page_size: int) -> int:
        """Grow the slot's table to cover `tokens`; returns the pages added
        (0 if it already did). Raises MemoryError when the pool runs out,
        having taken none."""
        n = self._lib.pages_ensure(self._pool, slot, tokens, page_size)
        if n < 0:
            raise MemoryError('page pool exhausted')
        return n

    def table(self, slot: int, cap: int) -> np.ndarray:
        buf = (ctypes.c_int32 * cap)()
        self._lib.pages_table(self._pool, slot, buf, cap)
        return np.frombuffer(buf, dtype=np.int32).copy()

    def release(self, slot: int) -> None:
        self._lib.pages_release(self._pool, slot)


def _quantize_pages(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], scales [..., 1]): the stock kernel's
    quantization, q = rint(x * (127.5 / h)), h = max(|x|, 1e-8). XLA
    saturates the int8 conversion (a value on 127.5 becomes 127); torch
    wraps, so the clamp keeps the two equal."""
    xf = x.float()
    h = xf.abs().amax(-1, keepdim=True).clamp(min=1e-8)
    # a tensor numerator: torch computes scalar / tensor as reciprocal(h) *
    # scalar, an ulp away from XLA's true quotient
    c = torch.full((), MAX_INT8, dtype=torch.float32, device=x.device)
    q = torch.round(xf * (c / h)).clamp(-128, 127).to(torch.int8)
    return q, h


def paged_sparse_attention(qg, codes_q, k_pages, v_pages, c_pages, lengths,
                           phys_indices, page_indices, *, scale: float,
                           clamp: float, sparse_coeff: int,
                           k_scales=None, v_scales=None) -> torch.Tensor:
    """PQ page-sparse decode attention: pages are the selection tiles.

    qg [B, KV, G, D]; codes_q [B, KV, G, n_sub]; pools [KV, P, ps, ...];
    phys_indices [B, pps] physical ids; page_indices [B, pps] logical (for
    the validity masks). Scores every cached key's PQ match count from the
    code pages, pools them per page (a mean of integers, so exact), selects
    the top `pps // sparse_coeff + 1` pages per head in lax.top_k order
    (descending, the lower page first on ties: a stable sort), the current
    page forced in, and attends over those pages only. Returns
    [B, KV, G, D]."""
    b, kv, g, d = qg.shape
    ps = c_pages.shape[2]
    pps = phys_indices.shape[1]
    dev = qg.device
    lengths = lengths.long()
    safe = phys_indices.clamp(min=0).long()
    cg = c_pages[:, safe].permute(1, 0, 2, 3, 4)         # [B,KV,pps,ps,ns]
    match = (cg[:, :, None] == codes_q[:, :, :, None, None, :]
             ).float().sum(-1)                            # [B,KV,G,pps,ps]
    cols = (torch.arange(pps * ps, device=dev)[None, :]
            < lengths[:, None]).reshape(b, pps, ps)
    match = torch.where(cols[:, None, None], match, -1.0)
    pscore = match.mean(-1)                               # [B, KV, G, pps]
    ar = torch.arange(pps, device=dev)[None, :]
    page_live = (ar * ps < lengths[:, None]) & (page_indices >= 0)
    pscore = torch.where(page_live[:, None, None], pscore, float('-inf'))
    # force the page holding the most recent token (recency window)
    cur = (lengths.clamp(min=1) - 1) // ps
    pscore = torch.where((ar == cur[:, None])[:, None, None], float('inf'),
                         pscore)
    nsel = min(pps, max(1, pps // sparse_coeff) + 1)
    pvals, pidx = torch.sort(pscore, dim=-1, descending=True, stable=True)
    pvals, pidx = pvals[..., :nsel], pidx[..., :nsel]     # [B, KV, G, nsel]
    page_ok = pvals > float('-inf')
    sel_phys = safe[:, None, None, :].expand(b, kv, g, pps).gather(-1, pidx)
    hidx = torch.arange(kv, device=dev)[:, None, None, None]
    at = (hidx, sel_phys.permute(1, 0, 2, 3))
    kg, vg = k_pages[at], v_pages[at]                     # [KV,B,G,ns,ps,D]
    if k_scales is not None:
        kg = dequantize_pages(kg, k_scales[at], qg.dtype)
        vg = dequantize_pages(vg, v_scales[at], qg.dtype)
    kg = kg.permute(1, 0, 2, 3, 4, 5)                     # [B,KV,G,ns,ps,D]
    vg = vg.permute(1, 0, 2, 3, 4, 5)
    colpos = pidx[..., None] * ps + torch.arange(ps, device=dev)
    ok = (colpos < lengths[:, None, None, None, None]) & page_ok[..., None]
    scores = torch.einsum('bkgd,bkgspd->bkgsp', qg.float(),
                          kg.float()) * scale
    scores = scores.clamp(-clamp, clamp)
    scores = torch.where(ok, scores, NEG_INF)
    probs = torch.softmax(scores.reshape(b, kv, g, -1),
                          dim=-1).reshape(scores.shape)
    probs = torch.where(ok, probs, 0.0).to(vg.dtype)
    return torch.einsum('bkgsp,bkgspd->bkgd', probs.float(),
                        vg.float()).to(vg.dtype)


# ---------------------------------------------------------------------------
# engine steps over the paged cache
# ---------------------------------------------------------------------------

def paged_prefill(iw: InferenceWeights, tokens: torch.Tensor,
                  cache: PagedKVCache) -> Tuple[torch.Tensor, PagedKVCache]:
    """Prompt pass writing K/V (and PQ codes) into the slots' pages, in
    place. tokens [B, S]; cache.page_indices rows must already hold >=
    ceil(S/ps) logical pages. Returns (logits [B, S, V], the cache with
    length S for every row)."""
    cfg = iw.cfg
    b, s = tokens.shape
    dev = cache.k_pages.device
    ps = cache.page_size
    l, h = cfg.n_layers, heads(iw)[1]
    n_log = cache.n_logical(l)
    tmp = new_cache(iw, b, s, device=dev)
    logits, tmp = prefill(iw, tokens, tmp)
    # tmp is layer-folded tile-major [B, KV, L*NTm, w, T]; unfold to
    # [L, B, KV, S, w], then scatter into the pools [KV, L*N+1, ps, w]
    pps_used = -(-s // ps)
    pad = pps_used * ps - s
    nt_m = tmp.tiles_per_layer(l)

    def to_std(tiled):
        w = tiled.shape[3]
        x = tiled.reshape(b, h, l, nt_m, w, TILE).permute(2, 0, 1, 3, 5, 4)
        return x.reshape(l, b, h, nt_m * TILE, w)[:, :, :, :s]

    def to_pages(x):                 # [L, B, KV, S, w] -> [KV, L*B*pps, ps, w]
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        x = x.reshape(l, b, h, pps_used, ps, x.shape[-1])
        return x.permute(2, 0, 1, 3, 4, 5).reshape(h, -1, ps, x.shape[-1])

    logical = cache.page_indices[:, :pps_used].clamp(min=0).long()
    phys = (torch.arange(l, device=dev)[:, None, None] * n_log
            + logical[None]).reshape(-1)                  # [L*B*pps]
    k_std, v_std = to_std(tmp.k), to_std(tmp.v)
    if cache.quantized:
        k_std, ksc = _quantize_pages(k_std)
        v_std, vsc = _quantize_pages(v_std)
        cache.k_scales[:, phys] = to_pages(ksc)
        cache.v_scales[:, phys] = to_pages(vsc)
    cache.k_pages[:, phys] = to_pages(k_std).to(cache.k_pages.dtype)
    cache.v_pages[:, phys] = to_pages(v_std).to(cache.v_pages.dtype)
    if cfg.attention == ATTN_SPARSE_V2:
        codes = to_std(tmp.codes)[..., :cache.c_pages.shape[3]]
        cache.c_pages[:, phys] = to_pages(codes).to(torch.int32)
    return logits, dataclasses.replace(
        cache, length=torch.full_like(cache.length, s))


def paged_decode_step(iw: InferenceWeights, tokens: torch.Tensor,
                      cache: PagedKVCache
                      ) -> Tuple[torch.Tensor, PagedKVCache]:
    """One token per slot over the paged cache -> (logits [B, V], cache
    with length + 1). Each layer writes the new token's k/v (int8 pages:
    quantized, scales beside them) and codes into its page in place (slots
    without a page there write into the sink page), then attends: dense
    through the paged-attention kernel, sparse through
    paged_sparse_attention."""
    cfg = iw.cfg
    p = iw.params
    b = tokens.shape[0]
    dev = cache.k_pages.device
    ps = cache.page_size
    n_log = cache.n_logical(cfg.n_layers)
    pos = cache.length.long()
    x = _embed(iw, tokens, pos)[:, None]                      # [B, 1, D]
    hq, kv, g, dh = heads(iw)
    scale = dh ** -0.5
    sparse = cfg.attention == ATTN_SPARSE_V2
    pps = cache.page_indices.shape[1]
    page_of = cache.page_indices.gather(
        1, (pos // ps).clamp(max=pps - 1)[:, None])[:, 0].long()
    has_table = cache.page_indices >= 0
    # slots without a page table write into the reserved sink page
    sink = cache.k_pages.shape[1] - 1
    slot_in_page = (pos % ps)[None]                           # [1, B]
    hidx = torch.arange(kv, device=dev)[:, None]              # [KV, 1]
    lengths = cache.length + 1
    if cfg.arch == 'llama':
        cos_b, sin_b = rope_cos_sin(pos, dh, base=cfg.rope_base)
        rope = (cos_b[:, None, None], sin_b[:, None, None])
    for li in range(cfg.n_layers):
        bp = _layer(p['blocks'], li)
        mha = bp['mha']
        q, k, v = _qkv_proj(mha, _norm(cfg, bp['norm1'], x))
        q = q.reshape(b, hq, dh)
        k = k.reshape(b, kv, dh)
        v = v.reshape(b, kv, dh)
        if cfg.arch == 'llama':
            q = _apply_rope(q.reshape(b, hq, 1, dh), *rope).reshape(b, hq, dh)
            k = _apply_rope(k.reshape(b, kv, 1, dh), *rope).reshape(b, kv, dh)
        write_page = torch.where(page_of >= 0, li * n_log + page_of,
                                 sink)[None]                  # [1, B]
        at = (hidx, write_page, slot_in_page)                 # [KV, B]
        if cache.quantized:
            k_w, ksc_w = _quantize_pages(k)                   # + [B, KV, 1]
            v_w, vsc_w = _quantize_pages(v)
            cache.k_scales[at] = ksc_w.transpose(0, 1)
            cache.v_scales[at] = vsc_w.transpose(0, 1)
        else:
            k_w, v_w = k, v
        cache.k_pages[at] = k_w.transpose(0, 1).to(cache.k_pages.dtype)
        cache.v_pages[at] = v_w.transpose(0, 1).to(cache.v_pages.dtype)
        phys_idx = torch.where(has_table, li * n_log + cache.page_indices,
                               sink).to(torch.int32)
        if sparse:
            bd_m = _bd_of(mha)
            codes_q = _encode_codes(cfg, mha['quantizer'], q,
                                    bd=bd_m).reshape(b, kv, g, -1)
            c_new = _encode_codes(cfg, mha['quantizer'], k, bd=bd_m)
            cache.c_pages[at] = c_new.transpose(0, 1).to(torch.int32)
            o = paged_sparse_attention(
                q.reshape(b, kv, g, dh), codes_q, cache.k_pages,
                cache.v_pages, cache.c_pages, lengths, phys_idx,
                cache.page_indices, scale=scale, clamp=cfg.score_clamp,
                sparse_coeff=cfg.sparse_coeff, k_scales=cache.k_scales,
                v_scales=cache.v_scales)
        else:
            # JAX's paged_attention_op (the stock kernel on the TPU). The
            # kernel takes contiguous tensors; _qkv_proj's einsum may return
            # strided views
            o = paged_attention(q.contiguous(), cache.k_pages, cache.v_pages,
                                lengths, phys_idx, scale=scale,
                                k_scales=cache.k_scales,
                                v_scales=cache.v_scales)
        x = x + _o_proj(iw, mha['o'], o.reshape(b, 1, hq * dh))
        x = _ffn_residual(cfg, bp['ffn'], bp['norm2'], x, iw.shard)
    cache = dataclasses.replace(cache, length=lengths)
    logits = _lm_logits(iw, _norm(cfg, p['final_norm'], x)[:, 0])
    return logits, cache
