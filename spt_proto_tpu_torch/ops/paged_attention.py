"""Paged decode attention (port of the stock Pallas paged_attention that
spt_proto_tpu/inference/paged.py:198 paged_attention_op calls on the TPU).

One decode step of attention for each slot over a pool of pages: q [B, H,
D]; k_pages / v_pages [KV, P, ps, D] in q's dtype, or int8 with per-token
scales k_scales / v_scales [KV, P, ps, 1] f32 (the stock kernel's
QuantizedTensor form); lengths [B]; page_indices [B, pps] PHYSICAL page ids
(a -1 is read as page 0, as the oracle's max(id, 0) reads it). GQA: query
head h reads kv head h // (H / KV). Positions at or past lengths[b] are
masked.

`paged_attention` launches csrc/paged_attention.cu's kernels for CUDA
tensors and runs `paged_attention_ref` (the JAX oracle, paged.py:170, with
int8 pages read back through `dequantize_pages`, paged.py:162) for CPU
tensors. `paged_route` names the kernel: bf16 takes the split walk on the
tensor cores (each slot's positions in chunks of `paged_split_plan`, one
cluster a slot), f32 the two-pass walk.
"""
from __future__ import annotations

import functools

import torch

from spt_proto_tpu_torch import _build

NEG_INF = -1e30
MAX_INT8 = 127.5     # the stock paged-attention QuantizedTensor convention
PAGE_SIZES = (16, 64, 128)
HEAD_DIMS = (64, 128)
SMEM_LIMIT = 200 * 1024
PAGED_STEP = 64           # token positions a split step (csrc kPagedStep)
PAGED_CLUSTER = 8         # chunks a slot at most, one cluster (the portable
                          # cluster size, csrc kPagedCluster)
# steps a split chunk aims at, by page kind: 512 positions over bf16 pages,
# 256 over int8 pages (whose steps also convert; kernel_ab.py
# --attn-sweep)
PAGED_CHUNK_STEPS = {False: 8, True: 4}


def paged_route(dtype: torch.dtype) -> str:
    """The kernel a paged_attention launch runs inside the envelope (pages
    of PAGE_SIZES tokens, d_head in HEAD_DIMS, G 1-8): 'split'
    (paged_attention_split_kernel, tensor cores) for a bf16 q, 'walk'
    (paged_attention_kernel, the two-pass walk) for f32."""
    return 'split' if dtype == torch.bfloat16 else 'walk'


@functools.lru_cache(maxsize=256)
def paged_split_plan(pps: int, ps: int, quant: bool) -> tuple[int, int]:
    """The split walk's plan for slots of `pps` pages of `ps` tokens (quant:
    int8 pages): (chunks a slot, steps of PAGED_STEP positions a chunk).
    One CTA a chunk and one cluster a slot: as many chunks as make chunks
    of about PAGED_CHUNK_STEPS[quant] steps, at most PAGED_CLUSTER; chunk c
    takes positions c*s*64 .. min((c+1)*s*64, pps*ps) - 1."""
    n_steps = -(-pps * ps // PAGED_STEP)
    chunks = min(PAGED_CLUSTER,
                 -(-n_steps // PAGED_CHUNK_STEPS[bool(quant)]))
    s = -(-n_steps // chunks)
    return -(-n_steps // s), s


@functools.lru_cache(maxsize=256)
def paged_split_scores(steps: int, g: int, d: int, ps: int,
                       quant: bool) -> int:
    """Floats of global score buffer a split CTA takes for chunks of
    `steps` steps, G = g query rows, d_head d and pages of ps tokens (quant:
    int8 pages): 0 while its scores fit in shared memory (the kernel
    library's own layout, csrc paged_smem), else g x (64 steps + 4) (slots
    past ~42,000 positions at G = 8)."""
    return _build.lib().spt_paged_split_scores(steps, g, d, ps, int(quant))


def dequantize_pages(q8: torch.Tensor, h: torch.Tensor,
                     dtype) -> torch.Tensor:
    """int8 pages and their scales -> values in `dtype`, in the oracle's
    order of operations: (x * h) / 127.5 in f32, then rounded. The divisor
    is a tensor on the pages' device: CUDA divides by a CPU scalar as a
    multiply by its reciprocal, an ulp away from the quotient."""
    c = torch.full((), MAX_INT8, dtype=torch.float32, device=q8.device)
    return ((q8.float() * h) / c).to(dtype)


def paged_attention_ref(q, k_pages, v_pages, lengths, page_indices, *,
                        scale: float, k_scales=None, v_scales=None):
    """Plain oracle over pages in q's dtype: f32 scores q.k * scale, masked
    at positions >= lengths, softmax in f32, the probabilities cast to the V
    dtype, then PV. Returns [B, H, D] in q's dtype. With k_scales /
    v_scales the int8 pages each slot reads are dequantized to q's dtype
    (dequantize_pages) after the gather, which gives what dequantizing the
    whole pools first gives."""
    b, hq, d = q.shape
    kv, _, ps, _ = k_pages.shape
    g = hq // kv
    pps = page_indices.shape[1]
    safe = page_indices.clamp(min=0).long()
    kg, vg = k_pages[:, safe], v_pages[:, safe]        # [KV, B, pps, ps, D]
    if k_scales is not None:
        kg = dequantize_pages(kg, k_scales[:, safe], q.dtype)
        vg = dequantize_pages(vg, v_scales[:, safe], q.dtype)
    # per slot, then each kv head repeated over its query group
    kg = kg.permute(1, 0, 2, 3, 4).reshape(b, kv, pps * ps, d)
    vg = vg.permute(1, 0, 2, 3, 4).reshape(b, kv, pps * ps, d)
    if g > 1:
        kg = kg.repeat_interleave(g, dim=1)
        vg = vg.repeat_interleave(g, dim=1)
    scores = torch.einsum('bhd,bhjd->bhj', q.float(), kg.float()) * scale
    valid = (torch.arange(pps * ps, device=q.device)[None, :]
             < lengths.long()[:, None])
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(vg.dtype)
    return torch.einsum('bhj,bhjd->bhd', probs.float(),
                        vg.float()).to(q.dtype)


def paged_attention(q, k_pages, v_pages, lengths, page_indices, *,
                    scale: float, k_scales=None, v_scales=None):
    """Paged decode attention (module docstring); with k_scales / v_scales
    the pages are int8. Returns o [B, H, D] in q's dtype."""
    quant = k_scales is not None
    ins = (q, k_pages, v_pages, lengths, page_indices) + (
        (k_scales, v_scales) if quant else ())
    if not _build.on_cuda(*ins):
        return paged_attention_ref(q, k_pages, v_pages, lengths,
                                   page_indices, scale=scale,
                                   k_scales=k_scales, v_scales=v_scales)
    b, hq, d = q.shape
    kv, n_pages, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    req = _build.require
    code = _build.dtype_code(q)
    req(ps in PAGE_SIZES and d in HEAD_DIMS,
        f'page size {ps} / d_head {d} outside the kernel envelope '
        f'(page size in {PAGE_SIZES}, d_head in {HEAD_DIMS})')
    req(hq % kv == 0 and 1 <= hq // kv <= 8,
        f'{hq} query heads over {kv} kv heads: groups of 1-8')
    req(k_pages.shape == v_pages.shape == (kv, n_pages, ps, d),
        'k/v pages [KV, P, ps, D]')
    if quant:
        req(k_pages.dtype == v_pages.dtype == torch.int8,
            'int8 pages with scales')
        req(k_scales.dtype == v_scales.dtype == torch.float32
            and k_scales.shape == v_scales.shape == (kv, n_pages, ps, 1),
            'scales [KV, P, ps, 1] f32')
    else:
        req(k_pages.dtype == v_pages.dtype == q.dtype,
            'q and the pages share one dtype')
    req(lengths.shape == (b,) and page_indices.shape[0] == b,
        'lengths [B], page_indices [B, pps]')
    g = hq // kv
    lengths_i = lengths.to(torch.int32)
    pages_i = page_indices.to(torch.int32)
    args = [q, k_pages, v_pages, k_scales, v_scales, lengths_i, pages_i]
    req(all(a.is_contiguous() for a in args if a is not None),
        'inputs must be contiguous')
    steps, chunks, scores = 0, 0, None
    if paged_route(q.dtype) == 'split':
        req(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
            'pages must start on a 16-byte boundary')
        chunks, steps = paged_split_plan(pps, ps, quant)
        spill = paged_split_scores(steps, g, d, ps, quant)
        if spill:
            scores = torch.empty((b * kv * chunks, spill),
                                 dtype=torch.float32, device=q.device)
    else:
        smem = 4 * (ps * (d + 1) + 2 * g * d + g * ps + 2 * g)
        req(smem <= SMEM_LIMIT, f'{smem} B of shared memory exceeds the '
            f'kernel envelope of {SMEM_LIMIT} B')
    o = torch.empty_like(q)
    p = _build.ptr
    err = _build.lib().spt_paged_attention(
        code, int(quant), *[p(a) for a in args], p(o), b, hq, kv, d, n_pages,
        ps, pps, float(scale), steps, chunks, p(scores), _build.stream())
    _build.check(err, 'paged_attention')
    paged_attention.launches += 1
    return o


paged_attention.launches = 0
