"""PQ-driven block-sparse causal attention with its backward (port of
spt_proto_tpu/ops/pallas/block_sparse_attention.py).

`block_sparse_attention` is differentiable: with an input that requires
grad it runs a `torch.autograd.Function` whose forward also writes the
per-row log-sum-exp and saves (q, k, v, sel, o, lse), and whose backward
computes dd = sum(g * o) in f32 as plain torch (JAX computes it outside its
kernels too) and then the dq and dk/dv kernels.

Each wrapper launches its kernel in csrc/block_sparse_attention.cu for CUDA
tensors and runs its plain twin for CPU tensors:
  block_sparse_attention      -> ops.block_sparse.block_sparse_attention_ref
  block_sparse_attention_lse  -> block_sparse_attention_lse_ref
  block_sparse_attention_dq   \\
  block_sparse_attention_dkv  -> block_sparse_attention_bwd_ref (through
                                 block_sparse_attention_bwd)
The TPU package chooses between forward kernels (_fwd_v3 while K+V fit
VMEM, else _fwd, and _fwd_dma) and between backward pairs (_bwd_kernels_v3,
_bwd_kernels); each choice computes the same function and one Hopper kernel
(one pair for the backward) replaces it. `fwd_route` picks the forward's
kernel: bf16 at the prefill tiles runs block_sparse_fwd_kernel_tc (the
tensor cores), f32 and shapes off that rule block_sparse_fwd_kernel.
`bwd_route` picks the backward's pair on the same rule: bf16 runs
block_sparse_dq_kernel_tc and block_sparse_dkv_kernel_tc, f32 and the
shapes off the rule block_sparse_dq_kernel and block_sparse_dkv_kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from spt_proto_tpu_torch import _build
from spt_proto_tpu_torch.ops.block_sparse import (NEG_INF,
                                                  block_sparse_attention_ref)


def _check(q, k, v, sel, block_q, block_k):
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f'q/k/v shapes differ: {q.shape} {k.shape} {v.shape}')
    s = q.shape[1]
    if s % block_q or s % block_k:
        raise ValueError(f'S={s} must be a multiple of block_q={block_q} and '
                         f'block_k={block_k}')


def _check_kernel(q, k, v, sel, block_q, block_k, *rest):
    """What the CUDA kernels take; raises otherwise."""
    req = _build.require
    b, s, d = q.shape
    req(k.dtype == q.dtype and v.dtype == q.dtype, 'q/k/v dtypes differ')
    req(block_k == 128 and block_q % 64 == 0 and d in (64, 128),
        f'kernel takes block_k 128, block_q a multiple of 64 and d_head 64 '
        f'or 128 (got {block_k}, {block_q}, {d})')
    req(sel.dtype == torch.int32 and sel.dim() == 3
        and sel.shape[:2] == (b, s // block_q),
        f'sel {tuple(sel.shape)} {sel.dtype}')
    req(all(t.is_contiguous() for t in (q, k, v, sel, *rest)),
        'inputs must be contiguous')


# warps a tensor-core forward CTA, by d_head (16 query rows each): at d 64
# 4 warps (two CTAs an SM) ran faster than 8, at d 128 slower
# (kernel_ab.py --attn-sweep)
FWD_WARPS = {64: 4, 128: 8}


def fwd_route(dtype: torch.dtype, d: int, block_q: int, block_k: int,
              aligned: bool = True) -> str:
    """The kernel a forward launch runs: 'tc' (block_sparse_fwd_kernel_tc,
    the tensor cores) for bf16 q/k/v at d_head 64 or 128, block_k 128, a
    block_q multiple of 128 and 16-byte aligned q, k and v (`aligned`);
    else 'cuda_core' (block_sparse_fwd_kernel)."""
    if (dtype == torch.bfloat16 and d in (64, 128) and block_k == 128
            and block_q % 128 == 0 and aligned):
        return 'tc'
    return 'cuda_core'


def bwd_route(dtype: torch.dtype, d: int, block_q: int, block_k: int,
              aligned: bool = True) -> str:
    """The kernels a backward launch runs: 'tc' (block_sparse_dq_kernel_tc
    and block_sparse_dkv_kernel_tc, the tensor cores) for bf16 q/k/v/g at
    d_head 64 or 128, block_k 128, a block_q multiple of 128 and 16-byte
    aligned q, k, v, g, lse and dd (`aligned`); else 'cuda_core'
    (block_sparse_dq_kernel, block_sparse_dkv_kernel). The forward's rule
    (fwd_route)."""
    return fwd_route(dtype, d, block_q, block_k, aligned)


# the tensor-core backward's plan by d_head: keys a dq step (a tile is
# walked in steps of this many keys) and query rows a dk/dv chunk; the
# library holds 32 / 64 keys at d 64 and 32 at d 128, and 16 / 32 / 64
# rows at d 64 and 16 / 32 at d 128. From kernel_ab.py --bsa-bwd's sweep
# (H100 80GB HBM3, 700 W, cold L2, mean of two runs, us at 96 x 512 x 64 /
# 96 x 2048 x 64 coeff 8 / coeff 4): dq 32 keys 38.4 / 100.0 / 199.4
# against 64 keys 41.8 / 120.6 / 240.0 (164 registers a thread against
# 232: three CTAs an SM against two); dk/dv 32 rows 45.7 / 123.0 / 316.3
# against 16 rows 47.4 / 122.1 / 337.8 and 64 rows 49.4 / 145.2 / 351.4; at
# d 128 (32 x 2048 coeff 4) 32 rows 214.8 against 16 rows 249.6
BWD_DQ_KEYS = {64: 32, 128: 32}
BWD_DKV_ROWS = {64: 32, 128: 32}


def _launch_fwd(q, k, v, sel, lse, block_q, scale, clamp):
    b, s, d = q.shape
    o = torch.empty_like(q)
    p = _build.ptr
    tc = fwd_route(q.dtype, d, block_q, 128, all(
        t.data_ptr() % 16 == 0 for t in (q, k, v))) == 'tc'
    err = _build.lib().spt_block_sparse_fwd(
        _build.dtype_code(q), FWD_WARPS[d] if tc else 0, p(q), p(k), p(v),
        p(sel), p(o), p(lse), b, s, d, s // block_q, sel.shape[2], block_q,
        float(scale), float(clamp or 0.0), int(clamp is not None),
        _build.stream())
    _build.check(err, 'block_sparse_attention')
    return o


def _forward(q, k, v, sel, block_q, block_k, scale, clamp):
    """The forward without lse (inference)."""
    if not _build.on_cuda(q, k, v, sel):
        return block_sparse_attention_ref(q, k, v, sel, block_q=block_q,
                                          block_k=block_k, scale=scale,
                                          clamp=clamp)
    _check_kernel(q, k, v, sel, block_q, block_k)
    o = _launch_fwd(q, k, v, sel, None, block_q, scale, clamp)
    block_sparse_attention.launches += 1
    return o


def block_sparse_attention_lse_ref(q, k, v, sel, *, block_q: int,
                                   block_k: int, scale: float,
                                   clamp: Optional[float] = 10.0):
    """Plain twin of the forward with log-sum-exp: (o [B, S, D] in q's
    dtype, lse [B, S] f32 = m + log(max(l, 1e-9)) over the clamped, causally
    masked selected tiles)."""
    b, s, d = q.shape
    o = block_sparse_attention_ref(q, k, v, sel, block_q=block_q,
                                   block_k=block_k, scale=scale, clamp=clamp)
    scores, valid, _, _ = _tile_scores(q, k, sel, block_q, block_k, scale,
                                       clamp)
    n_qt = s // block_q
    vflat = valid.reshape(b, n_qt, block_q, -1)
    flat = torch.where(vflat, scores.reshape(vflat.shape), NEG_INF)
    m = flat.amax(-1, keepdim=True)
    e = torch.where(vflat, torch.exp(flat - m), 0.0)
    lse = m[..., 0] + torch.log(e.sum(-1).clamp(min=1e-9))
    return o, lse.reshape(b, s)


def block_sparse_attention_lse(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, sel: torch.Tensor, *,
                               block_q: int = 128, block_k: int = 128,
                               scale: float, clamp: Optional[float] = 10.0):
    """The forward that also returns the per-row log-sum-exp: (o, lse
    [B, S] f32)."""
    _check(q, k, v, sel, block_q, block_k)
    if not _build.on_cuda(q, k, v, sel):
        return block_sparse_attention_lse_ref(q, k, v, sel, block_q=block_q,
                                              block_k=block_k, scale=scale,
                                              clamp=clamp)
    _check_kernel(q, k, v, sel, block_q, block_k)
    b, s, _ = q.shape
    lse = torch.empty((b, s), dtype=torch.float32, device=q.device)
    o = _launch_fwd(q, k, v, sel, lse, block_q, scale, clamp)
    block_sparse_attention_lse.launches += 1
    return o, lse


def _tile_scores(q, k, sel, block_q, block_k, scale, clamp):
    """Pre-clip scaled scores [B, nq, Bq, n_sel, Bk] f32 of the selected
    tiles, their validity (col <= row, sel >= 0), and the safe tile ids and
    gathered-tile index used to read k/v tiles."""
    b, s, d = q.shape
    n_qt, n_kt = s // block_q, s // block_k
    dev = q.device
    safe = sel.long().clamp(min=0)
    bi = torch.arange(b, device=dev)[:, None, None]
    k_sel = k.reshape(b, n_kt, block_k, d)[bi, safe]      # [B,nq,ns,Bk,D]
    s_pre = torch.einsum('bqid,bqsjd->bqisj',
                         q.reshape(b, n_qt, block_q, d).float(),
                         k_sel.float()) * scale
    scores = s_pre if clamp is None else s_pre.clamp(-clamp, clamp)
    rows = (torch.arange(n_qt, device=dev)[:, None] * block_q
            + torch.arange(block_q, device=dev)[None, :])
    cols = safe[..., None] * block_k + torch.arange(block_k, device=dev)
    valid = (cols[:, :, None, :, :] <= rows[None, :, :, None, None]) & \
        (sel[:, :, None, :, None] >= 0)
    return scores, valid, s_pre, safe


def block_sparse_attention_bwd_ref(q, k, v, sel, o, lse, g, *, block_q: int,
                                   block_k: int, scale: float,
                                   clamp: Optional[float] = 10.0):
    """Plain twin of the backward kernels' math: (dq, dk, dv) in q/k/v's
    dtypes. p = exp(clip(s) - lse) on the valid entries, ds = p (do.v - dd)
    zeroed where |s| > clamp; ds is rounded to k's (dq) and q's (dk) dtype
    and p to do's (dv) before the products, as the TPU kernels feed their
    MXU. Tiles nobody selected get zero dk / dv."""
    b, s, d = q.shape
    n_qt, n_kt = s // block_q, s // block_k
    dev = q.device
    scores, valid, s_pre, safe = _tile_scores(q, k, sel, block_q, block_k,
                                              scale, clamp)
    dd = (g.float() * o.float()).sum(-1).reshape(b, n_qt, block_q)
    lse_t = lse.float().reshape(b, n_qt, block_q)
    p = torch.where(valid, torch.exp(scores - lse_t[..., None, None]), 0.0)
    bi = torch.arange(b, device=dev)[:, None, None]
    v_sel = v.reshape(b, n_kt, block_k, d)[bi, safe]
    k_sel = k.reshape(b, n_kt, block_k, d)[bi, safe]
    gt = g.reshape(b, n_qt, block_q, d)
    dp = torch.einsum('bqid,bqsjd->bqisj', gt.float(), v_sel.float())
    ds = p * (dp - dd[..., None, None])
    if clamp is not None:
        ds = torch.where(s_pre.abs() <= clamp, ds, 0.0)
    dq = torch.einsum('bqisj,bqsjd->bqid', ds.to(k.dtype).float(),
                      k_sel.float()) * scale
    qt_f = q.reshape(b, n_qt, block_q, d).float()
    dk_sel = torch.einsum('bqisj,bqid->bqsjd', ds.to(q.dtype).float(), qt_f)
    dv_sel = torch.einsum('bqisj,bqid->bqsjd', p.to(g.dtype).float(),
                          gt.float())
    # scatter-add each selected tile's share into its key tile (invalid
    # slots carry zeros: their p is 0)
    flat_idx = (torch.arange(b, device=dev)[:, None, None] * n_kt
                + safe).reshape(-1)
    dk = torch.zeros((b * n_kt, block_k, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    dk.index_add_(0, flat_idx, dk_sel.reshape(-1, block_k, d))
    dv.index_add_(0, flat_idx, dv_sel.reshape(-1, block_k, d))
    return (dq.reshape(b, s, d).to(q.dtype),
            (dk * scale).reshape(b, s, d).to(k.dtype),
            dv.reshape(b, s, d).to(v.dtype))


def reverse_table(sel: torch.Tensor, n_kt: int) -> torch.Tensor:
    """rsel [B, n_kt, n_qt] int32: the q tiles whose selection holds each
    key tile, ascending, -1 padded (JAX's _reverse_table)."""
    b, n_qt, n_sel = sel.shape
    dev = sel.device
    hits = torch.zeros((b, n_kt + 1, n_qt), dtype=torch.int32, device=dev)
    kt = torch.where(sel >= 0, sel.long(), n_kt)           # -1 -> spare row
    bi = torch.arange(b, device=dev)[:, None, None].expand_as(kt)
    qt = torch.arange(n_qt, device=dev)[None, :, None].expand_as(kt)
    hits[bi, kt, qt] = 1
    hits = hits[:, :n_kt]
    order = torch.sort(1 - hits, dim=-1, stable=True).indices  # hits first
    taken = hits.gather(-1, order)
    return torch.where(taken > 0, order, -1).to(torch.int32).contiguous()


def _launch_bwd(q, k, v, g, lse, dd, sel, rsel, dq, dk, dv, block_q, scale,
                clamp, name):
    b, s, d = q.shape
    p = _build.ptr
    tc = bwd_route(q.dtype, d, block_q, 128, all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, g, lse, dd))) == 'tc'
    err = _build.lib().spt_block_sparse_bwd(
        _build.dtype_code(q), BWD_DQ_KEYS[d] if tc else 0,
        BWD_DKV_ROWS[d] if tc else 0, p(q), p(k), p(v), p(g), p(lse), p(dd),
        p(sel), p(rsel), p(dq), p(dk), p(dv), b, s, d, s // block_q,
        sel.shape[2], block_q, float(scale), float(clamp or 0.0),
        int(clamp is not None), _build.stream())
    _build.check(err, name)


def block_sparse_attention_dq(q, k, v, sel, g, lse, dd, *, block_q: int,
                              block_k: int, scale: float,
                              clamp: Optional[float] = 10.0) -> torch.Tensor:
    """dq kernel (CUDA tensors only): lse and dd [B, S] f32, g the output
    gradient."""
    _check_kernel(q, k, v, sel, block_q, block_k, g, lse, dd)
    dq = torch.empty_like(q)
    _launch_bwd(q, k, v, g, lse, dd, sel, None, dq, None, None, block_q,
                scale, clamp, 'block_sparse_attention_dq')
    block_sparse_attention_dq.launches += 1
    return dq


def block_sparse_attention_dkv(q, k, v, sel, rsel, g, lse, dd, *,
                               block_q: int, block_k: int, scale: float,
                               clamp: Optional[float] = 10.0):
    """dk/dv kernel (CUDA tensors only), walking the reverse table rsel
    (`reverse_table`)."""
    _check_kernel(q, k, v, sel, block_q, block_k, rsel, g, lse, dd)
    b, s, _ = q.shape
    _build.require(rsel.dtype == torch.int32
                   and rsel.shape == (b, s // block_k, s // block_q),
                   f'rsel {tuple(rsel.shape)} {rsel.dtype}')
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd(q, k, v, g, lse, dd, sel, rsel, None, dk, dv, block_q, scale,
                clamp, 'block_sparse_attention_dkv')
    block_sparse_attention_dkv.launches += 1
    return dk, dv


def block_sparse_attention_bwd(q, k, v, sel, o, lse, g, *, block_q: int,
                               block_k: int, scale: float,
                               clamp: Optional[float] = 10.0):
    """(dq, dk, dv) from the forward's saved tensors and the output
    gradient g: the two kernels for CUDA tensors, the plain twin for CPU
    ones."""
    if not _build.on_cuda(q, k, v, sel, o, lse, g):
        return block_sparse_attention_bwd_ref(
            q, k, v, sel, o, lse, g, block_q=block_q, block_k=block_k,
            scale=scale, clamp=clamp)
    g = g.contiguous()
    dd = (g.float() * o.float()).sum(-1)                 # [B, S] f32
    kw = dict(block_q=block_q, block_k=block_k, scale=scale, clamp=clamp)
    dq = block_sparse_attention_dq(q, k, v, sel, g, lse, dd, **kw)
    rsel = reverse_table(sel, q.shape[1] // block_k)
    dk, dv = block_sparse_attention_dkv(q, k, v, sel, rsel, g, lse, dd, **kw)
    return dq, dk, dv


class _BlockSparseAttention(torch.autograd.Function):
    """The forward with lse, the backward through the dq and dk/dv
    kernels (JAX's custom_vjp with bwd_impl='kernel')."""

    @staticmethod
    def forward(ctx, q, k, v, sel, block_q, block_k, scale, clamp):
        o, lse = block_sparse_attention_lse(q, k, v, sel, block_q=block_q,
                                            block_k=block_k, scale=scale,
                                            clamp=clamp)
        ctx.save_for_backward(q, k, v, sel, o, lse)
        ctx.kw = dict(block_q=block_q, block_k=block_k, scale=scale,
                      clamp=clamp)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, sel, o, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_attention_bwd(q, k, v, sel, o, lse, g,
                                                **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, sel: torch.Tensor, *,
                           block_q: int = 128, block_k: int = 128,
                           scale: float,
                           clamp: Optional[float] = 10.0) -> torch.Tensor:
    """q/k/v [B, S, D]; sel [B, S//block_q, n_sel] int32 ascending selected
    key tiles, -1 = invalid (ops.block_sparse.select_tiles). Returns
    [B, S, D]; differentiable in q, k and v."""
    _check(q, k, v, sel, block_q, block_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BlockSparseAttention.apply(q, k, v, sel, block_q, block_k,
                                           scale, clamp)
    return _forward(q, k, v, sel, block_q, block_k, scale, clamp)


block_sparse_attention.launches = 0
block_sparse_attention_lse.launches = 0
block_sparse_attention_dq.launches = 0
block_sparse_attention_dkv.launches = 0
