"""PQ-driven block-sparse causal attention, forward (port of the forward of
spt_proto_tpu/ops/pallas/block_sparse_attention.py).

`block_sparse_attention` launches csrc/block_sparse_attention.cu for CUDA
tensors and runs the plain twin ops.block_sparse.block_sparse_attention_ref
for CPU tensors. The TPU package chooses between two forward kernels
(_fwd_v3 while K+V fit VMEM, else _fwd); both compute the same function and
one Hopper kernel replaces them. The backward comes with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from spt_proto_tpu_torch import _build
from spt_proto_tpu_torch.ops.block_sparse import block_sparse_attention_ref


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, sel: torch.Tensor, *,
                           block_q: int = 128, block_k: int = 128,
                           scale: float,
                           clamp: Optional[float] = 10.0) -> torch.Tensor:
    """q/k/v [B, S, D]; sel [B, S//block_q, n_sel] int32 ascending selected
    key tiles, -1 = invalid (ops.block_sparse.select_tiles). Returns
    [B, S, D]."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f'q/k/v shapes differ: {q.shape} {k.shape} {v.shape}')
    b, s, d = q.shape
    if s % block_q or s % block_k:
        raise ValueError(f'S={s} must be a multiple of block_q={block_q} and '
                         f'block_k={block_k}')
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            'block_sparse_attention backward comes with the training slice')
    if not _build.on_cuda(q, k, v, sel):
        return block_sparse_attention_ref(q, k, v, sel, block_q=block_q,
                                          block_k=block_k, scale=scale,
                                          clamp=clamp)
    req = _build.require
    req(k.dtype == q.dtype and v.dtype == q.dtype, 'q/k/v dtypes differ')
    code = _build.dtype_code(q)
    req(block_k == 128 and block_q % 64 == 0 and d in (64, 128),
        f'kernel takes block_k 128, block_q a multiple of 64 and d_head 64 '
        f'or 128 (got {block_k}, {block_q}, {d})')
    n_qt = s // block_q
    req(sel.dtype == torch.int32 and sel.dim() == 3
        and sel.shape[:2] == (b, n_qt), f'sel {tuple(sel.shape)} {sel.dtype}')
    req(all(t.is_contiguous() for t in (q, k, v, sel)),
        'inputs must be contiguous')
    o = torch.empty_like(q)
    p = _build.ptr
    err = _build.lib().spt_block_sparse_fwd(
        code, p(q), p(k), p(v), p(sel), p(o), b, s, d, n_qt, sel.shape[2],
        block_q, float(scale), float(clamp or 0.0), int(clamp is not None),
        _build.stream())
    _build.check(err, 'block_sparse_attention')
    block_sparse_attention.launches += 1
    return o


block_sparse_attention.launches = 0
