"""Fused lm_head + greedy argmax (port of spt_proto_tpu/ops/pallas/lm_head.py).

`lm_head_argmax` launches csrc/lm_head.cu for CUDA tensors and runs the
plain twin `lm_head_argmax_ref` for CPU tensors. Logits are rounded to the
serving dtype before the compare and ties go to the lowest index, so the
winner equals argmax over the unfused dtype logits; the [B, V] logits are
never stored by the kernel.
"""
from __future__ import annotations

import torch

from spt_proto_tpu_torch import _build

HEAD_TILE = 128   # vocabulary columns per CTA (csrc/lm_head.cu kHeadTile)


def lm_head_argmax_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, D] @ w [D, V] -> greedy token ids [B] int32 (plain twin)."""
    logits = (x.float() @ w.float()).to(x.dtype).float()
    return torch.argmax(logits, dim=-1).to(torch.int32)   # first maximum


def lm_head_argmax(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, D] @ w [D, V] -> greedy token ids [B] int32, streaming W."""
    if not _build.on_cuda(x, w):
        return lm_head_argmax_ref(x, w)
    b, d = x.shape
    v = w.shape[1]
    _build.require(w.dtype == x.dtype and w.shape[0] == d,
                   f'w {tuple(w.shape)} {w.dtype} vs x {tuple(x.shape)} '
                   f'{x.dtype}')
    _build.require(x.is_contiguous() and w.is_contiguous(),
                   'inputs must be contiguous')
    _build.require(8 * d * 4 <= 200 * 1024, f'd_model {d} too wide')
    code = _build.dtype_code(x)
    n_tiles = -(-v // HEAD_TILE)
    pval = torch.empty((n_tiles, b), dtype=torch.float32, device=x.device)
    pidx = torch.empty((n_tiles, b), dtype=torch.int32, device=x.device)
    out = torch.empty((b,), dtype=torch.int32, device=x.device)
    p = _build.ptr
    err = _build.lib().spt_lm_head_argmax(
        code, p(x), p(w), p(pval), p(pidx), p(out), b, d, v,
        _build.stream())
    _build.check(err, 'lm_head_argmax')
    lm_head_argmax.launches += 1
    return out


lm_head_argmax.launches = 0
