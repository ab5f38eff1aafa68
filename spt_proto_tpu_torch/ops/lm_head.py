"""Fused lm_head + greedy argmax (port of spt_proto_tpu/ops/pallas/lm_head.py).

`lm_head_argmax` (bf16/f32 W) and `lm_head_argmax_int8` (int8 weight-only
W) launch csrc/lm_head.cu for CUDA tensors and run their plain twins for
CPU tensors. Logits are rounded to the serving dtype before the compare and
ties go to the lowest index, so the winner equals argmax over the unfused
dtype logits; the [B, V] logits are never stored by the kernels. The int8
form has int8_matmul's numerics (x rounded to bf16, f32 partials per K
chunk added in ascending order, then the per-column scale), and masks the
lanes at or past the TRUE vocab (the scale's width, not q's padded one).
"""
from __future__ import annotations

import torch

from spt_proto_tpu_torch import _build
from spt_proto_tpu_torch.ops.int8_matmul import SKINNY_M, int8_dot

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


def int8_head_block_k(b: int, d: int) -> int:
    """K chunk of the int8 head: int8_matmul's rule for this m, or the
    whole row when d is not a multiple of 128 (lm_head.py:148-153)."""
    if b < SKINNY_M and d % 256 == 0:
        return 256
    return 128 if d % 128 == 0 else d


def int8_head_logits(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """The int8 head's logits [B, V] (true vocab), rounded to x's dtype and
    returned as f32: what the kernel compares."""
    b, d = x.shape
    v = scale.numel()
    acc = int8_dot(x, q[:, :v], int8_head_block_k(b, d))
    return (acc * scale.reshape(1, v).float()).to(x.dtype).float()


def lm_head_argmax_int8_ref(x: torch.Tensor, wq: dict) -> torch.Tensor:
    """Plain twin: x [B, D], wq {'q': [D, V_pad] int8, 'scale': [V] f32}
    -> greedy token ids [B] int32."""
    logits = int8_head_logits(x, wq['q'], wq['scale'])
    return torch.argmax(logits, dim=-1).to(torch.int32)   # first maximum


def lm_head_argmax_int8(x: torch.Tensor, wq: dict) -> torch.Tensor:
    """Greedy token ids [B] int32 from an int8 lm_head, streaming the int8
    weight; lanes at or past the true vocab never win."""
    q, scale = wq['q'], wq['scale']
    if not _build.on_cuda(x, q, scale):
        return lm_head_argmax_int8_ref(x, wq)
    b, d = x.shape
    v, v_pad = scale.numel(), q.shape[1]
    req = _build.require
    req(q.dtype == torch.int8 and q.shape[0] == d and v <= v_pad
        and scale.dtype == torch.float32,
        f'q {tuple(q.shape)} {q.dtype} / scale [{v}] {scale.dtype} vs x '
        f'{tuple(x.shape)}')
    req(x.is_contiguous() and q.is_contiguous() and scale.is_contiguous(),
        'inputs must be contiguous')
    req(8 * d * 4 <= 200 * 1024, f'd_model {d} too wide')
    code = _build.dtype_code(x)
    n_tiles = -(-v // HEAD_TILE)
    pval = torch.empty((n_tiles, b), dtype=torch.float32, device=x.device)
    pidx = torch.empty((n_tiles, b), dtype=torch.int32, device=x.device)
    out = torch.empty((b,), dtype=torch.int32, device=x.device)
    p = _build.ptr
    err = _build.lib().spt_lm_head_argmax_int8(
        code, p(x), p(q), p(scale), p(pval), p(pidx), p(out), b, d, v, v_pad,
        int8_head_block_k(b, d), _build.stream())
    _build.check(err, 'lm_head_argmax_int8')
    lm_head_argmax_int8.launches += 1
    return out


lm_head_argmax_int8.launches = 0
