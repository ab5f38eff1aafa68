"""Fused lm_head + greedy argmax (port of spt_proto_tpu/ops/pallas/lm_head.py).

`lm_head_argmax` (bf16/f32 W) and `lm_head_argmax_int8` (int8 weight-only
W) launch csrc/lm_head.cu for CUDA tensors and run their plain twins for
CPU tensors. Logits are rounded to the serving dtype before the compare and
ties go to the lowest index, so the winner equals argmax over the unfused
dtype logits; the [B, V] logits are never stored by the kernels. The int8
form has int8_matmul's numerics (x rounded to bf16, f32 partials per K
chunk added in ascending order, then the per-column scale), and masks the
lanes at or past the TRUE vocab (the scale's width, not q's padded one).

value=True also returns the logit each row chose, f32 [B]: the value the
kernel compared (the dtype-rounded logit its reduce kept), so that ranks
of a vocab-parallel head agree on a global first maximum from the numbers
that decided each rank's own (engine._greedy_head); the twins return the
same pair.
"""
from __future__ import annotations

import torch

from spt_proto_tpu_torch import _build
from spt_proto_tpu_torch.ops.int8_matmul import SKINNY_M, int8_dot

HEAD_TILE = 128   # the narrowest CTA tile (csrc/lm_head.cu kHeadTile, f32):
                  # sizes the per-tile partials of either kernel
F32_MAX_D = 6400  # the f32 kernel's x staging: 8 x d x 4 bytes <= 200 KB


def _check_layout(x: torch.Tensor, w: torch.Tensor) -> None:
    """What the kernels take beyond shapes and dtypes: in f32 d <= F32_MAX_D
    (x staged at full width); in bf16 16-byte aligned rows and bases of x
    and w (the weight stream's copies)."""
    d = x.shape[1]
    if x.dtype == torch.float32:
        _build.require(d <= F32_MAX_D, f'd_model {d} too wide for the f32 '
                       f'kernel (at most {F32_MAX_D})')
        return
    _build.require(d % 8 == 0 and w.shape[1] * w.element_size() % 16 == 0
                   and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                   f'x [{x.shape[0]}, {d}] and w [{d}, {w.shape[1]}] '
                   f'{w.dtype} need 16-byte aligned rows')


def _first_max(logits: torch.Tensor, value: bool):
    ids = torch.argmax(logits, dim=-1).to(torch.int32)    # first maximum
    if not value:
        return ids
    return ids, logits.gather(-1, ids.long()[:, None])[:, 0]


def lm_head_argmax_ref(x: torch.Tensor, w: torch.Tensor, *,
                       value: bool = False):
    """x [B, D] @ w [D, V] -> greedy token ids [B] int32 (plain twin); with
    value=True (ids, the chosen logits [B] f32)."""
    logits = (x.float() @ w.float()).to(x.dtype).float()
    return _first_max(logits, value)


def lm_head_argmax(x: torch.Tensor, w: torch.Tensor, *, value: bool = False):
    """x [B, D] @ w [D, V] -> greedy token ids [B] int32, streaming W; with
    value=True (ids, the chosen logits [B] f32)."""
    if not _build.on_cuda(x, w):
        return lm_head_argmax_ref(x, w, value=value)
    b, d = x.shape
    v = w.shape[1]
    _build.require(w.dtype == x.dtype and w.shape[0] == d,
                   f'w {tuple(w.shape)} {w.dtype} vs x {tuple(x.shape)} '
                   f'{x.dtype}')
    _build.require(x.is_contiguous() and w.is_contiguous(),
                   'inputs must be contiguous')
    _check_layout(x, w)
    code = _build.dtype_code(x)
    n_tiles = -(-v // HEAD_TILE)
    pval = torch.empty((n_tiles, b), dtype=torch.float32, device=x.device)
    pidx = torch.empty((n_tiles, b), dtype=torch.int32, device=x.device)
    out = torch.empty((b,), dtype=torch.int32, device=x.device)
    val = (torch.empty((b,), dtype=torch.float32, device=x.device)
           if value else None)
    p = _build.ptr
    err = _build.lib().spt_lm_head_argmax(
        code, p(x), p(w), p(pval), p(pidx), p(out), p(val), b, d, v,
        _build.stream())
    _build.check(err, 'lm_head_argmax')
    lm_head_argmax.launches += 1
    return (out, val) if value else out


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


def lm_head_argmax_int8_ref(x: torch.Tensor, wq: dict, *,
                            value: bool = False):
    """Plain twin: x [B, D], wq {'q': [D, V_pad] int8, 'scale': [V] f32}
    -> greedy token ids [B] int32; with value=True (ids, the chosen logits
    [B] f32)."""
    return _first_max(int8_head_logits(x, wq['q'], wq['scale']), value)


def lm_head_argmax_int8(x: torch.Tensor, wq: dict, *, value: bool = False):
    """Greedy token ids [B] int32 from an int8 lm_head, streaming the int8
    weight; lanes at or past the true vocab never win. value=True: (ids,
    the chosen logits [B] f32)."""
    q, scale = wq['q'], wq['scale']
    if not _build.on_cuda(x, q, scale):
        return lm_head_argmax_int8_ref(x, wq, value=value)
    b, d = x.shape
    v, v_pad = scale.numel(), q.shape[1]
    req = _build.require
    req(q.dtype == torch.int8 and q.shape[0] == d and v <= v_pad
        and scale.dtype == torch.float32,
        f'q {tuple(q.shape)} {q.dtype} / scale [{v}] {scale.dtype} vs x '
        f'{tuple(x.shape)}')
    req(x.is_contiguous() and q.is_contiguous() and scale.is_contiguous(),
        'inputs must be contiguous')
    _check_layout(x, q)
    code = _build.dtype_code(x)
    n_tiles = -(-v // HEAD_TILE)
    pval = torch.empty((n_tiles, b), dtype=torch.float32, device=x.device)
    pidx = torch.empty((n_tiles, b), dtype=torch.int32, device=x.device)
    out = torch.empty((b,), dtype=torch.int32, device=x.device)
    val = (torch.empty((b,), dtype=torch.float32, device=x.device)
           if value else None)
    p = _build.ptr
    err = _build.lib().spt_lm_head_argmax_int8(
        code, p(x), p(q), p(scale), p(pval), p(pidx), p(out), p(val), b, d,
        v, v_pad, int8_head_block_k(b, d), _build.stream())
    _build.check(err, 'lm_head_argmax_int8')
    lm_head_argmax_int8.launches += 1
    return (out, val) if value else out


lm_head_argmax_int8.launches = 0
