"""Grouped matmuls over rows sorted by group (port of the stock Pallas TPU
megablox kernels: megablox/gmm.py `gmm` and `tgmm`, and the custom VJP of
megablox/ops.py that pairs them), the routed FFN's
flop-proportional dispatch (ops/routed_ffn.py, ffn_impl='gmm').

`group_sizes` [G] int32 splits the rows of `lhs` into consecutive groups:
group g owns rows [sum(sizes[:g]), sum(sizes[:g + 1])). It stays on the
device: the kernels build their tile schedule from it there, so nothing is
read back to the host.

- `gmm(lhs [m, k], rhs [G, k, n], group_sizes)` -> [m, n]: each group's
  rows times its own rhs; `transpose_rhs=True` takes rhs as [G, n, k]. rhs
  may be any strided view (the routed FFN's block views of the dense
  kernels are), lhs must be contiguous. Rows outside every group are 0.
- `tgmm(lhs [m, k], rhs [m, n], group_sizes)` -> [G, k, n] f32: per group
  lhs[rows]^T @ rhs[rows]; an empty group gives zeros.
- `GroupedMatmul` / `grouped_matmul`: gmm with megablox's VJP, dlhs =
  gmm(grad, rhs, transpose_rhs=not transpose_rhs) and drhs = tgmm(lhs,
  grad), each computed only when its input needs a gradient (a frozen rhs
  gets no tgmm launch).

The wrappers launch csrc/gmm.cu for CUDA tensors and run the plain twins
(`gmm_ref`, `tgmm_ref`, a loop over the groups) for CPU tensors. Both sum
in f32 (bf16 inputs multiply exactly) and round once; only the order of
the sums differs (megablox's 128-wide tiles of k, the kernels' 16-wide
steps).

Which kernel, by dtype and shape alone:
- gmm with bf16 lhs, rhs and output, k and n multiples of 8, rhs
  N-contiguous (stride 1 along n, the k and group strides multiples of 8)
  or K-contiguous (stride 1 along k, the n and group strides multiples of
  8), lhs and rhs 16-byte aligned: the tensor-core `gmm_tc_kernel`, its
  tile shape by `gmm_tile(k, n)`: narrow for n <= 16 / 32, thin for k <=
  32, wide otherwise;
- tgmm with bf16 inputs, k and n multiples of 8, both 16-byte aligned: the
  tensor-core `tgmm_tc_kernel` + `tgmm_reduce_kernel`, tile shape and row
  split by `tgmm_plan`;
- everything else (f32; an f32 output from bf16 inputs; other shapes,
  strides or alignments): the CUDA-core / 32-bit-load kernels `gmm_kernel`
  and `tgmm_kernel`.
"""
from __future__ import annotations

from typing import Optional

import torch

from spt_proto_tpu_torch import _build

# tile shapes of the tensor-core kernels: the codes of csrc/gmm.cu's
# spt_gmm_tc (GmmWide, GmmNarrow16, GmmNarrow32, GmmThin) and spt_tgmm_tc
# (TgmmWide, TgmmNarrow16, TgmmNarrow32)
WIDE, NARROW16, NARROW32, THIN = 0, 1, 2, 3
TILE_NAMES = ('wide', 'narrow16', 'narrow32', 'thin')
# tgmm's (k tile, n tile, rows a step) by tile code (csrc/gmm.cu Tgmm*)
TGMM_TILES = {WIDE: (128, 64, 32), NARROW16: (64, 16, 64),
              NARROW32: (64, 32, 64)}
# tgmm's row split: the grid aims at this many CTAs an SM (one wave of the
# narrow tiles), or takes whole groups when the (k, n) tiles of the groups
# give at least TGMM_WHOLE_GROUPS an SM by themselves
TGMM_CTAS_PER_SM = 3
TGMM_WHOLE_GROUPS = 2


def _bounds(group_sizes: torch.Tensor, m: int):
    """[(group, start, end)] of the non-empty groups, clipped to m rows
    (the twins read the sizes back; the kernels never do)."""
    out, start = [], 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + int(size), m)
        if end > start:
            out.append((g, start, end))
        start = max(start, end)
    return out


def gmm_ref(lhs: torch.Tensor, rhs: torch.Tensor,
            group_sizes: torch.Tensor, *, transpose_rhs: bool = False,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain twin of gmm: f32 products per group, cast to out_dtype (lhs's
    dtype by default)."""
    w = rhs.transpose(1, 2) if transpose_rhs else rhs
    out = torch.zeros((lhs.shape[0], w.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    for g, s, e in _bounds(group_sizes, lhs.shape[0]):
        out[s:e] = lhs[s:e].float() @ w[g].float()
    return out.to(out_dtype or lhs.dtype)


def tgmm_ref(lhs: torch.Tensor, rhs: torch.Tensor,
             group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain twin of tgmm: [G, k, n] f32."""
    out = torch.zeros((group_sizes.shape[0], lhs.shape[1], rhs.shape[1]),
                      dtype=torch.float32, device=lhs.device)
    for g, s, e in _bounds(group_sizes, lhs.shape[0]):
        out[g] = lhs[s:e].float().T @ rhs[s:e].float()
    return out


def _check_sizes(group_sizes: torch.Tensor, n_groups: int) -> None:
    _build.require(group_sizes.dtype == torch.int32
                   and group_sizes.shape == (n_groups,)
                   and group_sizes.is_contiguous(),
                   f'group_sizes [{n_groups}] int32, got '
                   f'{tuple(group_sizes.shape)} {group_sizes.dtype}')


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gmm_tile(k: int, n: int) -> int:
    """The tensor-core gmm's tile shape for depth k and width n: narrow N
    (64-row tiles n wide, so that ~132 CTAs stream lhs once), thin K (one
    stage of 128 x 128 tiles: bound by writing the output), else wide
    (96 x 128 tiles through a 3-stage ring)."""
    if n <= 16:
        return NARROW16
    if n <= 32:
        return NARROW32
    return THIN if k <= 32 else WIDE


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def gmm_route(lhs: torch.Tensor, rhs: torch.Tensor, *,
              transpose_rhs: bool = False,
              out_dtype: Optional[torch.dtype] = None) -> str:
    """The kernel gmm launches for these operands (the module docstring's
    rule): 'wide', 'narrow16', 'narrow32' or 'thin' with ' k-major' for a
    K-contiguous rhs (the tensor-core kernel), or 'cuda-core'."""
    kmaj = _tc_layout(lhs, rhs, transpose_rhs, out_dtype or lhs.dtype)
    if kmaj is None:
        return 'cuda-core'
    kd, n = lhs.shape[1], rhs.shape[1 if transpose_rhs else 2]
    return TILE_NAMES[gmm_tile(kd, n)] + (' k-major' if kmaj else '')


def _tc_layout(lhs, rhs, transpose_rhs, out_dtype) -> Optional[bool]:
    """Whether the tensor-core gmm's rhs is K-contiguous (True) or
    N-contiguous (False); None when the call is not one it takes."""
    s0, s1, s2 = rhs.stride()
    sk, sn = (s2, s1) if transpose_rhs else (s1, s2)
    kd, n = lhs.shape[1], rhs.shape[1 if transpose_rhs else 2]
    if (lhs.dtype != torch.bfloat16 or rhs.dtype != torch.bfloat16
            or out_dtype != torch.bfloat16 or kd % 8 or n % 8
            or (s0 % 8 and rhs.shape[0] > 1) or not _aligned(lhs, rhs)):
        return None
    if sn == 1 and sk % 8 == 0:
        return False
    if sk == 1 and sn % 8 == 0:
        return True
    return None


def tgmm_plan(m: int, k: int, n: int, n_groups: int, n_sm: int):
    """(tile, rows R of a row tile, row tiles, workspace tiles) of the
    tensor-core tgmm: R splits the contraction so that the (row tile, k
    tile, n tile) grid gives TGMM_CTAS_PER_SM CTAs an SM, or is a whole
    group (R >= m: each group one tile, written directly, no workspace)
    when the groups' (k, n) tiles alone give TGMM_WHOLE_GROUPS an SM."""
    tile = NARROW16 if n <= 16 else NARROW32 if n <= 32 else WIDE
    bk, bn, br = TGMM_TILES[tile]
    n_kn = _cdiv(k, bk) * _cdiv(n, bn)
    if n_kn * n_groups >= TGMM_WHOLE_GROUPS * n_sm:
        rows = _cdiv(max(m, 1), br) * br
    else:
        rows = max(br, _cdiv(_cdiv(m * n_kn, TGMM_CTAS_PER_SM * n_sm), br)
                   * br)
    tiles = _cdiv(m, rows) + n_groups
    return tile, rows, tiles, 0 if rows >= m else tiles


def tgmm_takes_tc(lhs: torch.Tensor, rhs: torch.Tensor) -> bool:
    """Whether tgmm launches the tensor-core kernels for these operands."""
    return (lhs.dtype == torch.bfloat16 and rhs.dtype == torch.bfloat16
            and lhs.shape[1] % 8 == 0 and rhs.shape[1] % 8 == 0
            and _aligned(lhs, rhs))


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
        transpose_rhs: bool = False,
        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """lhs [m, k] (f32 or bf16, contiguous), rhs [G, k, n] ([G, n, k] with
    transpose_rhs) of lhs's dtype, group_sizes [G] int32 -> [m, n] in
    out_dtype (lhs's dtype or f32)."""
    out_dtype = out_dtype or lhs.dtype
    if not _build.on_cuda(lhs, rhs, group_sizes):
        return gmm_ref(lhs, rhs, group_sizes, transpose_rhs=transpose_rhs,
                       out_dtype=out_dtype)
    req = _build.require
    code = _build.dtype_code(lhs)
    req(lhs.dim() == 2 and lhs.is_contiguous(), 'lhs [m, k] contiguous')
    req(rhs.dim() == 3 and rhs.dtype == lhs.dtype,
        f'rhs [G, k, n] of lhs\'s dtype, got {tuple(rhs.shape)} {rhs.dtype}')
    req(out_dtype in (lhs.dtype, torch.float32),
        f'out_dtype {out_dtype}: lhs\'s dtype or float32')
    m, kd = lhs.shape
    n_groups = rhs.shape[0]
    _check_sizes(group_sizes, n_groups)
    s0, s1, s2 = rhs.stride()
    if transpose_rhs:
        n, k_rhs, sk, sn = rhs.shape[1], rhs.shape[2], s2, s1
    else:
        n, k_rhs, sk, sn = rhs.shape[2], rhs.shape[1], s1, s2
    req(k_rhs == kd, f'rhs {tuple(rhs.shape)} vs lhs {tuple(lhs.shape)} '
        f'(transpose_rhs={transpose_rhs})')
    if m == 0 or n == 0 or kd == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=lhs.device)
    p = _build.ptr
    kmaj = _tc_layout(lhs, rhs, transpose_rhs, out_dtype)
    if kmaj is None:
        out = torch.zeros((m, n), dtype=out_dtype, device=lhs.device)
        err = _build.lib().spt_gmm(
            code, int(out_dtype == torch.float32 and lhs.dtype != out_dtype),
            p(lhs), p(rhs), p(group_sizes), p(out), m, kd, n, n_groups, s0,
            sk, sn, _build.stream())
    else:
        # every row is written: rows past the groups are zeroed in-kernel
        out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
        err = _build.lib().spt_gmm_tc(
            gmm_tile(kd, n), int(kmaj), p(lhs), p(rhs), p(group_sizes),
            p(out), m, kd, n, n_groups, s0, sk, sn, _build.stream())
    _build.check(err, 'gmm')
    gmm.launches += 1
    return out


gmm.launches = 0


def tgmm(lhs: torch.Tensor, rhs: torch.Tensor,
         group_sizes: torch.Tensor) -> torch.Tensor:
    """lhs [m, k], rhs [m, n] (one dtype, f32 or bf16, contiguous),
    group_sizes [G] int32 -> [G, k, n] f32: per group lhs^T rhs over its
    rows."""
    if not _build.on_cuda(lhs, rhs, group_sizes):
        return tgmm_ref(lhs, rhs, group_sizes)
    req = _build.require
    code = _build.dtype_code(lhs)
    req(lhs.dim() == 2 and rhs.dim() == 2 and lhs.shape[0] == rhs.shape[0]
        and rhs.dtype == lhs.dtype,
        f'lhs [m, k] and rhs [m, n] of one dtype, got {tuple(lhs.shape)} '
        f'{lhs.dtype} and {tuple(rhs.shape)} {rhs.dtype}')
    req(lhs.is_contiguous() and rhs.is_contiguous(),
        'inputs must be contiguous')
    n_groups = group_sizes.shape[0]
    _check_sizes(group_sizes, n_groups)
    m, kd = lhs.shape
    n = rhs.shape[1]
    out = torch.empty((n_groups, kd, n), dtype=torch.float32,
                      device=lhs.device)
    if out.numel() == 0:
        return out
    p = _build.ptr
    if tgmm_takes_tc(lhs, rhs):
        n_sm = torch.cuda.get_device_properties(
            lhs.device).multi_processor_count
        tile, rows, _, ws_tiles = tgmm_plan(m, kd, n, n_groups, n_sm)
        ws = torch.empty((ws_tiles, kd, n), dtype=torch.float32,
                         device=lhs.device)
        err = _build.lib().spt_tgmm_tc(
            tile, p(lhs), p(rhs), p(group_sizes), p(out), p(ws), m, kd, n,
            n_groups, rows, _build.stream())
    else:
        err = _build.lib().spt_tgmm(code, p(lhs), p(rhs), p(group_sizes),
                                    p(out), m, kd, n, n_groups,
                                    _build.stream())
    _build.check(err, 'tgmm')
    tgmm.launches += 1
    return out


tgmm.launches = 0


class GroupedMatmul(torch.autograd.Function):
    """gmm with megablox's VJP (ops.py _gmm_bwd). The cotangent is taken in
    rhs's dtype (the routed FFN asks for outputs in that dtype, so nothing
    rounds)."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, transpose_rhs, out_dtype):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.transpose_rhs = transpose_rhs
        return gmm(lhs, rhs, group_sizes, transpose_rhs=transpose_rhs,
                   out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        t = ctx.transpose_rhs
        grad = grad.to(rhs.dtype).contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm(grad, rhs, group_sizes, transpose_rhs=not t,
                       out_dtype=lhs.dtype)
        if ctx.needs_input_grad[1]:
            # [G, n, k] for a transposed rhs: tgmm of the swapped operands
            drhs = (tgmm(grad, lhs, group_sizes) if t
                    else tgmm(lhs, grad, group_sizes)).to(rhs.dtype)
        return dlhs, drhs, None, None, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor, *, transpose_rhs: bool = False,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Differentiable gmm (lhs and rhs; group_sizes is an index)."""
    return GroupedMatmul.apply(lhs.contiguous(), rhs, group_sizes,
                               transpose_rhs, out_dtype or lhs.dtype)
