"""int8 weight-only matmul with the dequantization fused in (port of
int8_matmul in spt_proto_tpu/ops/pallas/int8_matmul.py):

    y = x @ (q * scale)      q [K, N_pad] int8, scale [N] f32 per column

`int8_matmul` launches csrc/int8_matmul.cu for CUDA tensors and runs the
plain twin `int8_matmul_ref` for CPU tensors. Both follow the TPU KERNEL,
not the JAX package's `int8_matmul_ref` oracle, which differs from it in
two ways: x is rounded to bf16 (also when the serving dtype is f32), and
the f32 products are summed in `block_k`-row chunks whose partial sums are
added in ascending order. Because the scale is per output column it
commutes with the K sum and is applied once: (acc * scale) cast to x's
dtype. Columns past the scale's width (q's N padding) come out 0.
"""
from __future__ import annotations

import torch

from spt_proto_tpu_torch import _build

SKINNY_M = 64       # below this many rows the kernel streams the weight


def int8_block_k(m: int, k: int) -> int:
    """The TPU kernel's K chunk: 256 for skinny m when K allows, else 128
    (int8_matmul.py:70-75)."""
    return 256 if m < SKINNY_M and k % 256 == 0 else 128


def int8_dot(x: torch.Tensor, q: torch.Tensor, bk: int) -> torch.Tensor:
    """The TPU kernels' unscaled int8 product: x [m, K] rounded to bf16 @
    q [K, N] int8, f32 partials per bk-row chunk added in ascending order
    -> [m, N] f32. Shared by the int8 matmul, lm_head and decode-front
    twins."""
    xb = x.to(torch.bfloat16).float()
    qf = q.float()
    acc = torch.zeros((x.shape[0], q.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, x.shape[1], bk):
        acc += xb[:, k0:k0 + bk] @ qf[k0:k0 + bk]
    return acc


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain twin: x [..., K] -> [..., N_pad] in x's dtype."""
    lead, k = x.shape[:-1], x.shape[-1]
    n_pad = q.shape[-1]
    xf = x.reshape(-1, k)
    acc = int8_dot(xf, q, int8_block_k(xf.shape[0], k))
    s = scale.reshape(-1).float()
    s = torch.nn.functional.pad(s, (0, n_pad - s.numel()))
    return (acc * s).to(x.dtype).reshape(*lead, n_pad)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] (f32 or bf16, contiguous) @ dequant(q [K, N_pad] int8,
    scale [N] or [1, N] f32) -> [..., N_pad] in x's dtype; the caller
    slices to the true width N."""
    if not _build.on_cuda(x, q, scale):
        return int8_matmul_ref(x, q, scale)
    lead, k = x.shape[:-1], x.shape[-1]
    n_pad = q.shape[-1]
    n = scale.numel()
    req = _build.require
    code = _build.dtype_code(x)
    req(q.dtype == torch.int8 and q.dim() == 2 and q.shape[0] == k,
        f'q {tuple(q.shape)} {q.dtype} vs x {tuple(x.shape)}')
    req(scale.dtype == torch.float32 and n <= n_pad and n_pad % 16 == 0,
        f'scale [{n}] f32 and N_pad {n_pad} (a multiple of 16)')
    req(x.is_contiguous() and q.is_contiguous() and scale.is_contiguous(),
        'inputs must be contiguous')
    req(q.data_ptr() % 16 == 0, 'q must be 16-byte aligned (vector loads)')
    m = x.numel() // k
    out = torch.empty((*lead, n_pad), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    p = _build.ptr
    err = _build.lib().spt_int8_matmul(
        code, p(x), p(q), p(scale), p(out), m, k, n, n_pad,
        int8_block_k(m, k), _build.stream())
    _build.check(err, 'int8_matmul')
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
