"""Fused skinny-m decode FFN tail (port of ffn_tail in
spt_proto_tpu/ops/pallas/ffn_tail.py):

    out = res + relu(x @ w1 + b1) @ w2 + b2           (OPT)

`ffn_tail` launches csrc/ffn_tail.cu for CUDA tensors and runs the plain
twin `ffn_tail_ref` for CPU tensors. Numerics are the TPU kernel's, not the
unfused path's: the products run in f32, the fc1 hidden value stays f32
into the fc2 product, the sum starts from res + b2, and the result is cast
to x's dtype once at the end. The gated (SwiGLU) and int8 forms come with
the LLaMA and int8-weight slices.
"""
from __future__ import annotations

import torch

from spt_proto_tpu_torch import _build

MAX_ROWS = 256           # the skinny decode regime the TPU kernel serves


def ffn_tail_ref(x, res, w1, b1, w2, b2):
    """Plain twin (f32 math like the kernel)."""
    h = torch.relu(x.float() @ w1.float() + b1.float())
    y = h @ w2.float() + b2.float()
    return (res.float() + y).to(x.dtype)


def _slice_width(f: int) -> int:
    """d_ff columns per CTA: 64 when that still gives >= 128 CTAs (about
    one per SM), else 32 (more CTAs in flight for a narrow d_ff)."""
    return 64 if f % 64 == 0 and f // 64 >= 128 else 32


def ffn_tail(x, res, w1, b1, w2, b2):
    """res + relu(x @ w1 + b1) @ w2 + b2 in one fused pass over the weights.

    x/res [m, D] (m <= 256), w1 [D, F], b1 [F], w2 [F, D], b2 [D], all in
    one dtype (bf16 or f32). Returns [m, D] in x's dtype."""
    if not _build.on_cuda(x, res, w1, b1, w2, b2):
        return ffn_tail_ref(x, res, w1, b1, w2, b2)
    m, d = x.shape
    f = w1.shape[1]
    req = _build.require
    code = _build.dtype_code(x)
    req(all(a.dtype == x.dtype for a in (res, w1, b1, w2, b2)),
        'x, res and the FFN weights share one dtype')
    req(res.shape == (m, d) and w1.shape == (d, f) and b1.shape == (f,)
        and w2.shape == (f, d) and b2.shape == (d,),
        f'ffn_tail shapes: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 '
        f'{tuple(w2.shape)}')
    req(1 <= m <= MAX_ROWS and f % 32 == 0,
        f'm {m} (<= {MAX_ROWS}) / d_ff {f} (a multiple of 32)')
    args = [x, res, w1, b1, w2, b2]
    req(all(a.is_contiguous() for a in args), 'inputs must be contiguous')
    ft = _slice_width(f)
    part = torch.empty((f // ft, m, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    p = _build.ptr
    err = _build.lib().spt_ffn_tail(
        code, *[p(a) for a in args], p(part), p(out), m, d, f, ft,
        _build.stream())
    _build.check(err, 'ffn_tail')
    ffn_tail.launches += 1
    return out


ffn_tail.launches = 0
