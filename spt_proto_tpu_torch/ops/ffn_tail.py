"""Fused skinny-m decode FFN tail (port of ffn_tail in
spt_proto_tpu/ops/pallas/ffn_tail.py):

    out = res + relu(x @ w1 + b1) @ w2 + b2           (OPT)

    out = res + b2 + (relu((x @ W1q) * s1 + b1) @ W2q) * s2   (int8 weights)

`ffn_tail` and `ffn_tail_int8` launch csrc/ffn_tail.cu for CUDA tensors and
run their plain twins for CPU tensors. Numerics are the TPU kernels', not
the unfused path's: the products run in f32 (x is NOT rounded to bf16, as
int8_matmul does), the fc1 hidden value stays f32 into the fc2 product, and
the result is cast to x's dtype once at the end. The fp form starts its sum
from res + b2; the int8 form sums the UNSCALED fc2 products over d_ff and
then takes res + b2 + sum * s2 (s2 factors out of the sum over d_ff). The
gated (SwiGLU) forms come with the LLaMA slice.
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


def int8_tile(d_ff: int) -> int:
    """The TPU kernel's d_ff tile: the largest of 2048 ... 128 dividing the
    TRUE d_ff, 0 when none does (then the engine takes the unfused FFN)."""
    for ft in (2048, 1024, 512, 256, 128):
        if d_ff % ft == 0:
            return ft
    return 0


def ffn_tail_int8_ref(x, res, w1q, b1, w2q, b2):
    """Plain twin: the TPU kernel's tile walk over the true d_ff, an
    unscaled f32 fc2 sum, then res + b2 + sum * s2."""
    m, d = x.shape
    f = w1q['scale'].numel()
    ft = int8_tile(f) or f
    xf = x.float()
    s1 = w1q['scale'].reshape(-1).float()
    acc = torch.zeros((m, d), dtype=torch.float32, device=x.device)
    for f0 in range(0, f, ft):
        h = xf @ w1q['q'][:, f0:f0 + ft].float()
        h = torch.relu(h * s1[f0:f0 + ft] + b1[f0:f0 + ft].float())
        acc += h @ w2q['q'][f0:f0 + ft, :d].float()
    s2 = w2q['scale'].reshape(-1).float()
    return (res.float() + b2.float() + acc * s2).to(x.dtype)


def ffn_tail_int8(x, res, w1q, b1, w2q, b2):
    """res + relu((x @ W1q) * s1 + b1) @ W2q * s2 + b2, streaming the int8
    weights once.

    x/res [m, D] (m <= 256), w1q {'q': [D, F_pad] int8, 'scale': [F]},
    b1 [F], w2q {'q': [F, D_pad] int8, 'scale': [D]}, b2 [D]; x, res, b1
    and b2 share one dtype. Returns [m, D] in x's dtype."""
    q1, s1, q2, s2 = w1q['q'], w1q['scale'], w2q['q'], w2q['scale']
    if not _build.on_cuda(x, res, q1, s1, b1, q2, s2, b2):
        return ffn_tail_int8_ref(x, res, w1q, b1, w2q, b2)
    m, d = x.shape
    f = s1.numel()
    req = _build.require
    code = _build.dtype_code(x)
    req(all(a.dtype == x.dtype for a in (res, b1, b2)),
        'x, res and the biases share one dtype')
    req(q1.dtype == q2.dtype == torch.int8 and s1.dtype == s2.dtype
        == torch.float32, 'int8 weights with f32 scales')
    req(res.shape == (m, d) and q1.shape[0] == d and f <= q1.shape[1]
        and b1.numel() == f and q2.shape[0] == f and s2.numel() == d
        and d <= q2.shape[1] and b2.numel() == d,
        f'ffn_tail_int8 shapes: x {tuple(x.shape)}, w1q {tuple(q1.shape)} / '
        f'[{f}], w2q {tuple(q2.shape)} / [{s2.numel()}]')
    req(1 <= m <= MAX_ROWS and f % 32 == 0,
        f'm {m} (<= {MAX_ROWS}) / d_ff {f} (a multiple of 32)')
    args = [x, res, q1, s1, b1, q2, s2, b2]
    req(all(a.is_contiguous() for a in args), 'inputs must be contiguous')
    ft = _slice_width(f)
    part = torch.empty((f // ft, m, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    p = _build.ptr
    err = _build.lib().spt_ffn_tail_int8(
        code, *[p(a) for a in args], p(part), p(out), m, d, f, q1.shape[1],
        q2.shape[1], ft, _build.stream())
    _build.check(err, 'ffn_tail_int8')
    ffn_tail_int8.launches += 1
    return out


ffn_tail_int8.launches = 0
