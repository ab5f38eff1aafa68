"""Fused skinny-m decode FFN tail (port of spt_proto_tpu/ops/pallas/
ffn_tail.py):

    out = res + relu(x @ w1 + b1) @ w2 + b2           (OPT)

    out = res + b2 + (relu((x @ W1q) * s1 + b1) @ W2q) * s2   (int8 weights)

    out = res + (silu(x @ wg) * (x @ ws)) @ wd        (LLaMA, gated)

    out = res + ((silu((x @ Wgq) * sg) * ((x @ Wsq) * ss)) @ Wdq) * sd
                                                      (LLaMA, int8 weights)

`ffn_tail`, `ffn_tail_int8`, `ffn_tail_gated` and `ffn_tail_gated_int8` launch
csrc/ffn_tail.cu for CUDA tensors and run their plain twins for CPU tensors;
`ffn_tail_plan` is the rule that picks the kernels (bf16: the tensor-core
weight streams, h handed from the up to the down product as two bf16 terms hi +
lo; f32 and shapes off that rule: the CUDA-core pair). Numerics are the TPU
kernels', not the unfused path's: the products run in f32 (x is NOT rounded to
bf16, as int8_matmul does), the hidden values stay f32 into the second product,
and the result is cast to x's dtype once at the end. The fp forms start their
sum from res (+ b2); the int8 forms sum the UNSCALED down products over d_ff
and then take res (+ b2) + sum * s2 (s2 factors out of the sum over d_ff). The
gated forms have no biases; their gate and side are scaled per d_ff lane (int8)
before the SiLU and the product.
"""
from __future__ import annotations

import torch

from spt_proto_tpu_torch import _build
from spt_proto_tpu_torch.ops import weight_stream

MAX_ROWS = 256           # the skinny decode regime the TPU kernel serves
SLICE_MIN = 256          # K rows a slice of either product, at least
UP_SPLIT_FILL = 3        # the up product splits K only when its column
                         # tiles fill at most a third of a wave (measured on
                         # the H100: Llama-3-8B's fp gate and side, 112
                         # tiles, ran slower in two slices than in one)
FORMS = {'ffn_tail': 0, 'ffn_tail_int8': 1, 'ffn_tail_gated': 2,
         'ffn_tail_gated_int8': 3}   # spt_ffn_tail_tc's form codes


def ffn_tail_ref(x, res, w1, b1, w2, b2):
    """Plain twin (f32 math like the kernel)."""
    h = torch.relu(x.float() @ w1.float() + b1.float())
    y = h @ w2.float() + b2.float()
    return (res.float() + y).to(x.dtype)


def _slice_width(f: int) -> int:
    """d_ff columns per CTA: 64 when that still gives >= 128 CTAs (about
    one per SM), else 32 (more CTAs in flight for a narrow d_ff)."""
    return 64 if f % 64 == 0 and f // 64 >= 128 else 32


def ffn_tail_plan(m: int, d: int, f: int, dtype: torch.dtype,
                  aligned: bool = True, gated: bool = False,
                  int8: bool = False) -> dict:
    """The kernels an ffn_tail* call runs on the card. bf16 with d and d_ff
    multiples of 8 and 16-byte aligned x and weights (`aligned`) takes route
    'tc': ffn_up_kernel over d_ff and ffn_down_kernel over D, each with a
    plan {cw, ng, stages, kslice, slices}: 16 cw columns a CTA, ng row
    groups a warp, the ring's stages, its K (D, then d_ff) in `slices`
    ordered slices of `kslice` rows (more than one: ffn_act_kernel /
    ffn_reduce_kernel add the partials in slice order).
    f32 and shapes off that rule take route 'cuda_core': ffn_partial_kernel
    with `ft` d_ff columns a CTA, then ffn_reduce_kernel."""
    old = dict(route='cuda_core', ft=_slice_width(f))
    if dtype != torch.bfloat16 or d % 8 or f % 8 or not aligned:
        return old
    item = 1 if int8 else 2
    cw, ng = weight_stream.tile(m)
    plan = dict(route='tc')
    # (name, weights, x operands, K, columns)
    for name, n_w, n_x, k, n in (('up', 2 if gated else 1, 1, d, f),
                                 ('down', 1, 2, f, d)):
        ring = weight_stream.ring(item, n_w, n_x, cw, m, ng)
        if ring is None:
            return old
        smem = ring[0] * weight_stream.stage_bytes(item, n_w, n_x, cw, m)
        tiles = -(-n // (16 * cw))
        slots = weight_stream.wave(smem)
        if name == 'up' and slots // tiles < UP_SPLIT_FILL:
            slots = tiles       # one slice: see UP_SPLIT_FILL
        kslice = weight_stream.k_slice(k, tiles, SLICE_MIN, slots)
        plan[name] = dict(cw=cw, stages=ring[0], ng=ring[1], kslice=kslice,
                          slices=-(-k // kslice))
    return plan


def _launch(name, x, res, w1, s1, b1, w3, s3, w2, s2, b2, f, ld1, ld2,
            weights):
    """One call of an ffn_tail* form on the card: the plan's route, the
    launch, the error check and the count. `weights` are the tensors the
    kernels copy 16 bytes at a time (their alignment decides the route)."""
    m, d = x.shape
    p = _build.ptr
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *weights))
    plan = ffn_tail_plan(m, d, f, x.dtype, aligned, gated='gated' in name,
                         int8=name.endswith('int8'))
    out = torch.empty_like(x)
    if plan['route'] == 'tc':
        up, dn = plan['up'], plan['down']
        hbuf = torch.empty((2, m, f), dtype=torch.bfloat16, device=x.device)
        n_up = up['slices'] * (2 if w3 is not None else 1) * m * f
        n_work = max(n_up if up['slices'] > 1 else 0,
                     dn['slices'] * m * d if dn['slices'] > 1 else 0)
        work = (torch.empty(n_work, dtype=torch.float32, device=x.device)
                if n_work else None)
        err = _build.lib().spt_ffn_tail_tc(
            FORMS[name], *[p(a) for a in (x, res, w1, s1, b1, w3, s3, w2,
                                          s2, b2, hbuf, work, out)],
            m, d, f, ld1, ld2, *(up[k] for k in ('cw', 'ng', 'stages',
                                                 'kslice')),
            *(dn[k] for k in ('cw', 'ng', 'stages', 'kslice')),
            _build.stream())
    else:
        ft = plan['ft']
        part = torch.empty((f // ft, m, d), dtype=torch.float32,
                           device=x.device)
        code = _build.dtype_code(x)
        lib = _build.lib()
        if name == 'ffn_tail':
            err = lib.spt_ffn_tail(code, *[p(a) for a in (
                x, res, w1, b1, w2, b2, part, out)], m, d, f, ft,
                _build.stream())
        elif name == 'ffn_tail_int8':
            err = lib.spt_ffn_tail_int8(code, *[p(a) for a in (
                x, res, w1, s1, b1, w2, s2, b2, part, out)], m, d, f, ld1,
                ld2, ft, _build.stream())
        elif name == 'ffn_tail_gated':
            err = lib.spt_ffn_tail_gated(code, *[p(a) for a in (
                x, res, w1, w3, w2, part, out)], m, d, f, ft,
                _build.stream())
        else:
            err = lib.spt_ffn_tail_gated_int8(code, *[p(a) for a in (
                x, res, w1, s1, w3, s3, w2, s2, part, out)], m, d, f, ld1,
                ld2, ft, _build.stream())
    _build.check(err, name)
    return out


def ffn_tail(x, res, w1, b1, w2, b2):
    """res + relu(x @ w1 + b1) @ w2 + b2 in one fused pass over the weights.

    x/res [m, D] (m <= 256), w1 [D, F], b1 [F], w2 [F, D], b2 [D], all in
    one dtype (bf16 or f32). Returns [m, D] in x's dtype."""
    if not _build.on_cuda(x, res, w1, b1, w2, b2):
        return ffn_tail_ref(x, res, w1, b1, w2, b2)
    m, d = x.shape
    f = w1.shape[1]
    req = _build.require
    _build.dtype_code(x)              # f32 or bf16, else TypeError
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
    out = _launch('ffn_tail', x, res, w1, None, b1, None, None, w2, None,
                  b2, f, f, d, (w1, w2))
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
    _build.dtype_code(x)              # f32 or bf16, else TypeError
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
    out = _launch('ffn_tail_int8', x, res, q1, s1, b1, None, None, q2, s2,
                  b2, f, q1.shape[1], q2.shape[1], (q1, q2))
    ffn_tail_int8.launches += 1
    return out


ffn_tail_int8.launches = 0


def ffn_tail_gated_ref(x, res, wg, ws, wd):
    """Plain twin (f32 math like the kernel)."""
    xf = x.float()
    h = torch.nn.functional.silu(xf @ wg.float()) * (xf @ ws.float())
    return (res.float() + h @ wd.float()).to(x.dtype)


def ffn_tail_gated(x, res, wg, ws, wd):
    """res + (silu(x @ wg) * (x @ ws)) @ wd in one fused pass over the
    weights (SwiGLU, no biases).

    x/res [m, D] (m <= 256), wg/ws [D, F], wd [F, D], all in one dtype (bf16
    or f32). Returns [m, D] in x's dtype."""
    if not _build.on_cuda(x, res, wg, ws, wd):
        return ffn_tail_gated_ref(x, res, wg, ws, wd)
    m, d = x.shape
    f = wg.shape[1]
    req = _build.require
    _build.dtype_code(x)              # f32 or bf16, else TypeError
    req(all(a.dtype == x.dtype for a in (res, wg, ws, wd)),
        'x, res and the FFN weights share one dtype')
    req(res.shape == (m, d) and wg.shape == ws.shape == (d, f)
        and wd.shape == (f, d),
        f'ffn_tail_gated shapes: x {tuple(x.shape)}, wg {tuple(wg.shape)}, '
        f'ws {tuple(ws.shape)}, wd {tuple(wd.shape)}')
    req(1 <= m <= MAX_ROWS and f % 32 == 0,
        f'm {m} (<= {MAX_ROWS}) / d_ff {f} (a multiple of 32)')
    args = [x, res, wg, ws, wd]
    req(all(a.is_contiguous() for a in args), 'inputs must be contiguous')
    out = _launch('ffn_tail_gated', x, res, wg, None, None, ws, None, wd,
                  None, None, f, f, d, (wg, ws, wd))
    ffn_tail_gated.launches += 1
    return out


ffn_tail_gated.launches = 0


def ffn_tail_gated_int8_ref(x, res, wgq, wsq, wdq):
    """Plain twin: the TPU kernel's tile walk over the true d_ff, gate and
    side scaled per lane before the SiLU and the product, an unscaled f32
    down sum, then res + sum * sd."""
    m, d = x.shape
    f = wgq['scale'].numel()
    ft = int8_tile(f) or f
    xf = x.float()
    sg = wgq['scale'].reshape(-1).float()
    ss = wsq['scale'].reshape(-1).float()
    acc = torch.zeros((m, d), dtype=torch.float32, device=x.device)
    for f0 in range(0, f, ft):
        g = (xf @ wgq['q'][:, f0:f0 + ft].float()) * sg[f0:f0 + ft]
        s = (xf @ wsq['q'][:, f0:f0 + ft].float()) * ss[f0:f0 + ft]
        h = torch.nn.functional.silu(g) * s
        acc += h @ wdq['q'][f0:f0 + ft, :d].float()
    sd = wdq['scale'].reshape(-1).float()
    return (res.float() + acc * sd).to(x.dtype)


def ffn_tail_gated_int8(x, res, wgq, wsq, wdq):
    """res + ((silu((x @ Wgq) * sg) * ((x @ Wsq) * ss)) @ Wdq) * sd,
    streaming the int8 weights once.

    x/res [m, D] (m <= 256) in one dtype; wgq/wsq {'q': [D, F_pad] int8,
    'scale': [F]}, wdq {'q': [F, D_pad] int8, 'scale': [D]}. Returns [m, D]
    in x's dtype."""
    qg, sg, qs, ss = wgq['q'], wgq['scale'], wsq['q'], wsq['scale']
    qd, sd = wdq['q'], wdq['scale']
    if not _build.on_cuda(x, res, qg, sg, qs, ss, qd, sd):
        return ffn_tail_gated_int8_ref(x, res, wgq, wsq, wdq)
    m, d = x.shape
    f = sg.numel()
    req = _build.require
    _build.dtype_code(x)              # f32 or bf16, else TypeError
    req(res.dtype == x.dtype, 'x and res share one dtype')
    req(qg.dtype == qs.dtype == qd.dtype == torch.int8
        and sg.dtype == ss.dtype == sd.dtype == torch.float32,
        'int8 weights with f32 scales')
    req(res.shape == (m, d) and qg.shape == qs.shape and qg.shape[0] == d
        and f <= qg.shape[1] and ss.numel() == f and qd.shape[0] == f
        and sd.numel() == d and d <= qd.shape[1],
        f'ffn_tail_gated_int8 shapes: x {tuple(x.shape)}, wgq '
        f'{tuple(qg.shape)} / [{f}], wsq {tuple(qs.shape)}, wdq '
        f'{tuple(qd.shape)} / [{sd.numel()}]')
    req(1 <= m <= MAX_ROWS and f % 32 == 0,
        f'm {m} (<= {MAX_ROWS}) / d_ff {f} (a multiple of 32)')
    args = [x, res, qg, sg, qs, ss, qd, sd]
    req(all(a.is_contiguous() for a in args), 'inputs must be contiguous')
    out = _launch('ffn_tail_gated_int8', x, res, qg, sg, None, qs, ss, qd,
                  sd, None, f, qg.shape[1], qd.shape[1], (qg, qs, qd))
    ffn_tail_gated_int8.launches += 1
    return out


ffn_tail_gated_int8.launches = 0
