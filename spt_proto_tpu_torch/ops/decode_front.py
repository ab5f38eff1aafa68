"""Fused sparse decode FRONT: norm1 + QKV projection (+ RoPE) + PQ encode +
tile selection (+ int8 KV quantization) in one launch per decode layer (port
of spt_proto_tpu/ops/pallas/decode_front.py).

`decode_front` launches the CUDA kernels of csrc/decode_front.cu for CUDA
tensors and runs the plain twin `decode_front_ref` for CPU tensors;
`front_plan` is the rule that picks the kernels (bf16: the norm, one
tensor-core weight stream over q | k | v for all slots, and the per-head
tail; f32 and shapes off that rule: the fused kernel, one CTA per (kv
head, slot)). The
engine calls it for sparse decode over an int8 KV cache (quantized=True)
and over a bf16/f32 one (quantized=False). Architectures: OPT (LayerNorm,
biases) and LLaMA (RMSNorm, no biases, RoPE from per-slot cos / sin
tables). Weight forms, as the JAX kernel takes them:
- 'stack': the fp QKV [3, D, O] (MHA; O = D, or a rank's H*dh / model
  under a mesh);
- 'packed_int8': {'q': [D, 3O_pad] int8, 'scale': [3O] f32}, columns
  [q|k|v] (MHA, int8 weight-only serving);
- 'triple': (wq [D, H*dh], wk [D, KV*dh], wv [D, KV*dh]) in the serving
  dtype (GQA);
- 'triple_int8': three {'q', 'scale'} dicts, each part N-padded to 256 on
  its own (GQA, int8 weights).

Numerics follow the JAX kernel op for op in the serving dtype: f32 norm
statistics with dtype affine, f32-accumulated dot rounded to the dtype
before the dtype bias add (in the int8 forms the dot is int8_matmul's: hn
rounded to bf16, f32 partials per K block of 256 -- 128 when D is not a
multiple of 256 -- added in ascending order, then the per-column scale),
RoPE as the plain rotate-half in f32 on the dtype-rounded projections
(the JAX kernel's +-1 rotation matmul is exact, so the two agree), per-token
int8 quantization of k (after RoPE) and v (max-abs / 127, round half to
even), l2 PQ encode through the block-diagonal codebook with lowest-index
ties, and tile selection in lax.top_k order (highest group-pooled mean match
over FULL tiles first, lowest index on ties) with the current tile appended
last. Group member g of kv head j is query head j*G + g.
"""
from __future__ import annotations

import functools

import torch

from spt_proto_tpu_torch import _build
from spt_proto_tpu_torch.layers.common import rotate_half
from spt_proto_tpu_torch.ops import weight_stream as ws
from spt_proto_tpu_torch.ops.int8_matmul import int8_dot

NEG = -1e30
STREAM_SLICE_MIN = 128   # K rows a slice of the projection stream, at least


def build_pq_bd(codebook: torch.Tensor):
    """codebook [n_sub, n_code, d_code] -> (bd [n_sub*d_code,
    n_sub*n_code] block-diagonal f32, cb_norm [1, n_sub*n_code] f32)."""
    n_sub, n_code, d_code = codebook.shape
    cb = codebook.float()
    eye = torch.eye(n_sub, dtype=torch.float32, device=cb.device)
    # bd[s*d_code + d, s2*n_code + c] = cb[s, c, d] iff s == s2
    bd = torch.einsum('scd,st->sdtc', cb, eye).reshape(
        n_sub * d_code, n_sub * n_code)
    cb_norm = (cb * cb).sum(-1).reshape(1, n_sub * n_code)
    return bd, cb_norm


def weight_form(wqkv) -> str:
    """'stack', 'packed_int8', 'triple' or 'triple_int8' (module doc)."""
    if isinstance(wqkv, torch.Tensor):
        return 'stack'
    if isinstance(wqkv, dict):
        return 'packed_int8'
    return 'triple_int8' if isinstance(wqkv[0], dict) else 'triple'


def _part_widths(wqkv, d: int):
    """Output widths of q, k, v (true widths for the int8 forms). The stack
    and packed forms have three equal parts: D wide for the whole model, a
    rank's heads under a mesh (parallel/infer_sharding.py)."""
    form = weight_form(wqkv)
    if form == 'stack':
        return [wqkv.shape[2]] * 3
    if form == 'packed_int8':
        return [wqkv['scale'].numel() // 3] * 3
    if form == 'triple':
        return [w.shape[1] for w in wqkv]
    return [w['scale'].numel() for w in wqkv]


def _front_block_k(d: int) -> int:
    """K block of the int8 projection (decode_front.py:205)."""
    return 256 if d % 256 == 0 else 128


def _parts(wqkv, d: int):
    """Per part (q, k, v): (weight tensor, first column, row stride, scale
    tensor or None, first scale column), as the kernels address them."""
    form = weight_form(wqkv)
    o = _part_widths(wqkv, d)[0]
    if form == 'stack':
        return [(wqkv, i * d * o, o, None, 0) for i in range(3)]
    if form == 'packed_int8':
        w8, wsc = wqkv['q'], wqkv['scale']
        return [(w8, i * o, w8.shape[1], wsc, i * o) for i in range(3)]
    if form == 'triple':
        return [(w, 0, w.shape[1], None, 0) for w in wqkv]
    return [(w['q'], 0, w['q'].shape[1], w['scale'], 0) for w in wqkv]


def call_plan(x, norm_scale, norm_bias, wqkv, bd, cb_norm, c_cache, cos,
              sin, n_sub: int, parts=None) -> dict:
    """front_plan for one call's tensors: its widths, the parts' row
    strides and whether the operands the kernels copy 16 bytes at a time
    (x, the norm, every part's rows, the codebook, the code cache, the
    RoPE rows) are 16-byte aligned. `parts`: _parts(wqkv, D) when the
    caller has them."""
    d = x.shape[1]
    parts = parts or _parts(wqkv, d)
    aligned = all(a.data_ptr() % 16 == 0 for a in [
        x, norm_scale, bd, cb_norm, c_cache] + [
        a for a in (norm_bias, cos, sin) if a is not None]) \
        and all(_offset(w, o) % 16 == 0 for w, o, _, _, _ in parts) \
        and (bd.shape[1] // n_sub) % 4 == 0
    form = weight_form(wqkv)
    return front_plan(x.shape[0], d, _part_widths(wqkv, d), x.dtype,
                      form in ('packed_int8', 'triple_int8'),
                      [ld for _, _, ld, _, _ in parts], aligned)


def front_plan(b: int, d: int, widths, dtype: torch.dtype, int8w: bool,
               lds=(), aligned: bool = True) -> dict:
    """The kernels a decode_front call runs on the card. bf16 takes route
    'stream' when a column tile of 16 cw columns divides every part's
    width (`widths`: q, k, v; a tile never straddles two parts) and its
    warps hold all b rows, D is a multiple of 8, every row stride (`lds`)
    starts its rows on 16 bytes, and the operands are 16-byte aligned
    with a multiple of 4 codewords a subspace (`aligned`, call_plan):
    decode_front_norm_kernel, decode_front_stream_kernel with `cw`, `ng`
    row groups a warp and a ring of `stages` over `tiles` column tiles and
    D in `slices` ordered slices of `kslice` rows (whole K blocks of the
    int8 forms), then decode_front_tail_kernel. f32 and the shapes off
    that rule take route 'fused' (decode_front_kernel). The plan is kept
    per argument set: the engine asks for the same one every layer. The
    caller reads the returned dict and does not change it."""
    return _front_plan(b, d, tuple(widths), dtype, int8w, tuple(lds),
                       aligned)


@functools.lru_cache(maxsize=256)
def _front_plan(b, d, widths, dtype, int8w, lds, aligned) -> dict:
    fused = dict(route='fused')
    per_copy = 16 if int8w else 8          # weight elements a 16-byte copy
    if (dtype != torch.bfloat16 or not aligned or d % 8
            or any(ld % per_copy for ld in lds)):
        return fused
    tile = next(((cw, ng) for cw in ws.CWS
                 if all(n % (16 * cw) == 0 for n in widths)
                 and (ng := ws.row_groups(b, cw)) is not None), None)
    if tile is None:
        return fused
    cw, ng = tile
    item = 1 if int8w else 2
    ring = ws.ring(item, 1, 1, cw, b, ng)
    if ring is None:
        return fused
    stages, ng = ring
    smem = stages * ws.stage_bytes(item, 1, 1, cw, b)
    tiles = sum(n // (16 * cw) for n in widths)
    kslice = ws.k_slice(d, tiles, STREAM_SLICE_MIN, ws.wave(smem))
    if int8w:
        bk = _front_block_k(d)
        kslice = -(-kslice // bk) * bk
    return dict(route='stream', cw=cw, ng=ng, stages=stages, tiles=tiles,
                kslice=kslice, slices=-(-d // kslice))


def _project(hn, wqkv, bqkv, dtype):
    """q, k, v [B, part width] in the serving dtype from the normed row hn;
    bqkv None (no biases) or [3, >= part width]."""
    form = weight_form(wqkv)
    d = hn.shape[1]
    widths = _part_widths(wqkv, d)
    if form == 'stack':
        ys = [(hn.float() @ wqkv[t].float()).to(dtype) for t in range(3)]
    elif form == 'triple':
        ys = [(hn.float() @ w.float()).to(dtype) for w in wqkv]
    elif form == 'packed_int8':
        o = widths[0]
        acc = int8_dot(hn, wqkv['q'][:, :3 * o], _front_block_k(d))
        y = (acc * wqkv['scale'].reshape(1, -1).float()).to(dtype)
        ys = [y[:, t * o:(t + 1) * o] for t in range(3)]
    else:
        ys = [(int8_dot(hn, w['q'][:, :n], _front_block_k(d))
               * w['scale'].reshape(1, -1).float()).to(dtype)
              for w, n in zip(wqkv, widths)]
    if bqkv is not None:
        ys = [y + bqkv[t, :n].to(dtype) for t, (y, n) in
              enumerate(zip(ys, widths))]
    return ys


def decode_front_ref(x, norm_scale, norm_bias, wqkv, bqkv, bd, cb_norm,
                     c_cache, pos, base, cos=None, sin=None, *, nt: int,
                     nsel: int, n_sub: int, ps: int = 128, eps: float = 1e-5,
                     arch: str = 'opt', quantized: bool = False):
    """Plain twin of the decode-front kernel (same contract as
    decode_front)."""
    base = int(base)
    dtype = x.dtype
    b, d = x.shape
    _, kv, _, width, _ = c_cache.shape
    dh = bd.shape[0]
    n_code = bd.shape[1] // n_sub

    xf = x.float()
    if arch == 'llama':
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        hn = norm_scale.to(dtype) * y.to(dtype)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        hn = y.to(dtype) * norm_scale.to(dtype) + norm_bias.to(dtype)

    q, k, v = _project(hn, wqkv, bqkv, dtype)
    heads = q.shape[1] // dh
    g = heads // kv
    if arch == 'llama':
        def rope(z):                     # [B, n*dh], cos/sin [B, dh] f32
            zf = z.float().reshape(b, -1, dh)
            out = cos.float()[:, None] * zf + sin.float()[:, None] \
                * rotate_half(zf)
            return out.to(dtype).reshape(b, -1)
        q, k = rope(q), rope(k)
    res = [q, k, v]

    def encode(z):                                   # [B, n*dh] -> [B, n, ns]
        zh = z.float().reshape(b, -1, dh)
        score = cb_norm.float() - 2.0 * torch.einsum('bhd,dc->bhc', zh,
                                                     bd.float())
        return torch.argmin(score.reshape(b, -1, n_sub, n_code), -1).to(
            torch.int32)

    qc, kc = encode(q), encode(k)
    c_new = torch.full((b, kv, width), -2, dtype=torch.int32, device=x.device)
    c_new[..., :n_sub] = kc

    # group-pooled match: every member's codes against the kv head's slab
    slab = c_cache[:, :, base:base + nt, :n_sub]     # [B, KV, nt, ns, T]
    qg = qc.reshape(b, kv, g, n_sub)
    cnt = (slab[:, :, None] == qg[:, :, :, None, :, None]).sum(dim=(2, 4, 5))
    tsc = cnt.float() * (1.0 / (ps * g))
    cur = (pos // ps).to(torch.int64)                # [B]
    tile_i = torch.arange(nt, device=x.device)
    tsc = torch.where(tile_i[None, None, :] < cur[:, None, None], tsc, NEG)
    tables = torch.empty((b, kv, nsel), dtype=torch.int32, device=x.device)
    for c in range(nsel - 1):
        val, idx = tsc.max(-1)               # first maximum: lowest index
        tables[..., c] = torch.where(val > NEG / 2, idx + base, -1)
        tsc = tsc.scatter(-1, idx[..., None], NEG)
    tables[..., nsel - 1] = (cur + base)[:, None]
    res += [c_new, tables]

    if quantized:
        q8s = []
        for src in (k, v):
            xh = src.float().reshape(b, kv, dh)
            s = xh.abs().amax(-1).clamp(min=1e-8) / 127.0
            q8 = torch.round(xh / s[..., None]).clamp(-127, 127)
            q8s.append((q8.to(torch.int8).reshape(b, kv * dh), s))
        (k8, ks), (v8, vs) = q8s
        res += [k8, v8, ks, vs]
    return tuple(res)


def _offset(t: torch.Tensor, elems: int) -> int:
    """Address of t's element `elems` (flat) as a C pointer."""
    return t.data_ptr() + elems * t.element_size()


def decode_front(x, norm_scale, norm_bias, wqkv, bqkv, bd, cb_norm,
                 c_cache, pos, base, cos=None, sin=None, *, nt: int,
                 nsel: int, n_sub: int, ps: int = 128, eps: float = 1e-5,
                 arch: str = 'opt', quantized: bool = False):
    """One launch for the decode step's pre-attention half.

    x [B, D] -> (q [B, H*dh], k [B, KV*dh], v [B, KV*dh],
                 c_new [B, KV, w] int32,
                 tables [B, KV, nsel] PHYSICAL tile ids
                 [, k8 [B, KV*dh] int8, v8, ks [B, KV] f32, vs]).

    wqkv in one of the four forms of the module doc; bqkv [3, D] (stack /
    packed) or [3, max part width] (a biased triple, parts zero-padded) in
    the serving dtype, or None; norm_bias None for LLaMA; bd / cb_norm from
    build_pq_bd (the kernels read only bd's diagonal blocks); c_cache [B,
    KV, L*NT, w, T] int32 (pad columns -2); pos [B] int32; base =
    layer_index * nt (int); cos / sin [B, d_head] f32 RoPE tables at each
    slot's position (LLaMA only, layers.common.rope_cos_sin).
    """
    form = weight_form(wqkv)
    int8w = form in ('packed_int8', 'triple_int8')
    if form == 'stack':
        w_ts = [wqkv]
    elif form == 'packed_int8':
        w_ts = [wqkv['q'], wqkv['scale']]
    elif form == 'triple':
        w_ts = list(wqkv)
    else:
        w_ts = [a for w in wqkv for a in (w['q'], w['scale'])]
    llama = arch == 'llama'
    extra = [a for a in (norm_bias, bqkv, cos, sin) if a is not None]
    if not _build.on_cuda(x, norm_scale, *w_ts, *extra, bd, cb_norm,
                          c_cache, pos):
        return decode_front_ref(
            x, norm_scale, norm_bias, wqkv, bqkv, bd, cb_norm, c_cache, pos,
            base, cos, sin, nt=nt, nsel=nsel, n_sub=n_sub, ps=ps, eps=eps,
            arch=arch, quantized=quantized)
    base = int(base)
    b, d = x.shape
    _, kv, n_all, width, t = c_cache.shape
    dh = bd.shape[0]
    widths = _part_widths(wqkv, d)
    heads = widths[0] // dh
    g = heads // kv
    req = _build.require
    code = _build.dtype_code(x)
    req(arch in ('opt', 'llama'), f'arch {arch!r}')
    req(widths == [heads * dh, kv * dh, kv * dh] and heads % kv == 0,
        f'q/k/v widths {widths} vs d_head {dh}, {kv} kv heads')
    req(form not in ('stack', 'packed_int8') or heads == kv,
        'the stack and packed forms are MHA')
    req(all(a.dtype == x.dtype for a in [norm_scale] + [
        a for a in (norm_bias, bqkv) if a is not None]),
        'x, norm and QKV bias must share the serving dtype')
    req(llama == (norm_bias is None) and (not llama or bqkv is None),
        'OPT takes a norm bias, LLaMA takes no biases')
    req(llama == (cos is not None and sin is not None),
        'cos / sin [B, d_head] come with (and only with) LLaMA')
    if llama:
        req(cos.dtype == sin.dtype == torch.float32
            and cos.shape == sin.shape == (b, dh) and dh % 2 == 0,
            f'cos / sin [{b}, {dh}] f32')
    if bqkv is not None:
        req(bqkv.dim() == 2 and bqkv.shape[0] == 3
            and bqkv.shape[1] >= max(widths), f'bqkv {tuple(bqkv.shape)}')
    ldb = 0 if bqkv is None else bqkv.shape[1]
    o = widths[0]
    if form == 'stack':
        req(wqkv.dtype == x.dtype and wqkv.dim() == 3
            and wqkv.shape[:2] == (3, d),
            f'wqkv {tuple(wqkv.shape)} {wqkv.dtype} != [3, {d}, O] '
            f'{x.dtype}')
    elif form == 'packed_int8':
        w8, wsc = wqkv['q'], wqkv['scale']
        req(w8.dtype == torch.int8 and w8.dim() == 2 and w8.shape[0] == d
            and w8.shape[1] >= 3 * o and wsc.dtype == torch.float32
            and wsc.numel() == 3 * o,
            f'packed int8 QKV {tuple(w8.shape)} {w8.dtype} / scale '
            f'[{wsc.numel()}] at D={d}')
    elif form == 'triple':
        req(all(w.dtype == x.dtype and w.dim() == 2 and w.shape[0] == d
                for w in wqkv), f'triple weights [D, n] in {x.dtype}')
    else:
        req(all(w['q'].dtype == torch.int8 and w['q'].dim() == 2
                and w['q'].shape[0] == d and w['q'].shape[1] >= n
                and w['scale'].dtype == torch.float32
                for w, n in zip(wqkv, widths)),
            'triple_int8 parts {q: [D, n_pad] int8, scale: [n] f32}')
    req(not int8w or d % 128 == 0, f'int8 forms need D={d} a multiple of 128')
    req(norm_scale.numel() == d
        and (norm_bias is None or norm_bias.numel() == d), 'norm width')
    req(256 % dh == 0, f'd_head {dh} must divide 256')
    req(bd.dtype == torch.float32 and cb_norm.dtype == torch.float32,
        'bd / cb_norm are f32')
    req(bd.shape[1] % n_sub == 0 and dh % n_sub == 0
        and cb_norm.numel() == bd.shape[1], 'bd / cb_norm shapes')
    req(c_cache.dtype == torch.int32 and t == ps and width >= n_sub,
        'c_cache [B, KV, L*NT, w>=n_sub, ps] int32')
    req(c_cache.shape[0] == b and 0 <= base and base + nt <= n_all
        and 1 <= nsel <= nt, 'tile geometry')
    req(pos.dtype == torch.int32 and pos.shape == (b,), 'pos [B] int32')
    tensors = [x, norm_scale, bd, cb_norm, c_cache, pos] + w_ts + extra
    req(all(a.is_contiguous() for a in tensors), 'inputs must be contiguous')

    parts = _parts(wqkv, d)
    plan = call_plan(x, norm_scale, norm_bias, wqkv, bd, cb_norm, c_cache,
                     cos, sin, n_sub, parts)
    dev = x.device
    q = torch.empty((b, heads * dh), dtype=x.dtype, device=dev)
    k, v = (torch.empty((b, kv * dh), dtype=x.dtype, device=dev)
            for _ in range(2))
    c_new = torch.empty((b, kv, width), dtype=torch.int32, device=dev)
    tables = torch.empty((b, kv, nsel), dtype=torch.int32, device=dev)
    k8 = v8 = ks = vs = None
    if quantized:
        k8, v8 = (torch.empty((b, kv * dh), dtype=torch.int8, device=dev)
                  for _ in range(2))
        ks, vs = (torch.empty((b, kv), dtype=torch.float32, device=dev)
                  for _ in range(2))
    p = _build.ptr
    w_ptrs = [_offset(w, o) for w, o, _, _, _ in parts]
    lds = [ld for _, _, ld, _, _ in parts]
    s_ptrs = [None if s is None else _offset(s, o) for _, _, _, s, o in parts]
    b_ptrs = [None if bqkv is None else _offset(bqkv, i * ldb)
              for i in range(3)]
    hn = part = None
    route = [0] * 5
    if plan['route'] == 'stream':
        hn = torch.empty((b, d), dtype=torch.bfloat16, device=dev)
        part = torch.empty((plan['slices'], b, sum(widths)),
                           dtype=torch.float32, device=dev)
        route = [1] + [plan[n] for n in ('cw', 'ng', 'stages', 'kslice')]
    err = _build.lib().spt_decode_front(
        code, int(int8w), p(x), p(norm_scale), p(norm_bias), *w_ptrs, *lds,
        *s_ptrs, *b_ptrs, p(bd), p(cb_norm), p(cos), p(sin), p(c_cache),
        p(pos), base, p(q), p(k), p(v), p(c_new), p(tables), p(k8), p(v8),
        p(ks), p(vs), b, d, heads, kv, dh, n_sub, bd.shape[1] // n_sub,
        width, n_all, nt, nsel, ps, _front_block_k(d) if int8w else 0,
        1.0 / (ps * g), eps, int(llama), int(quantized), *route, p(hn),
        p(part), _build.stream())
    _build.check(err, 'decode_front')
    decode_front.launches += 1
    res = (q, k, v, c_new, tables)
    return res + (k8, v8, ks, vs) if quantized else res


decode_front.launches = 0
