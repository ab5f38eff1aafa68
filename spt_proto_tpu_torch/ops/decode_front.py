"""Fused sparse decode FRONT: norm1 + QKV projection + int8 KV quantization
+ PQ encode + tile selection in one launch per decode layer (port of
spt_proto_tpu/ops/pallas/decode_front.py).

`decode_front` launches the CUDA kernel csrc/decode_front.cu for CUDA
tensors and runs the plain twin `decode_front_ref` for CPU tensors. This
slice covers the OPT / MHA / stacked-QKV ('stack') weight form in f32 or
bf16; RoPE (LLaMA), GQA and int8 weight forms raise NotImplementedError.

Numerics follow the JAX kernel op for op in the serving dtype: f32 norm
statistics with dtype affine, f32-accumulated dot rounded to the dtype
before the dtype bias add, per-token int8 quantization (max-abs / 127,
round half to even), l2 PQ encode through the block-diagonal codebook with
lowest-index ties, and tile selection in lax.top_k order (highest mean
match over FULL tiles first, lowest index on ties) with the current tile
appended last.
"""
from __future__ import annotations

import torch

from spt_proto_tpu_torch import _build

NEG = -1e30


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


def _check_form(wqkv, arch, cos, sin):
    if arch != 'opt' or cos is not None or sin is not None:
        raise NotImplementedError(
            'decode_front: LLaMA (RMSNorm + RoPE) comes with the LLaMA slice')
    if not isinstance(wqkv, torch.Tensor):
        raise NotImplementedError(
            'decode_front: GQA (q/k/v triple) and int8 weight forms come with '
            'the int8-weight and LLaMA slices; this slice takes the stacked '
            '[3, D, D] form')


def decode_front_ref(x, norm_scale, norm_bias, wqkv, bqkv, bd, cb_norm,
                     c_cache, pos, base, cos=None, sin=None, *, nt: int,
                     nsel: int, n_sub: int, ps: int = 128, eps: float = 1e-5,
                     arch: str = 'opt', quantized: bool = False):
    """Plain twin of the decode-front kernel (same contract as
    decode_front)."""
    _check_form(wqkv, arch, cos, sin)
    base = int(base)
    dtype = x.dtype
    b, d = x.shape
    _, kv, _, width, _ = c_cache.shape
    dh = d // kv
    n_code = bd.shape[1] // n_sub

    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    hn = y.to(dtype) * norm_scale.to(dtype) + norm_bias.to(dtype)

    q, k, v = [(hn.float() @ wqkv[t].float()).to(dtype) + bqkv[t].to(dtype)
               for t in range(3)]
    outs = [q, k, v]

    if quantized:
        for src in (k, v):
            xh = src.float().reshape(b, kv, dh)
            s = xh.abs().amax(-1).clamp(min=1e-8) / 127.0
            q8 = torch.round(xh / s[..., None]).clamp(-127, 127)
            outs.append((q8.to(torch.int8).reshape(b, d), s))

    def encode(z):                                   # [B, H*dh] -> [B, H, ns]
        zh = z.float().reshape(b, -1, dh)
        score = cb_norm.float() - 2.0 * torch.einsum('bhd,dc->bhc', zh,
                                                     bd.float())
        return torch.argmin(score.reshape(b, -1, n_sub, n_code), -1).to(
            torch.int32)

    qc, kc = encode(q), encode(k)
    c_new = torch.full((b, kv, width), -2, dtype=torch.int32, device=x.device)
    c_new[..., :n_sub] = kc

    slab = c_cache[:, :, base:base + nt, :n_sub]     # [B, KV, nt, ns, T]
    cnt = (slab == qc[:, :, None, :, None]).sum(dim=(3, 4))
    tsc = cnt.float() * (1.0 / ps)
    cur = (pos // ps).to(torch.int64)                # [B]
    tile_i = torch.arange(nt, device=x.device)
    tsc = torch.where(tile_i[None, None, :] < cur[:, None, None], tsc, NEG)
    tables = torch.empty((b, kv, nsel), dtype=torch.int32, device=x.device)
    for c in range(nsel - 1):
        val, idx = tsc.max(-1)               # first maximum: lowest index
        tables[..., c] = torch.where(val > NEG / 2, idx + base, -1)
        tsc = tsc.scatter(-1, idx[..., None], NEG)
    tables[..., nsel - 1] = (cur + base)[:, None]

    res = [q, k, v, c_new, tables]
    if quantized:
        (k8, ks), (v8, vs) = outs[3], outs[4]
        res += [k8, v8, ks, vs]
    return tuple(res)


def decode_front(x, norm_scale, norm_bias, wqkv, bqkv, bd, cb_norm,
                 c_cache, pos, base, cos=None, sin=None, *, nt: int,
                 nsel: int, n_sub: int, ps: int = 128, eps: float = 1e-5,
                 arch: str = 'opt', quantized: bool = False):
    """One launch for the decode step's pre-attention half.

    x [B, D] -> (q [B, D], k [B, D], v [B, D], c_new [B, KV, w] int32,
                 tables [B, KV, nsel] PHYSICAL tile ids
                 [, k8 [B, D] int8, v8, ks [B, KV] f32, vs]).

    wqkv [3, D, D] and bqkv [3, D] in the serving dtype; bd / cb_norm from
    build_pq_bd; c_cache [B, KV, L*NT, w, T] int32 (pad columns -2);
    pos [B] int32; base = layer_index * nt (int)."""
    _check_form(wqkv, arch, cos, sin)
    if not _build.on_cuda(x, norm_scale, norm_bias, wqkv, bqkv, bd, cb_norm,
                          c_cache, pos):
        return decode_front_ref(
            x, norm_scale, norm_bias, wqkv, bqkv, bd, cb_norm, c_cache, pos,
            base, nt=nt, nsel=nsel, n_sub=n_sub, ps=ps, eps=eps, arch=arch,
            quantized=quantized)
    base = int(base)
    b, d = x.shape
    _, kv, n_all, width, t = c_cache.shape
    dh = d // kv
    req = _build.require
    req(all(a.dtype == x.dtype for a in (norm_scale, norm_bias, wqkv, bqkv)),
        'x, norm and QKV weights must share the serving dtype')
    code = _build.dtype_code(x)
    req(wqkv.shape == (3, d, d) and bqkv.shape == (3, d),
        f'wqkv {tuple(wqkv.shape)} / bqkv {tuple(bqkv.shape)} != [3, D, D]'
        f' / [3, D] at D={d}')
    req(norm_scale.numel() == d and norm_bias.numel() == d, 'norm width')
    req(kv * dh == d and 256 % dh == 0, f'd_head {dh} must divide 256')
    req(bd.dtype == torch.float32 and cb_norm.dtype == torch.float32,
        'bd / cb_norm are f32')
    req(bd.shape[0] == dh and bd.shape[1] % n_sub == 0
        and cb_norm.numel() == bd.shape[1], 'bd / cb_norm shapes')
    req(c_cache.dtype == torch.int32 and t == ps and width >= n_sub,
        'c_cache [B, KV, L*NT, w>=n_sub, ps] int32')
    req(c_cache.shape[0] == b and 0 <= base and base + nt <= n_all
        and 1 <= nsel <= nt and 2 * n_sub <= 256, 'tile geometry')
    req(pos.dtype == torch.int32 and pos.shape == (b,), 'pos [B] int32')
    args = [x, norm_scale, norm_bias, wqkv, bqkv, bd, cb_norm, c_cache, pos]
    req(all(a.is_contiguous() for a in args), 'inputs must be contiguous')

    dev = x.device
    q, k, v = (torch.empty((b, d), dtype=x.dtype, device=dev)
               for _ in range(3))
    c_new = torch.empty((b, kv, width), dtype=torch.int32, device=dev)
    tables = torch.empty((b, kv, nsel), dtype=torch.int32, device=dev)
    k8 = v8 = ks = vs = None
    if quantized:
        k8, v8 = (torch.empty((b, d), dtype=torch.int8, device=dev)
                  for _ in range(2))
        ks, vs = (torch.empty((b, kv), dtype=torch.float32, device=dev)
                  for _ in range(2))
    p = _build.ptr
    err = _build.lib().spt_decode_front(
        code, *[p(a) for a in args[:7]], p(c_cache), p(pos), base,
        p(q), p(k), p(v), p(c_new), p(tables), p(k8), p(v8), p(ks), p(vs),
        b, d, kv, dh, n_sub, bd.shape[1] // n_sub, width, n_all, nt, nsel,
        ps, 1.0 / ps, eps, int(quantized), _build.stream())
    _build.check(err, 'decode_front')
    decode_front.launches += 1
    res = (q, k, v, c_new, tables)
    return res + (k8, v8, ks, vs) if quantized else res


decode_front.launches = 0
