"""int8-KV tile-table decode attention with in-place append (port of the
int8 half of spt_proto_tpu/ops/pallas/decode_attention.py).

Cache layout (the JAX engine's, so caches compare directly):
  K/V       [B, KV, NT, D, ps] int8, tokens on the minor axis
  codes     [B, KV, NT, w, ps] int32
  scales    [B, NT, KV_pad, ps] f32, one dequant scale per cached token

`decode_attention_rows_q` launches csrc/decode_attention.cu for CUDA tensors
and runs `decode_attention_rows_q_ref` for CPU tensors. The TPU package has
two launch shapes of the same function (decode_attention_rows_q: one
program per slot; decode_attention_rows_q_ms: one program for all slots);
here one kernel serves both, and `decode_attention_rows_q_ms` names the same
wrapper.

The caches are updated IN PLACE: the new token's k8/v8/codes/scales land at
tile `tile_base + pos // ps`, column `pos % ps`, and the same tensors are
returned. This is the port's counterpart of the TPU kernel's
input_output_aliases.
"""
from __future__ import annotations

import torch

from spt_proto_tpu_torch import _build

NEG_INF = -1e30


def _write_token(k_cache, v_cache, c_cache, pos, k_new, v_new, c_new,
                 tile_base, ps):
    b, kv = k_new.shape[:2]
    dev = k_cache.device
    bi = torch.arange(b, device=dev)[:, None]
    hi = torch.arange(kv, device=dev)[None, :]
    wt = (tile_base + pos // ps).long()[:, None]
    wc = (pos % ps).long()[:, None]
    k_cache[bi, hi, wt, :, wc] = k_new.to(k_cache.dtype)
    v_cache[bi, hi, wt, :, wc] = v_new.to(v_cache.dtype)
    c_cache[bi, hi, wt, :, wc] = c_new.to(c_cache.dtype)
    return bi, hi, wt, wc


def _per_head_tables(tables, kv: int) -> None:
    if tables.shape[1] != kv:
        raise NotImplementedError(
            'grouped tables (GQA) come with the LLaMA slice')


def decode_attention_rows_ref(q, k_cache, v_cache, c_cache, tables,
                              n_tiles, pos, k_new, v_new, c_new,
                              tile_base=None, *, ps: int = 128,
                              scale: float = 1.0, clamp: float = 0.0):
    """Plain oracle for the tile-table decode attention (bf16/f32 caches,
    updated in place). tables [B, KV, T], one table per kv head."""
    b, kv, g, d = q.shape
    dev = q.device
    _per_head_tables(tables, kv)
    if tile_base is None:
        tile_base = torch.zeros((b,), dtype=torch.int32, device=dev)
    _write_token(k_cache, v_cache, c_cache, pos, k_new, v_new, c_new,
                 tile_base, ps)
    t_max = tables.shape[2]
    gt = tables.clamp(min=0).long()                            # [B, KV, T]
    idx = gt[..., None, None].expand(-1, -1, -1, d, ps)
    kg = torch.gather(k_cache, 2, idx)
    vg = torch.gather(v_cache, 2, idx)
    s = torch.einsum('bkgd,bktdp->bkgtp', q.float(), kg.float()) * scale
    if clamp > 0.0:
        s = s.clamp(-clamp, clamp)
    t_idx = torch.arange(t_max, device=dev)[None, None, :, None]
    p_idx = torch.arange(ps, device=dev)[None, None, None, :]
    w_tile = (tile_base + pos // ps).long()[:, None, None, None]
    w_col = (pos % ps).long()[:, None, None, None]
    gt4 = gt[..., None]
    n_valid = torch.where(
        (tables < 0)[..., None], 0,
        torch.where(gt4 == w_tile, w_col + 1,
                    torch.where(gt4 < w_tile, ps, 0)))
    ok = (t_idx < n_tiles.long()[:, None, None, None]) & (p_idx < n_valid)
    s = torch.where(ok[:, :, None], s, NEG_INF)
    flat = s.reshape(b, kv, g, -1)
    p = torch.softmax(flat, dim=-1).reshape(s.shape)
    p = torch.where(ok[:, :, None], p, 0.0)
    o = torch.einsum('bkgtp,bktdp->bkgd', p.to(vg.dtype), vg)
    return o.to(q.dtype), k_cache, v_cache, c_cache


def decode_attention_rows_q_ref(q, k_cache, v_cache, c_cache, k_scale,
                                v_scale, tables, n_tiles, pos, k_new,
                                v_new, c_new, kscale_new, vscale_new,
                                tile_base=None, *, ps: int = 128,
                                scale: float = 1.0, clamp: float = 0.0):
    """Plain twin of the int8 decode attention kernel: append in place,
    dequantize the whole cache, and defer to decode_attention_rows_ref."""
    b, kv, g, d = q.shape
    if tile_base is None:
        tile_base = torch.zeros((b,), dtype=torch.int32, device=q.device)
    bi, hi, wt, wc = _write_token(k_cache, v_cache, c_cache, pos, k_new,
                                  v_new, c_new, tile_base, ps)
    k_scale[bi, wt, hi, wc] = kscale_new.to(k_scale.dtype)
    v_scale[bi, wt, hi, wc] = vscale_new.to(v_scale.dtype)

    def sc_t(s_):                                   # -> [B, KV, NT, 1, ps]
        return s_.transpose(1, 2)[:, :kv, :, None, :]
    kf = k_cache.float() * sc_t(k_scale)
    vf = v_cache.float() * sc_t(v_scale)
    o, _, _, _ = decode_attention_rows_ref(
        q, kf, vf, c_cache, tables, n_tiles, pos,
        k_new.float() * kscale_new[..., None],
        v_new.float() * vscale_new[..., None],
        c_new, tile_base, ps=ps, scale=scale, clamp=clamp)
    return o.to(q.dtype), k_cache, v_cache, c_cache, k_scale, v_scale


def decode_attention_rows_q(q, k_cache, v_cache, c_cache, k_scale, v_scale,
                            tables, n_tiles, pos, k_new, v_new, c_new,
                            kscale_new, vscale_new, tile_base=None, *,
                            ps: int = 128, scale: float = 1.0,
                            clamp: float = 0.0):
    """int8 tile-major decode attention + in-place append.

    q [B, KV, G, D]; caches as in the module docstring; tables
    [B, KV, T] PHYSICAL tile ids, -1 = unused; n_tiles [B]
    (table entries at or past n_tiles are empty); pos [B]; k_new/v_new
    [B, KV, D] int8 with kscale_new/vscale_new [B, KV] f32; c_new [B, KV, w];
    tile_base [B]. Returns (o [B, KV, G, D], k, v, codes, k_scale, v_scale),
    the caches being the (updated) inputs. The TPU signature's nt_layer
    (a per-layer staging bound) and tps (dense-decode supertiles) have no
    counterpart here."""
    if not _build.on_cuda(q, k_cache, v_cache, c_cache, k_scale, v_scale,
                          tables, n_tiles, pos, k_new, v_new, c_new,
                          kscale_new, vscale_new):
        return decode_attention_rows_q_ref(
            q, k_cache, v_cache, c_cache, k_scale, v_scale, tables, n_tiles,
            pos, k_new, v_new, c_new, kscale_new, vscale_new, tile_base,
            ps=ps, scale=scale, clamp=clamp)
    b, kv, g, d = q.shape
    n_all = k_cache.shape[2]
    width = c_cache.shape[3]
    kv_pad = k_scale.shape[2]
    _per_head_tables(tables, kv)
    if tile_base is None:
        tile_base = torch.zeros((b,), dtype=torch.int32, device=q.device)
    t_max = tables.shape[2]
    req = _build.require
    code = _build.dtype_code(q)
    req(k_cache.dtype == v_cache.dtype == torch.int8
        and k_cache.shape == v_cache.shape == (b, kv, n_all, d, ps),
        'k/v caches [B, KV, NT, D, ps] int8')
    req(c_cache.dtype == torch.int32
        and c_cache.shape == (b, kv, n_all, width, ps),
        'code cache [B, KV, NT, w, ps] int32')
    req(k_scale.dtype == v_scale.dtype == torch.float32
        and k_scale.shape == v_scale.shape == (b, n_all, kv_pad, ps)
        and kv_pad >= kv, 'scales [B, NT, KV_pad, ps] f32')
    req(k_new.dtype == v_new.dtype == torch.int8
        and k_new.shape == v_new.shape == (b, kv, d), 'k/v new [B, KV, D]')
    req(c_new.shape == (b, kv, width)
        and kscale_new.shape == vscale_new.shape == (b, kv)
        and kscale_new.dtype == vscale_new.dtype == torch.float32,
        'new codes / scales')
    req(tables.shape == (b, kv, t_max) and n_tiles.shape == pos.shape
        == tile_base.shape == (b,), 'tables / n_tiles / pos / tile_base')
    req(ps % 32 == 0 and ps <= 1024 and (d * ps) % 16 == 0 and g <= 8
        and t_max <= ps, f'ps {ps} / d_head {d} / group {g} / table width '
        f'{t_max} outside the kernel envelope')
    smem = 4 * (2 * g * d + g * t_max * ps + 32) + 8 * t_max + d * ps
    req(smem <= 200 * 1024, f'{smem} B of shared memory: table too wide')
    ints = [tables, n_tiles, pos, c_new, tile_base]
    ints = [a if a.dtype == torch.int32 else a.to(torch.int32) for a in ints]
    tables, n_tiles, pos_i, c_new_i, tile_base = ints
    args = [q, k_cache, v_cache, c_cache, k_scale, v_scale, tables, n_tiles,
            pos_i, k_new, v_new, c_new_i, kscale_new, vscale_new, tile_base]
    req(all(a.is_contiguous() for a in args), 'inputs must be contiguous')
    o = torch.empty_like(q)
    p = _build.ptr
    err = _build.lib().spt_decode_attention_q(
        code, *[p(a) for a in args], p(o), b, kv, g, d, n_all, width, kv_pad,
        t_max, ps, float(scale), float(clamp), _build.stream())
    _build.check(err, 'decode_attention_rows_q')
    decode_attention_rows_q.launches += 1
    return o, k_cache, v_cache, c_cache, k_scale, v_scale


decode_attention_rows_q.launches = 0
decode_attention_rows_q_ms = decode_attention_rows_q
