"""Tile-table decode attention with in-place append (port of the bf16 and
int8 halves of spt_proto_tpu/ops/pallas/decode_attention.py), and the
speculative block verify over the same tiles (`verify_attention_rows`).

Cache layout (the JAX engine's, so caches compare directly):
  K/V       [B, KV, NT, D, ps] bf16/f32 or int8, tokens on the minor axis
  codes     [B, KV, NT, w, ps] int32
  scales    [B, NT, KV_pad, ps] f32, one dequant scale per cached token
            (int8 caches only)

Tables [B, N_TAB, T] hold PHYSICAL tile ids; N_TAB divides KV and head h
reads row h // (KV / N_TAB) (one row for all heads in dense mode). Entry e
covers the `tps` tiles [tables[e], tables[e] + tps) (dense supertiles); a
-1 entry, or an entry at or past n_tiles, is empty. A tile's tokens count
when the tile lies below the write tile, the write tile's up to the new
token, nothing past it.

`decode_attention_rows` (bf16/f32 caches), `decode_attention_rows_q`
(int8 caches) and `verify_attention_rows` (bf16/f32 caches, K query
columns a slot) launch the three kernels of csrc/decode_attention.cu for
CUDA tensors and run their plain twins for CPU tensors. The TPU package has two
launch shapes of each function (one program per slot, and `_ms`: one
program for all slots); here one kernel serves both, and the `_ms` names
are the same wrappers.

The caches are updated IN PLACE: the new token's k/v/codes (and scales)
land at tile `tile_base + pos // ps`, column `pos % ps`, and the same
tensors are returned. This is the port's counterpart of the TPU kernels'
input_output_aliases.
"""
from __future__ import annotations

import torch

from spt_proto_tpu_torch import _build

NEG_INF = -1e30
SMEM_LIMIT = 200 * 1024        # bytes of shared memory a launch may ask for


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


def decode_attention_rows_ref(q, k_cache, v_cache, c_cache, tables,
                              n_tiles, pos, k_new, v_new, c_new,
                              tile_base=None, *, ps: int = 128, tps: int = 1,
                              scale: float = 1.0, clamp: float = 0.0):
    """Plain oracle for the tile-table decode attention (bf16/f32 caches,
    updated in place); the JAX oracle's numerics: the normalised
    probabilities are rounded to the cache dtype before the PV product."""
    b, kv, g, d = q.shape
    dev = q.device
    if tables.shape[1] != kv:
        tables = tables.repeat_interleave(kv // tables.shape[1], dim=1)
    if tile_base is None:
        tile_base = torch.zeros((b,), dtype=torch.int32, device=dev)
    _write_token(k_cache, v_cache, c_cache, pos, k_new, v_new, c_new,
                 tile_base, ps)
    t_max = tables.shape[2]
    # expand entries to their tps-wide tile ranges; an out-of-range id is
    # masked below, so clamping it only keeps the gather in bounds
    gt = (tables.clamp(min=0)[..., None]
          + torch.arange(tps, device=dev)).reshape(b, kv, -1).long()
    pad = (tables < 0).repeat_interleave(tps, dim=-1)
    idx = gt.clamp(max=k_cache.shape[2] - 1)[..., None, None].expand(
        -1, -1, -1, d, ps)
    kg = torch.gather(k_cache, 2, idx)
    vg = torch.gather(v_cache, 2, idx)
    s = torch.einsum('bkgd,bktdp->bkgtp', q.float(), kg.float()) * scale
    if clamp > 0.0:
        s = s.clamp(-clamp, clamp)
    t_idx = (torch.arange(t_max * tps, device=dev) // tps)[None, None, :,
                                                            None]
    p_idx = torch.arange(ps, device=dev)[None, None, None, :]
    w_tile = (tile_base + pos // ps).long()[:, None, None, None]
    w_col = (pos % ps).long()[:, None, None, None]
    gt4 = gt[..., None]
    n_valid = torch.where(
        pad[..., None], 0,
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
                                tps: int = 1, scale: float = 1.0,
                                clamp: float = 0.0):
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
        c_new, tile_base, ps=ps, tps=tps, scale=scale, clamp=clamp)
    return o.to(q.dtype), k_cache, v_cache, c_cache, k_scale, v_scale


def _common_args(q, k_cache, c_cache, tables, n_tiles, pos, c_new,
                 tile_base, ps, tps, kv_bytes):
    """Shape and shared-memory checks shared by both kernels; returns the
    int32 metadata and the launch geometry (n_all, width, n_tab, t_max)."""
    b, kv, g, d = q.shape
    n_all, width = k_cache.shape[2], c_cache.shape[3]
    n_tab, t_max = tables.shape[1], tables.shape[2]
    req = _build.require
    req(c_cache.dtype == torch.int32
        and c_cache.shape == (b, kv, n_all, width, ps),
        'code cache [B, KV, NT, w, ps] int32')
    req(c_new.shape == (b, kv, width), 'c_new [B, KV, w]')
    req(tables.shape[0] == b and n_tab >= 1 and kv % n_tab == 0,
        f'tables [B, N_TAB, T] with N_TAB | KV, got {tuple(tables.shape)}')
    req(n_tiles.shape == pos.shape == tile_base.shape == (b,),
        'n_tiles / pos / tile_base [B]')
    req(ps % 32 == 0 and ps <= 1024 and (d * ps * kv_bytes) % 16 == 0
        and 1 <= g <= 8 and tps >= 1,
        f'ps {ps} / d_head {d} / group {g} / tps {tps} outside the kernel '
        f'envelope')
    n_ent = t_max * tps
    smem = d * ps * kv_bytes + 4 * (2 * g * d + g * n_ent * ps + 32) \
        + 8 * n_ent
    if smem > SMEM_LIMIT:
        raise RuntimeError(
            f'decode attention: {smem} B of shared memory for {n_ent} table '
            f'tiles x {ps} scores per row exceeds the kernel envelope of '
            f'{SMEM_LIMIT} B')
    ints = [a if a.dtype == torch.int32 else a.to(torch.int32)
            for a in (tables, n_tiles, pos, c_new, tile_base)]
    return ints, (n_all, width, n_tab, t_max)


def decode_attention_rows(q, k_cache, v_cache, c_cache, tables, n_tiles,
                          pos, k_new, v_new, c_new, tile_base=None, *,
                          ps: int = 128, tps: int = 1, scale: float = 1.0,
                          clamp: float = 0.0):
    """bf16/f32 tile-major decode attention + in-place append.

    q [B, KV, G, D]; caches as in the module docstring (the same dtype as
    q); tables [B, N_TAB, T] PHYSICAL tile ids, -1 = unused; n_tiles [B];
    pos [B]; k_new/v_new [B, KV, D]; c_new [B, KV, w]; tile_base [B].
    Returns (o [B, KV, G, D], k, v, codes), the caches being the (updated)
    inputs. The codes are written only when w > 1, as in the TPU kernel."""
    if not _build.on_cuda(q, k_cache, v_cache, c_cache, tables, n_tiles,
                          pos, k_new, v_new, c_new):
        return decode_attention_rows_ref(
            q, k_cache, v_cache, c_cache, tables, n_tiles, pos, k_new,
            v_new, c_new, tile_base, ps=ps, tps=tps, scale=scale,
            clamp=clamp)
    b, kv, g, d = q.shape
    if tile_base is None:
        tile_base = torch.zeros((b,), dtype=torch.int32, device=q.device)
    code = _build.dtype_code(q)
    req = _build.require
    req(k_cache.dtype == v_cache.dtype == k_new.dtype == v_new.dtype
        == q.dtype, 'q, k/v caches and k/v new share one dtype')
    ints, (n_all, width, n_tab, t_max) = _common_args(
        q, k_cache, c_cache, tables, n_tiles, pos, c_new, tile_base, ps, tps,
        q.element_size())
    req(k_cache.shape == v_cache.shape == (b, kv, n_all, d, ps),
        'k/v caches [B, KV, NT, D, ps]')
    req(k_new.shape == v_new.shape == (b, kv, d), 'k/v new [B, KV, D]')
    tables, n_tiles, pos_i, c_new_i, tile_base = ints
    args = [q, k_cache, v_cache, c_cache, tables, n_tiles, pos_i, k_new,
            v_new, c_new_i, tile_base]
    req(all(a.is_contiguous() for a in args), 'inputs must be contiguous')
    o = torch.empty_like(q)
    p = _build.ptr
    err = _build.lib().spt_decode_attention(
        code, *[p(a) for a in args], p(o), b, kv, g, d, n_all, width, n_tab,
        t_max, tps, ps, float(scale), float(clamp), _build.stream())
    _build.check(err, 'decode_attention_rows')
    decode_attention_rows.launches += 1
    return o, k_cache, v_cache, c_cache


decode_attention_rows.launches = 0
decode_attention_rows_ms = decode_attention_rows


def decode_attention_rows_q(q, k_cache, v_cache, c_cache, k_scale, v_scale,
                            tables, n_tiles, pos, k_new, v_new, c_new,
                            kscale_new, vscale_new, tile_base=None, *,
                            ps: int = 128, tps: int = 1, scale: float = 1.0,
                            clamp: float = 0.0):
    """int8 tile-major decode attention + in-place append.

    The contract of decode_attention_rows, with int8 caches, their
    per-token scales [B, NT, KV_pad, ps] f32, k_new/v_new [B, KV, D] int8
    and kscale_new/vscale_new [B, KV] f32. Returns (o [B, KV, G, D], k, v,
    codes, k_scale, v_scale), the caches being the (updated) inputs. The TPU
    signature's nt_layer (a per-layer staging bound) has no counterpart
    here."""
    if not _build.on_cuda(q, k_cache, v_cache, c_cache, k_scale, v_scale,
                          tables, n_tiles, pos, k_new, v_new, c_new,
                          kscale_new, vscale_new):
        return decode_attention_rows_q_ref(
            q, k_cache, v_cache, c_cache, k_scale, v_scale, tables, n_tiles,
            pos, k_new, v_new, c_new, kscale_new, vscale_new, tile_base,
            ps=ps, tps=tps, scale=scale, clamp=clamp)
    b, kv, g, d = q.shape
    if tile_base is None:
        tile_base = torch.zeros((b,), dtype=torch.int32, device=q.device)
    code = _build.dtype_code(q)
    req = _build.require
    ints, (n_all, width, n_tab, t_max) = _common_args(
        q, k_cache, c_cache, tables, n_tiles, pos, c_new, tile_base, ps, tps,
        1)
    kv_pad = k_scale.shape[2]
    req(k_cache.dtype == v_cache.dtype == torch.int8
        and k_cache.shape == v_cache.shape == (b, kv, n_all, d, ps),
        'k/v caches [B, KV, NT, D, ps] int8')
    req(k_scale.dtype == v_scale.dtype == torch.float32
        and k_scale.shape == v_scale.shape == (b, n_all, kv_pad, ps)
        and kv_pad >= kv, 'scales [B, NT, KV_pad, ps] f32')
    req(k_new.dtype == v_new.dtype == torch.int8
        and k_new.shape == v_new.shape == (b, kv, d), 'k/v new [B, KV, D]')
    req(kscale_new.shape == vscale_new.shape == (b, kv)
        and kscale_new.dtype == vscale_new.dtype == torch.float32,
        'new scales [B, KV] f32')
    tables, n_tiles, pos_i, c_new_i, tile_base = ints
    args = [q, k_cache, v_cache, c_cache, k_scale, v_scale, tables, n_tiles,
            pos_i, k_new, v_new, c_new_i, kscale_new, vscale_new, tile_base]
    req(all(a.is_contiguous() for a in args), 'inputs must be contiguous')
    o = torch.empty_like(q)
    p = _build.ptr
    err = _build.lib().spt_decode_attention_q(
        code, *[p(a) for a in args], p(o), b, kv, g, d, n_all, width, kv_pad,
        n_tab, t_max, tps, ps, float(scale), float(clamp), _build.stream())
    _build.check(err, 'decode_attention_rows_q')
    decode_attention_rows_q.launches += 1
    return o, k_cache, v_cache, c_cache, k_scale, v_scale


decode_attention_rows_q.launches = 0
decode_attention_rows_q_ms = decode_attention_rows_q


# ---------------------------------------------------------------------------
# block verify (speculative decoding)
# ---------------------------------------------------------------------------

def _verify_checks(q, tables, sel_mask, k_new, ps):
    """The TPU wrapper's asserts (decode_attention.py:2025-2030); returns
    K, the block's column count."""
    req = _build.require
    b, kv, gk, d = q.shape
    kk = k_new.shape[3]
    req(kk <= ps, f'block of {kk} columns exceeds the tile of {ps}')
    req(kk <= 30, 'sel_mask is an int32 bitfield: at most 30 block columns')
    req(gk % kk == 0, f'q rows {gk} are not G x K for K = {kk}')
    req(tables.shape[2] >= 2, 'tables end with the two write entries')
    req(tables.shape[:2] == (b, kv), 'verify tables are per-head [B, KV, T]')
    req(sel_mask.shape == tables.shape, 'sel_mask [B, KV, T]')
    return kk


def _verify_write(k_cache, v_cache, c_cache, tables, pos, k_new, v_new,
                  c_new, tile_base, ps):
    """Append the block's K columns in place: column i goes to tile
    tile_base + (pos + i) // ps, lane (pos + i) % ps, when that tile is one
    of the row's two write entries (k/v: the head's own row; codes: head
    0's row, and only when w > 1, as the TPU kernel does)."""
    kk = k_new.shape[3]
    dev = k_cache.device
    n_all = k_cache.shape[2]
    pi = pos.long()[:, None] + torch.arange(kk, device=dev)      # [B, K]
    t_i, c_i = tile_base.long()[:, None] + pi // ps, pi % ps
    w = tables[..., -2:].long().clamp(min=0)                     # [B, KV, 2]
    hit = ((t_i[:, None, :, None] == w[:, :, None, :]).any(-1)
           & (t_i < n_all)[:, None])                            # [B, KV, K]
    bi, hi, ii = hit.nonzero(as_tuple=True)
    at = (bi, hi, t_i[bi, ii], slice(None), c_i[bi, ii])
    k_cache[at] = k_new[bi, hi, :, ii].to(k_cache.dtype)
    v_cache[at] = v_new[bi, hi, :, ii].to(v_cache.dtype)
    if c_cache.shape[3] > 1:
        hit0 = (t_i[:, :, None] == w[:, 0, None, :]).any(-1) & (t_i < n_all)
        bi, ii = hit0.nonzero(as_tuple=True)
        c_cache[bi, :, t_i[bi, ii], :, c_i[bi, ii]] = \
            c_new[bi, :, :, ii].to(c_cache.dtype)


def verify_attention_rows_ref(q, k_cache, v_cache, c_cache, tables,
                              sel_mask, pos, k_new, v_new, c_new,
                              tile_base=None, *, ps: int = 128,
                              scale: float = 1.0, clamp: float = 0.0):
    """Plain twin of the block-verify kernel (caches updated in place), with
    the TPU kernel's numerics: f32 scores, clamped only when clamp > 0; per
    query row one max over every visible lane; e = exp(s - max) rounded to
    the cache dtype before the PV product; o = pv / max(l, 1e-30) with l
    the f32 sum of the unrounded e. An entry is visible when its tile id
    lies in [0, NT); the TPU kernel leaves ids past the cache undefined."""
    kk = _verify_checks(q, tables, sel_mask, k_new, ps)
    b, kv, gk, d = q.shape
    dev = q.device
    n_all = k_cache.shape[2]
    if tile_base is None:
        tile_base = torch.zeros((b,), dtype=torch.int32, device=dev)
    _verify_write(k_cache, v_cache, c_cache, tables, pos, k_new, v_new,
                  c_new, tile_base, ps)
    tid = tables.long()
    idx = tid.clamp(0, n_all - 1)[..., None, None].expand(-1, -1, -1, d, ps)
    kg = torch.gather(k_cache, 2, idx)                     # [B, KV, T, D, ps]
    vg = torch.gather(v_cache, 2, idx)
    s = torch.einsum('bkrd,bktdp->bkrtp', q.float(), kg.float()) * scale
    if clamp > 0.0:
        s = s.clamp(-clamp, clamp)
    j = torch.arange(gk, device=dev) % kk                  # block position
    seen = (sel_mask.long()[:, :, None, :] >> j[:, None]) & 1  # [B,KV,GK,T]
    g_pos = (tid - tile_base.long()[:, None, None])[..., None] * ps \
        + torch.arange(ps, device=dev)                     # [B, KV, T, ps]
    ok = (((tid >= 0) & (tid < n_all))[:, :, None, :, None]
          & (seen[..., None] != 0)
          & (g_pos[:, :, None] <= (pos.long()[:, None, None, None, None]
                                   + j[:, None, None])))
    s = torch.where(ok, s, NEG_INF).reshape(b, kv, gk, -1)
    ok = ok.reshape(s.shape)
    m = s.amax(-1, keepdim=True)
    e = torch.where(ok, torch.exp(s - m), 0.0)
    l = e.sum(-1, keepdim=True)
    v_tok = vg.transpose(3, 4).reshape(b, kv, -1, d)       # [B, KV, T*ps, D]
    pv = e.to(v_cache.dtype).float() @ v_tok.float()
    o = pv / l.clamp(min=1e-30)
    return o.to(q.dtype), k_cache, v_cache, c_cache


def verify_attention_rows(q, k_cache, v_cache, c_cache, tables, sel_mask,
                          pos, k_new, v_new, c_new, tile_base=None, *,
                          ps: int = 128, scale: float = 1.0,
                          clamp: float = 0.0):
    """Block-verify attention + in-place append of the block's K columns
    (speculative decoding; engine.verify_step states the contract).

    q [B, KV, G*K, D] (row r of a head: query group r // K at block
    position r % K); caches tile-major as decode_attention_rows takes them
    (bf16/f32); tables [B, KV, T] PHYSICAL tile ids, -1 = padding, the
    LAST TWO entries the block's write tiles (the first may repeat the
    second, with sel_mask 0); sel_mask [B, KV, T] int32, bit j = block
    position j may attend the entry (within the tile, position j sees lanes
    up to pos + j); pos [B] the lengths before the block; k_new / v_new
    [B, KV, D, K]; c_new [B, KV, w, K] (written only when w > 1);
    tile_base [B]. Returns (o [B, KV, G*K, D], k, v, codes), the caches
    being the (updated) inputs."""
    if not _build.on_cuda(q, k_cache, v_cache, c_cache, tables, sel_mask,
                          pos, k_new, v_new, c_new):
        return verify_attention_rows_ref(
            q, k_cache, v_cache, c_cache, tables, sel_mask, pos, k_new,
            v_new, c_new, tile_base, ps=ps, scale=scale, clamp=clamp)
    kk = _verify_checks(q, tables, sel_mask, k_new, ps)
    b, kv, gk, d = q.shape
    if tile_base is None:
        tile_base = torch.zeros((b,), dtype=torch.int32, device=q.device)
    n_all, width, t_max = k_cache.shape[2], c_cache.shape[3], tables.shape[2]
    req = _build.require
    code = _build.dtype_code(q)
    req(k_cache.dtype == v_cache.dtype == k_new.dtype == v_new.dtype
        == q.dtype, 'q, k/v caches and k/v new share one dtype')
    req(k_cache.shape == v_cache.shape == (b, kv, n_all, d, ps),
        'k/v caches [B, KV, NT, D, ps]')
    req(c_cache.dtype == torch.int32
        and c_cache.shape == (b, kv, n_all, width, ps),
        'code cache [B, KV, NT, w, ps] int32')
    req(k_new.shape == v_new.shape == (b, kv, d, kk), 'k/v new [B, KV, D, K]')
    req(c_new.shape == (b, kv, width, kk), 'c_new [B, KV, w, K]')
    req(pos.shape == tile_base.shape == (b,), 'pos / tile_base [B]')
    req(ps % 32 == 0 and ps <= 1024 and (d * ps * q.element_size()) % 16 == 0,
        f'ps {ps} / d_head {d} outside the kernel envelope')
    # one CTA's shared memory (csrc/decode_attention.cu launch_verify): a
    # K/V tile, q [D][GKP] f32 (GK rows padded to 8), e [GKP][ps] and the
    # partial sums [GK][ps], the output accumulator [GK][D], row max and
    # sum, the entry list
    gkp = -(-gk // 8) * 8
    smem = d * ps * q.element_size() + 4 * (
        d * gkp + gkp * ps + gk * ps + gk * d + 2 * gkp) + 8 * t_max
    if smem > SMEM_LIMIT:
        raise RuntimeError(
            f'verify attention: {smem} B of shared memory for {gk} query rows '
            f'of d_head {d} exceeds the kernel envelope of {SMEM_LIMIT} B')
    ints = [a if a.dtype == torch.int32 else a.to(torch.int32)
            for a in (tables, sel_mask, pos, c_new, tile_base)]
    tables, sel_mask, pos_i, c_new_i, tile_base = ints
    args = [q, k_cache, v_cache, c_cache, tables, sel_mask, pos_i, k_new,
            v_new, c_new_i, tile_base]
    req(all(a.is_contiguous() for a in args), 'inputs must be contiguous')
    o = torch.empty_like(q)
    p = _build.ptr
    err = _build.lib().spt_verify_attention(
        code, *[p(a) for a in args], p(o), b, kv, gk, kk, d, n_all, width,
        t_max, ps, float(scale), float(clamp), _build.stream())
    _build.check(err, 'verify_attention_rows')
    verify_attention_rows.launches += 1
    return o, k_cache, v_cache, c_cache


verify_attention_rows.launches = 0
