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
columns a slot) launch the kernels of csrc/decode_attention.cu for CUDA
tensors and run their plain twins for CPU tensors. A table whose scores do
not fit in shared memory (`rows_walk`) goes to the two-pass walk kernel.
`rows_route` picks the bf16/f32-cache kernel: bf16 at the serving tiles
takes the split walk on the tensor cores (each row's entries in chunks of
`rows_split_plan`, one cluster a row), f32 and shapes off that rule the
kernels `rows_walk` names. `q_route` picks the int8-cache kernel: a bf16
q at the serving tiles takes the split walk on the tensor cores (each
row's entries in chunks of `q_split_entries`, a CTA each), f32 and shapes
off that rule the kernels `rows_walk` names.
The TPU package has two launch shapes of each function (one program per
slot, and `_ms`: one program for all slots); here one kernel serves both,
and the `_ms` names are the same wrappers.

`decode_attention` (the TPU package's tile-pool kernel: a flat pool of
token-minor tiles behind a table) launches csrc/paged_attention.cu's
tile-pool kernel; nothing in the engine serves through it, as in JAX.

The caches are updated IN PLACE: the new token's k/v/codes (and scales)
land at tile `tile_base + pos // ps`, column `pos % ps`, and the same
tensors are returned. This is the port's counterpart of the TPU kernels'
input_output_aliases.
"""
from __future__ import annotations

import functools

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


def rows_walk(g: int, d: int, ps: int, n_ent: int, kv_bytes: int) -> str:
    """Which kernel serves a decode_attention_rows(_q) launch: 'one-pass'
    keeps the G x n_ent x ps f32 scores of the table (n_ent = T x tps
    entries) in shared memory; past SMEM_LIMIT, 'two-pass' walks the table
    twice with shared memory that depends on G, d and ps only (the same
    numerics; decode_attention_walk_kernel on csrc/softmax_walk.cuh, whose
    walk_smem_bytes this mirrors: a tile staged as f32, and an int8 tile's
    key and value scales)."""
    one = d * ps * kv_bytes + 4 * (2 * g * d + g * n_ent * ps + 32) \
        + 8 * n_ent
    if one <= SMEM_LIMIT:
        return 'one-pass'
    two = 4 * (d * (ps + 1) + 2 * g * d + g * ps + 2 * g
               + (2 * ps if kv_bytes == 1 else 0))
    if two > SMEM_LIMIT:
        raise RuntimeError(
            f'decode attention: {two} B of shared memory for {g} query rows '
            f'of d_head {d} exceeds the kernel envelope of {SMEM_LIMIT} B')
    return 'two-pass'


SPLIT_CTAS = 4 * 132      # CTAs the split walk aims for: 4 an H100 SM
SPLIT_MAX_ENTRIES = 4     # entries (tiles) a split CTA stages at most
SPLIT_CLUSTER = 4         # chunks a row combines in one cluster, at most
                          # (csrc kSplitCluster; more use the work buffer)


def q_route(dtype: torch.dtype, g: int, d: int, ps: int, n_ent: int,
            aligned: bool = True) -> str:
    """The kernel a decode_attention_rows_q launch runs: 'split'
    (decode_attention_q_split_kernel) for a bf16 q with 128-token tiles,
    d_head 64 or 128, G <= 8 and 16-byte aligned q, caches and scales
    (`aligned`), whatever the table's length; else what rows_walk names
    for the table ('one-pass' or 'two-pass')."""
    if (dtype == torch.bfloat16 and ps == 128 and d in (64, 128)
            and 1 <= g <= 8 and aligned):
        return 'split'
    return rows_walk(g, d, ps, n_ent, 1)


def q_split_entries(rows: int, n_ent: int) -> int:
    """Entries a chunk of the split walk takes (a CTA each): as many as
    keep the launch at SPLIT_CTAS CTAs or more for `rows` (slot, kv head)
    rows of `n_ent` entries, 1 to SPLIT_MAX_ENTRIES."""
    return max(1, min(SPLIT_MAX_ENTRIES, rows * n_ent // SPLIT_CTAS))


ROWS_CLUSTER = 8           # chunks a row at most, one cluster (the
                           # portable cluster size, csrc kRowsCluster)
ROWS_CHUNK = 6             # entries a split CTA aims at: fewer, longer
                           # chunks ran faster than many short ones
                           # (kernel_ab.py --attn-sweep)


def rows_route(dtype: torch.dtype, g: int, d: int, ps: int, n_ent: int,
               aligned: bool = True) -> str:
    """The kernel a decode_attention_rows launch runs: 'split'
    (decode_attention_split_kernel) for a bf16 cache with 128-token tiles,
    d_head 64 or 128, G <= 8 and 16-byte aligned q, caches and new k / v
    (`aligned`), whatever the table's length; else what rows_walk names
    for the table ('one-pass' or 'two-pass')."""
    if (dtype == torch.bfloat16 and ps == 128 and d in (64, 128)
            and 1 <= g <= 8 and aligned):
        return 'split'
    return rows_walk(g, d, ps, n_ent, 4 if dtype == torch.float32 else 2)


@functools.lru_cache(maxsize=256)
def rows_split_plan(n_ent: int) -> tuple[int, int]:
    """The split walk's plan for table rows of `n_ent` entries: (chunks a
    row, entries a chunk). One CTA a chunk and one cluster a row: as many
    chunks as make chunks of about ROWS_CHUNK entries, at most
    ROWS_CLUSTER; chunk c takes entries c*e .. min((c+1)*e, n_ent) - 1."""
    chunks = min(ROWS_CLUSTER, -(-n_ent // ROWS_CHUNK))
    e = -(-n_ent // chunks)
    return -(-n_ent // e), e


@functools.lru_cache(maxsize=256)
def rows_split_scores(e: int, g: int, d: int, width: int) -> int:
    """Floats of global score buffer a split CTA takes for chunks of `e`
    entries, G = g query rows, d_head d and code width `width`: 0 while
    its scores fit in shared memory (the kernel library's own layout,
    csrc rows_split_smem_bytes), else e x g x 132 (rows past ~40,000
    tokens at G = 8)."""
    return _build.lib().spt_rows_split_scores(e, g, d, width)


def q_split_chunks(n_ent: int, e: int) -> int:
    """Chunks of a table row of `n_ent` entries, `e` a chunk (the last
    may be short): chunk c takes entries c*e .. min((c+1)*e, n_ent) - 1."""
    return -(-n_ent // e)


def _common_args(q, k_cache, c_cache, tables, n_tiles, pos, c_new,
                 tile_base, ps, tps, kv_bytes):
    """Shape checks shared by both kernels; returns the int32 metadata, the
    launch geometry (n_all, width, n_tab, t_max) and the walk (1 for the
    two-pass kernel)."""
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
    two_pass = int(rows_walk(g, d, ps, t_max * tps, kv_bytes) == 'two-pass')
    ints = [a if a.dtype == torch.int32 else a.to(torch.int32)
            for a in (tables, n_tiles, pos, c_new, tile_base)]
    return ints, (n_all, width, n_tab, t_max), two_pass


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
    ints, (n_all, width, n_tab, t_max), two_pass = _common_args(
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
    walk, e, chunks, scores = two_pass, 0, 0, None
    if rows_route(q.dtype, g, d, ps, t_max * tps, all(
            a.data_ptr() % 16 == 0
            for a in (q, k_cache, v_cache, k_new, v_new))) == 'split':
        walk = 2
        chunks, e = rows_split_plan(t_max * tps)
        spill = rows_split_scores(e, g, d, width)
        if spill:
            scores = torch.empty((b * kv * chunks, spill),
                                 dtype=torch.float32, device=q.device)
    err = _build.lib().spt_decode_attention(
        code, walk, *[p(a) for a in args], p(o), b, kv, g, d, n_all,
        width, n_tab, t_max, tps, ps, float(scale), float(clamp), e, chunks,
        p(scores), _build.stream())
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
    ints, (n_all, width, n_tab, t_max), _ = _common_args(
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
    route = q_route(q.dtype, g, d, ps, t_max * tps, all(
        a.data_ptr() % 16 == 0 for a in (q, k_cache, v_cache, k_scale,
                                         v_scale)))
    walk, e, work, counters = int(route == 'two-pass'), 0, None, None
    if route == 'split':
        walk, e = 2, q_split_entries(b * kv, t_max * tps)
        chunks = q_split_chunks(t_max * tps, e)
        if chunks > SPLIT_CLUSTER:    # else the chunks combine in a cluster
            work = torch.empty((b * kv * chunks * g, d + 2),
                               dtype=torch.float32, device=q.device)
            counters = torch.zeros((b * kv,), dtype=torch.int32,
                                   device=q.device)
    err = _build.lib().spt_decode_attention_q(
        code, walk, *[p(a) for a in args], p(o), b, kv, g, d, n_all,
        width, kv_pad, n_tab, t_max, tps, ps, float(scale), float(clamp), e,
        p(work), p(counters), _build.stream())
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


def verify_smem(rows: int, d: int, ps: int, t_max: int, elem: int) -> int:
    """Shared memory of a verify CTA over `rows` query rows
    (csrc/decode_attention.cu launch_verify): a K/V tile, q [D][RP] f32
    (rows padded to 8), e [RP][ps] and the partial sums [rows][ps], the
    output accumulator [rows][D], row max and sum, the entry list."""
    rp = -(-rows // 8) * 8
    return d * ps * elem + 4 * (d * rp + rp * ps + rows * ps + rows * d
                                + 2 * rp) + 8 * t_max


def verify_rows_per_cta(gk: int, d: int, ps: int, t_max: int,
                        elem: int) -> int:
    """Query rows a verify CTA takes: all GK when their buffers fit
    SMEM_LIMIT (one CTA per (slot, kv head), as before), else the G*K rows
    split into the fewest equal chunks of a multiple of 8 rows that fit,
    one CTA each (a third grid axis). Raises when not even 8 rows fit."""
    if verify_smem(gk, d, ps, t_max, elem) <= SMEM_LIMIT:
        return gk
    fit = 0
    while verify_smem(fit + 8, d, ps, t_max, elem) <= SMEM_LIMIT:
        fit += 8
    if fit == 0:
        raise RuntimeError(
            f'verify attention: {verify_smem(8, d, ps, t_max, elem)} B of '
            f'shared memory for 8 query rows of d_head {d} and {ps}-token '
            f'tiles exceeds the kernel envelope of {SMEM_LIMIT} B')
    chunks = -(-gk // fit)
    return -(-gk // chunks // 8) * 8 if chunks > 1 else gk


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
    being the (updated) inputs. When the G*K rows' buffers outgrow one
    CTA's shared memory the rows split into chunks, a CTA each
    (verify_rows_per_cta): every chunk scores the whole table, chunk 0
    appends the new columns and the others read them from k_new / v_new."""
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
    rows = verify_rows_per_cta(gk, d, ps, t_max, q.element_size())
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
        t_max, ps, float(scale), float(clamp), rows, _build.stream())
    _build.check(err, 'verify_attention_rows')
    verify_attention_rows.launches += 1
    return o, k_cache, v_cache, c_cache


verify_attention_rows.launches = 0


# ---------------------------------------------------------------------------
# tile-pool decode attention (flat pool of token-minor tiles)
# ---------------------------------------------------------------------------

def decode_attention_ref(q, k_pool, v_pool, c_pool, tables, n_tiles,
                         last_count, k_new, v_new, c_new, write_tile,
                         write_slot, *, ps: int, scale: float,
                         clamp: float = 0.0):
    """Plain twin of the tile-pool kernel (the JAX oracle,
    decode_attention.py:234): write the new token's k/v/codes at (write_tile,
    :, write_slot) of the pools in place, then a masked softmax over the
    table's entries (entry n_tiles - 1 with last_count valid lanes, the
    earlier ones full, later ones empty); the normalised probabilities are
    rounded to the pool dtype before the PV product."""
    bk, g, d = q.shape
    dev = q.device
    wt, ws = write_tile.long(), write_slot.long()
    k_pool[wt, :, ws] = k_new.to(k_pool.dtype)
    v_pool[wt, :, ws] = v_new.to(v_pool.dtype)
    c_pool[wt, :, ws] = c_new.to(c_pool.dtype)
    t_max = tables.shape[1]
    idx = tables.long() % k_pool.shape[0]          # jnp's wrap of -1 ids
    kg, vg = k_pool[idx], v_pool[idx]              # [BK, T, D, ps]
    s = torch.einsum('bgd,btdp->bgtp', q.float(), kg.float()) * scale
    if clamp > 0.0:
        s = s.clamp(-clamp, clamp)
    t_idx = torch.arange(t_max, device=dev)[None, :, None]
    p_idx = torch.arange(ps, device=dev)[None, None, :]
    n_valid = torch.where(t_idx == (n_tiles.long() - 1)[:, None, None],
                          last_count.long()[:, None, None], ps)
    ok = (t_idx < n_tiles.long()[:, None, None]) & (p_idx < n_valid)
    s = torch.where(ok[:, None], s, NEG_INF)
    p = torch.softmax(s.reshape(bk, g, -1), dim=-1).reshape(s.shape)
    p = torch.where(ok[:, None], p, 0.0)
    o = torch.einsum('bgtp,btdp->bgd', p.to(vg.dtype).float(), vg.float())
    return o.to(q.dtype), k_pool, v_pool, c_pool


def decode_attention(q, k_pool, v_pool, c_pool, tables, n_tiles, last_count,
                     k_new, v_new, c_new, write_tile, write_slot, *, ps: int,
                     scale: float, clamp: float = 0.0):
    """Decode attention over a flat pool of token-minor tiles addressed
    through a table (the TPU kernel's contract, decode_attention.py:156),
    appending the new token in place first.

    q [BK, G, D]; k_pool / v_pool [P, D, ps] (q's dtype); c_pool [P, n_sub,
    ps] int32; tables [BK, T] tile ids (entries 0..n_tiles-2 full, entry
    n_tiles-1 with last_count valid lanes; a negative id wraps into the
    pool, as the oracle's gather wraps -1); n_tiles / last_count /
    write_tile / write_slot [BK]; k_new / v_new [BK, D]; c_new [BK, n_sub].
    Returns (o [BK, G, D], k_pool, v_pool, c_pool), the pools being the
    (updated) inputs. The scores are clamped only when clamp > 0."""
    ins = (q, k_pool, v_pool, c_pool, tables, n_tiles, last_count, k_new,
           v_new, c_new, write_tile, write_slot)
    if not _build.on_cuda(*ins):
        return decode_attention_ref(*ins, ps=ps, scale=scale, clamp=clamp)
    bk, g, d = q.shape
    n_pool, n_sub = k_pool.shape[0], c_pool.shape[1]
    t_max = tables.shape[1]
    req = _build.require
    code = _build.dtype_code(q)
    req(k_pool.dtype == v_pool.dtype == k_new.dtype == v_new.dtype
        == q.dtype, 'q, pools and k/v new share one dtype')
    req(k_pool.shape == v_pool.shape == (n_pool, d, ps),
        'k/v pools [P, D, ps]')
    req(c_pool.dtype == torch.int32 and c_pool.shape == (n_pool, n_sub, ps),
        'code pool [P, n_sub, ps] int32')
    req(k_new.shape == v_new.shape == (bk, d) and c_new.shape == (bk, n_sub),
        'k/v new [BK, D], c_new [BK, n_sub]')
    req(tables.shape[0] == bk and n_tiles.shape == last_count.shape
        == write_tile.shape == write_slot.shape == (bk,),
        'tables [BK, T]; n_tiles / last_count / write_tile / write_slot '
        '[BK]')
    req(ps % 16 == 0 and d % 16 == 0 and 1 <= g <= 8,
        f'ps {ps} / d_head {d} / group {g} outside the kernel envelope')
    smem = 4 * (d * (ps + 1) + 2 * g * d + g * ps + 2 * g)
    req(smem <= SMEM_LIMIT, f'{smem} B of shared memory exceeds the kernel '
        f'envelope of {SMEM_LIMIT} B')
    ints = [a.to(torch.int32) for a in (tables, n_tiles, last_count, c_new,
                                        write_tile, write_slot)]
    tables_i, n_tiles_i, last_i, c_new_i, wt_i, ws_i = ints
    args = [q, k_pool, v_pool, c_pool, tables_i, n_tiles_i, last_i, k_new,
            v_new, c_new_i, wt_i, ws_i]
    req(all(a.is_contiguous() for a in args), 'inputs must be contiguous')
    o = torch.empty_like(q)
    p = _build.ptr
    err = _build.lib().spt_tile_pool_attention(
        code, *[p(a) for a in args], p(o), bk, n_pool, g, d, n_sub, t_max,
        ps, float(scale), float(clamp), _build.stream())
    _build.check(err, 'decode_attention')
    decode_attention.launches += 1
    return o, k_pool, v_pool, c_pool


decode_attention.launches = 0
