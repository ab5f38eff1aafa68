#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spt_proto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card's name and power limit (nvidia-smi), build the CUDA
   kernels from spt_proto_tpu_torch/csrc and print the build time;
2. hold each kernel against its plain PyTorch twin on the same CUDA tensors,
   at the serving shapes (OPT-125M, B=8, context 2048) in bf16 and f32: the
   decode front (with and without int8 KV quantization, with the stacked fp
   and the packed int8 QKV weight), decode attention over a bf16/f32 cache
   (dense tables at max_len 2176, dense supertiles of 4 at max_len 2048,
   sparse tables) and over an int8 cache (sparse tables, and dense
   supertiles of 4 through one table row), the lm_head argmax (fp, and int8
   at OPT-125M and OPT-1.3B widths), block-sparse prefill attention (also
   with off-diagonal and -1 entries at S=4096, sparse_coeff 4), the fused FFN
   tail (fp and int8) at OPT-125M and OPT-1.3B widths, and the int8 matmul
   at the decode shapes (m = 8: o and qkv of OPT-125M and OPT-1.3B) and a
   prefill shape (m = 16,384, fc1 of OPT-125M); time kernel, twin and the
   one-call library equivalent where there is one;
3. slice parity at full width: OPT-125M (random weights from a seed) in f32,
   B=2, prompt 512, 8 greedy steps, on the card through the kernels and on
   the CPU through the plain twins, in six decode modes (sparse int8-KV,
   dense f32-KV, sparse f32-KV, the unfused l1 front over int8 KV, and with
   int8 weights (w8, built staged on the card) sparse int8-KV and dense
   f32-KV); the greedy tokens must agree;
4. the serving runs, OPT-125M in bf16, B=8, prompt 2048, max_len 2176, in
   bench.py's three decode modes (dense bf16-KV, sparse bf16-KV, sparse
   int8-KV), sparse int8-KV with the fused FFN tail, and with int8 weights
   (bench_serving.py's int8 mode) sparse int8-KV and dense bf16-KV: prefill
   + 32 greedy steps each, with the kernel launch counters zeroed before
   and read after each run and checked exactly, prefill / decode tokens per
   second from CUDA events, and a profiled 4-step decode window per mode;
5. bench.py's OPT-1.3B rung: dense bf16-KV vs sparse int8-KV, and sparse
   int8-KV w8 (the round-4 ladder's "sparse w8"), B=8, prompt 2048, max_len
   2176, 32 steps, with tokens per second and peak memory;
6. print the per-kernel JSON line, then the contract line
   {"ok": true, "device": {...}} last.

It needs the rest of the repository beside it and a CUDA device; without
either it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# dense bf16 / f32 (no tensor core) / int8 (the int8 KV attention's int8
# inputs); the int8 weight kernels multiply in bf16 and count at bf16's rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
            torch.int8: 1979e12}
SEED = 0
DEV = 'cuda'
L2_FLUSH_BYTES = 128 << 20          # > the 50 MB L2: launches start cold
SPIN_CYCLES = 10_000_000            # ~5 ms at the H100's clock

# serving shapes (bench.py's decode headline, OPT-125M)
B, PROMPT, MAX_LEN, STEPS = 8, 2048, 2176, 32
D, HEADS, LAYERS, VOCAB, FF = 768, 12, 12, 50272, 3072
DH, N_SUB, N_CODE, TILE = 64, 8, 16, 128
NT = -(-MAX_LEN // TILE)                      # 17 tiles per layer
NSEL = min(NT, max(1, NT // 8) + 1)           # sparse_coeff 8 -> 3
D_13B, FF_13B = 2048, 8192                    # OPT-1.3B widths
# (m, K, N) of int8_matmul on the w8 paths: decode (m = B) o and qkv of
# OPT-125M and OPT-1.3B, prefill (m = B x PROMPT) fc1 of OPT-125M; the
# first is the one the kernel line reports (o runs every layer and step)
INT8_MATMUL_SHAPES = {
    'decode o 125m': (B, D, D), 'decode qkv 125m': (B, D, 3 * D),
    'decode o 1.3b': (B, D_13B, D_13B),
    'decode qkv 1.3b': (B, D_13B, 3 * D_13B),
    'prefill fc1 125m': (B * PROMPT, D, FF)}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of one call, each launch starting with a cold L2
    (a 128 MB buffer is rewritten outside the timed window). A spin kernel
    holds the stream while the host enqueues the call, so the window holds
    device time, not the wrappers' Python."""

    def __init__(self):
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device=DEV)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        times.sort()
        return times[len(times) // 2]


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    """Least time for the work: bytes over HBM rate vs ops over peak."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_b, 'bytes') if t_b >= t_o else (t_o, 'operations')


def nbytes(*ts) -> int:
    """Bytes of the tensors (int8 weight dicts count q and scale)."""
    return sum(nbytes(*t.values()) if isinstance(t, dict)
               else t.numel() * t.element_size() for t in ts if t is not None)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def tolerance(dtype) -> tuple[float, float]:
    """(atol, rtol): f32 1e-5 / 1e-5; bf16 2e-2 and one bf16 step (2^-7)
    relative, since kernel and twin round to bf16 at different places."""
    return (1e-5, 1e-5) if dtype == torch.float32 else (2e-2, 2 ** -7)


def close(got, want, dtype) -> bool:
    atol, rtol = tolerance(dtype)
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * want.float().abs()).all())


def tol_str(dtype) -> str:
    atol, rtol = tolerance(dtype)
    return f'tol {atol:g} + {rtol:g}|x|'


def mismatch(a, b) -> float:
    return (a != b).float().mean().item()


def sync() -> None:
    if DEV == 'cuda':
        torch.cuda.synchronize()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def gen(seed: int, dev=None) -> torch.Generator:
    g = torch.Generator(device=dev or DEV)
    g.manual_seed(seed)
    return g


def randn(g, shape, dtype, dev=None, std=1.0):
    return (torch.randn(shape, generator=g, device=dev or DEV)
            * std).to(dtype)


def log_times(res) -> None:
    """One line with a timed check's device times and bound."""
    extra = (f', unfused torch {res["unfused_ms"] * 1e3:.1f} us'
             if 'unfused_ms' in res else '')
    lib = (f', library {res["library_ms"] * 1e3:.1f} us'
           if res.get('library_ms') is not None else '')
    log(f'      {res["ms"] * 1e3:.1f} us (cold L2), bound '
        f'{res["bound_ms"] * 1e3:.2f} us ({res["bound_by"]}), plain '
        f'{res["plain_ms"] * 1e3:.1f} us{lib}{extra}')


def covered_tokens(tables, n_tiles, pos, tile_base, tps, kv) -> int:
    """(slot, head, token) triples the tables cover, masked as in the
    kernels: full tiles below the write tile, the write tile up to the new
    token; -1 entries and entries at or past n_tiles are empty."""
    rows = tables.repeat_interleave(kv // tables.shape[1], dim=1).long()
    t_max = rows.shape[2]
    gt = rows[..., None] + torch.arange(tps, device=rows.device)
    ok = (rows >= 0) & (torch.arange(t_max, device=rows.device)
                        < n_tiles[:, None, None])
    wt = (tile_base + pos // TILE).long()[:, None, None, None]
    per = torch.where(gt == wt, (pos % TILE + 1).long()[:, None, None, None],
                      torch.where(gt < wt, TILE, 0))
    return int((per * ok[..., None]).sum())


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain twin
# ---------------------------------------------------------------------------

def front_inputs(dtype, g):
    b, d, kv, layers, nt, dev = B, D, HEADS, LAYERS, NT, DEV
    from spt_proto_tpu_torch.ops.decode_front import build_pq_bd
    x = randn(g, (b, d), dtype, dev)
    nsc = (1 + randn(g, (d,), torch.float32, dev, 0.1)).to(dtype)
    nbi = randn(g, (d,), dtype, dev, 0.1)
    w = randn(g, (3, d, d), dtype, dev, d ** -0.5)
    bq = randn(g, (3, d), dtype, dev, 0.1)
    bd, cbn = build_pq_bd(randn(g, (N_SUB, N_CODE, d // kv // N_SUB),
                                torch.float32, dev))
    cc = torch.randint(0, N_CODE, (b, kv, layers * nt, N_SUB, TILE),
                       generator=g, device=dev, dtype=torch.int32)
    pos = (nt - 1) * TILE + torch.arange(b, device=dev, dtype=torch.int32)
    return [x, nsc, nbi, w, bq, bd, cbn, cc, pos]


def int8_weight(g, k, n, dtype):
    """A [k, n] weight in `dtype` (std k^-1/2) through the int8 build's
    quantizer: {'q': [k, n_pad] int8, 'scale': [1, n] f32}."""
    from spt_proto_tpu_torch.inference.weights import quantize_int8
    return quantize_int8(randn(g, (k, n), dtype, std=k ** -0.5))


def dequant(wq, dtype):
    """The true-width [k, n] weight in `dtype` (for the library yardstick:
    it reads twice the bytes of the int8 weight)."""
    n = wq['scale'].numel()
    return (wq['q'][:, :n].float() * wq['scale'].reshape(1, n)).to(dtype)


def check_front(dtype, timer=None, quantized=True, packed=False):
    """decode_front vs decode_front_ref at the serving shape (the middle
    layer's slab), with int8 KV quantization (sparse int8-KV decode) or
    without (sparse bf16-KV decode), with the stacked fp QKV weight or the
    packed int8 one (int8 weight-only serving)."""
    from spt_proto_tpu_torch.ops import decode_front as m
    args = front_inputs(dtype, gen(SEED + 1))
    if packed:
        from spt_proto_tpu_torch.inference.weights import quantize_int8
        args[3] = quantize_int8(torch.cat(list(args[3]), dim=-1))
    kw = dict(nt=NT, nsel=NSEL, n_sub=N_SUB, ps=TILE, quantized=quantized)
    base = LAYERS // 2 * NT
    got = m.decode_front(*args, base, **kw)
    want = m.decode_front_ref(*args, base, **kw)
    sync()
    require(len(got) == len(want) == (9 if quantized else 5),
            f'decode_front returned {len(got)} outputs')
    q_err = max(max_err(g_, w_) for g_, w_ in zip(got[:3], want[:3]))
    # exact expected; the kernel and torch sum the projection in different
    # orders, so a projection one rounding step apart can move a value
    # across an argmin or int8 boundary. Codes and tables: none in f32, at
    # most one flipped entry each in bf16 (a wrong selection on a head
    # shows as more). k8/v8: a few values one int8 step apart. The packed
    # int8 form rounds the kernel's own f32 norm output to bf16 in both
    # serving dtypes, so an f32 ulp between its norm sums and the twin's
    # can become a whole bf16 step of one operand: it is held to the bf16
    # bounds in f32 too.
    tdt = torch.bfloat16 if packed else dtype
    sel_flips = max(int((got[i] != want[i]).sum()) for i in (3, 4))
    sel_tol = 0 if tdt == torch.float32 else 1
    qkv_ok = all(close(g_, w_, tdt) for g_, w_ in zip(got[:3], want[:3]))
    label = (f'decode_front {"packed-int8 " if packed else ""}'
             f'{"int8-KV" if quantized else "bf16-KV"}')
    if quantized:
        kv_flips = max(mismatch(got[i], want[i]) for i in (5, 6))
        kv_tol = 1e-3 if tdt == torch.float32 else 1e-2
        step = max(max_err(got[i], want[i]) for i in (5, 6))
        s_err = max(((got[i] - want[i]).abs() / want[i]).max().item()
                    for i in (7, 8))
        s_tol = 1e-5 if tdt == torch.float32 else 1e-2
        kv_ok = kv_flips <= kv_tol and step <= 1 and s_err <= s_tol
        kv_msg = (f'; k8/v8 mismatch {kv_flips:.3g} (tol {kv_tol}), int8 '
                  f'step {step}, scale rel err {s_err:.3g}')
    else:
        kv_ok, kv_msg = True, ''
    require(qkv_ok and sel_flips <= sel_tol and kv_ok,
            f'{label} {dtype}: qkv err {q_err}, code/table flips '
            f'{sel_flips} (tol {sel_tol}){kv_msg}')
    log(f'  {label:31s} {str(dtype):15s} qkv max err {q_err:.3g} '
        f'({tol_str(tdt)}); code/table entries flipped {sel_flips} '
        f'(tol {sel_tol}){kv_msg}')
    res = dict(max_abs_err=q_err)
    if timer is not None:
        x, nsc, nbi, w, bq, bd, cbn, cc, pos = args
        res['ms'] = timer.ms(lambda: m.decode_front(*args, base, **kw))
        res['plain_ms'] = timer.ms(lambda: m.decode_front_ref(*args, base,
                                                              **kw), reps=5)
        cur = int(pos[0]) // TILE
        n_full = min(cur, NT)
        slab = B * HEADS * n_full * N_SUB * TILE * 4   # code slab it scans
        io = nbytes(x, nsc, nbi, w, bq, bd, cbn, pos, *got)
        ops = 2 * B * D * 3 * D + 2 * 2 * B * D * N_CODE
        res['bound_ms'], res['bound_by'] = bound_ms(io + slab, ops, dtype)
        res['library_ms'] = None
        log_times(res)
    return res, got


def attention_inputs(dtype, front_out, g):
    """int8 caches at the serving shape; tables and the new token from the
    decode_front outputs (their contract: entry n_tiles-1 is the write
    tile)."""
    q, k, v, c_new, tables, k8, v8, ks, vs = front_out
    n_all = LAYERS * NT
    kc = torch.randint(-127, 128, (B, HEADS, n_all, DH, TILE), generator=g,
                       device=DEV, dtype=torch.int8)
    vc = torch.randint(-127, 128, kc.shape, generator=g, device=DEV,
                       dtype=torch.int8)
    cc = torch.randint(0, N_CODE, (B, HEADS, n_all, N_SUB, TILE), generator=g,
                       device=DEV, dtype=torch.int32)
    kvp = -(-HEADS // 8) * 8
    ksc = torch.rand((B, n_all, kvp, TILE), generator=g, device=DEV) * 0.05
    vsc = torch.rand(ksc.shape, generator=g, device=DEV) * 0.05
    ksc[:, :, HEADS:] = vsc[:, :, HEADS:] = 0.0
    pos = (NT - 1) * TILE + torch.arange(B, device=DEV, dtype=torch.int32)
    base = torch.full((B,), LAYERS // 2 * NT, device=DEV, dtype=torch.int32)
    n_tiles = torch.full((B,), tables.shape[2], device=DEV,
                         dtype=torch.int32)
    return [q.reshape(B, HEADS, 1, DH), kc, vc, cc, ksc, vsc, tables, n_tiles,
            pos, k8.reshape(B, HEADS, DH), v8.reshape(B, HEADS, DH), c_new,
            ks, vs, base]


def dense_tables(pos, nt, tps, base):
    """One table row for all heads: supertile starts e * tps (+ base) for
    e <= (pos // TILE) // tps, -1 past them; the JAX engine's dense form."""
    cur = (pos // TILE).long()
    e = torch.arange(-(-nt // tps), device=pos.device)
    n_sup = cur // tps + 1
    tables = torch.where(e[None] < n_sup[:, None], e * tps + base, -1)
    return tables[:, None].to(torch.int32), n_sup.to(torch.int32)


def attention_q_dense_inputs(g):
    """int8 caches at max_len 2048 (16 tiles a layer) read as dense
    supertiles of 4 through one table row, slots at positions 2040-2047."""
    nt, tps = PROMPT // TILE, 4
    n_all = LAYERS * nt
    base = LAYERS // 2 * nt
    kc = torch.randint(-127, 128, (B, HEADS, n_all, DH, TILE), generator=g,
                       device=DEV, dtype=torch.int8)
    vc = torch.randint(-127, 128, kc.shape, generator=g, device=DEV,
                       dtype=torch.int8)
    cc = torch.zeros((B, HEADS, n_all, 1, TILE), device=DEV,
                     dtype=torch.int32)
    kvp = -(-HEADS // 8) * 8
    ksc = torch.rand((B, n_all, kvp, TILE), generator=g, device=DEV) * 0.05
    vsc = torch.rand(ksc.shape, generator=g, device=DEV) * 0.05
    ksc[:, :, HEADS:] = vsc[:, :, HEADS:] = 0.0
    pos = PROMPT - B + torch.arange(B, device=DEV, dtype=torch.int32)
    tables, n_tiles = dense_tables(pos, nt, tps, base)
    kn = torch.randint(-127, 128, (B, HEADS, DH), generator=g, device=DEV,
                       dtype=torch.int8)
    vn = torch.randint(-127, 128, kn.shape, generator=g, device=DEV,
                       dtype=torch.int8)
    ksn = torch.rand((B, HEADS), generator=g, device=DEV) * 0.05
    vsn = torch.rand((B, HEADS), generator=g, device=DEV) * 0.05
    return [None, kc, vc, cc, ksc, vsc, tables, n_tiles, pos, kn, vn,
            torch.zeros((B, HEADS, 1), device=DEV, dtype=torch.int32), ksn,
            vsn, torch.full((B,), base, device=DEV, dtype=torch.int32)], tps


def check_attention(dtype, front_out, timer=None, dense=False):
    """decode_attention_rows_q vs its twin: sparse tables from the front at
    the serving shape, or (dense=True) dense supertiles of 4 through one
    table row, as dense decode over the int8 cache sends them."""
    from spt_proto_tpu_torch.ops import decode_attention as m
    g = gen(SEED + 2)
    if dense:
        args, tps = attention_q_dense_inputs(g)
        args[0] = randn(g, (B, HEADS, 1, DH), dtype)
        label = 'int8 dense tps 4'
    else:
        args, tps = attention_inputs(dtype, front_out, g), 1
        label = 'int8 sparse'
    kw = dict(ps=TILE, tps=tps, scale=DH ** -0.5,
              clamp=0.0 if dense else 10.0)
    ref_args = [a.clone() for a in args]
    got = m.decode_attention_rows_q(*args, **kw)
    want = m.decode_attention_rows_q_ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    caches_equal = all(torch.equal(g_, w_) for g_, w_ in zip(got[1:],
                                                             want[1:]))
    require(close(got[0], want[0], dtype) and caches_equal,
            f'decode_attention_rows_q {label} {dtype}: o err {err}, appended '
            f'caches equal: {caches_equal}')
    log(f'  decode_attention_rows_q {label} {str(dtype):14s} o max err '
        f'{err:.3g} ({tol_str(dtype)}); appended caches exact')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.decode_attention_rows_q(*args, **kw))
        res['plain_ms'] = timer.ms(
            lambda: m.decode_attention_rows_q_ref(*ref_args, **kw), reps=5)
        q, tables, n_tiles, pos, tb = args[0], args[6], args[7], args[8], \
            args[14]
        tokens = covered_tokens(tables, n_tiles, pos, tb, tps, HEADS)
        moved = tokens * (2 * DH + 2 * 4)           # K, V int8 + 2 scales
        io = nbytes(q, *args[6:15], got[0])
        ops = tokens * 2 * 2 * DH
        res['bound_ms'], res['bound_by'] = bound_ms(moved + io, ops,
                                                    torch.int8)
        res['library_ms'] = None
        log_times(res)
    return res


def rows_inputs(dtype, mode, front_out, g):
    """bf16/f32 caches at the serving shape for decode_attention_rows.
    'dense': max_len 2176 (17 tiles a layer), tps 1, one table row of 17
    entries, slots at 2048-2055; 'dense-tps4': max_len 2048, supertiles of
    4, slots at 2040-2047; 'sparse': the bf16-KV front's tables and new
    token (3 tiles a head)."""
    nt = PROMPT // TILE if mode == 'dense-tps4' else NT
    n_all = LAYERS * nt
    base = LAYERS // 2 * nt
    kc = randn(g, (B, HEADS, n_all, DH, TILE), dtype)
    vc = randn(g, kc.shape, dtype)
    if mode == 'sparse':
        q, k, v, c_new, tables = front_out[:5]
        q4, kn, vn = (q.reshape(B, HEADS, 1, DH), k.reshape(B, HEADS, DH),
                      v.reshape(B, HEADS, DH))
        cc = torch.randint(0, N_CODE, (B, HEADS, n_all, N_SUB, TILE),
                           generator=g, device=DEV, dtype=torch.int32)
        pos = (NT - 1) * TILE + torch.arange(B, device=DEV, dtype=torch.int32)
        n_tiles = torch.full((B,), NSEL, device=DEV, dtype=torch.int32)
        tps = 1
    else:
        tps = 4 if mode == 'dense-tps4' else 1
        q4 = randn(g, (B, HEADS, 1, DH), dtype)
        kn, vn = randn(g, (B, HEADS, DH), dtype), randn(g, (B, HEADS, DH),
                                                       dtype)
        cc = torch.zeros((B, HEADS, n_all, 1, TILE), device=DEV,
                         dtype=torch.int32)
        c_new = torch.zeros((B, HEADS, 1), device=DEV, dtype=torch.int32)
        first = PROMPT - B if mode == 'dense-tps4' else PROMPT
        pos = first + torch.arange(B, device=DEV, dtype=torch.int32)
        tables, n_tiles = dense_tables(pos, nt, tps, base)
    tile_base = torch.full((B,), base, device=DEV, dtype=torch.int32)
    return [q4, kc, vc, cc, tables, n_tiles, pos, kn, vn, c_new,
            tile_base], tps


def check_rows(dtype, mode, front_out, timer=None):
    """decode_attention_rows (bf16/f32 cache) vs its twin. The kernel rounds
    the unnormalised exp to the cache dtype before PV, the twin the
    normalised probabilities (the TPU kernel vs its oracle): one bf16 step
    apart, 1e-5 in f32."""
    from spt_proto_tpu_torch.ops import decode_attention as m
    args, tps = rows_inputs(dtype, mode, front_out, gen(SEED + 5))
    kw = dict(ps=TILE, tps=tps, scale=DH ** -0.5,
              clamp=10.0 if mode == 'sparse' else 0.0)
    ref_args = [a.clone() for a in args]
    got = m.decode_attention_rows(*args, **kw)
    want = m.decode_attention_rows_ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    caches_equal = all(torch.equal(g_, w_) for g_, w_ in zip(got[1:],
                                                             want[1:]))
    t_max = args[4].shape[2]
    require(close(got[0], want[0], dtype) and caches_equal
            and bool(torch.isfinite(got[0]).all()),
            f'decode_attention_rows {mode} {dtype}: o err {err}, appended '
            f'caches equal: {caches_equal}')
    log(f'  decode_attention_rows {mode:10s} (T={t_max}, tps {tps}) '
        f'{str(dtype):14s} o max err {err:.3g} ({tol_str(dtype)}); appended '
        f'caches exact')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.decode_attention_rows(*args, **kw))
        res['plain_ms'] = timer.ms(
            lambda: m.decode_attention_rows_ref(*ref_args, **kw), reps=5)
        q, tables, n_tiles, pos, tb = args[0], args[4], args[5], args[6], \
            args[10]
        tokens = covered_tokens(tables, n_tiles, pos, tb, tps, HEADS)
        moved = tokens * 2 * DH * q.element_size()          # K and V
        io = nbytes(q, *args[4:11], got[0])
        ops = tokens * 2 * 2 * DH
        res['bound_ms'], res['bound_by'] = bound_ms(moved + io, ops, dtype)
        # no one PyTorch call computes a tile-table gather + in-place
        # append + attention over this token-minor layout
        res['library_ms'] = None
        log_times(res)
    return res


def check_ffn(dtype, d, f, timer=None, int8=False):
    """ffn_tail (or, int8=True, ffn_tail_int8 over int8 weights) vs its twin
    at (B, d, d_ff); the engine's unfused torch sequence (over dequantized
    weights for int8) is timed beside it for reference (no single PyTorch
    call computes the function)."""
    from spt_proto_tpu_torch.ops import ffn_tail as m
    g = gen(SEED + (9 if int8 else 6))
    x, res_ = randn(g, (B, d), dtype), randn(g, (B, d), dtype)
    if int8:
        w1, w2 = int8_weight(g, d, f, dtype), int8_weight(g, f, d, dtype)
        fn, ref, name = m.ffn_tail_int8, m.ffn_tail_int8_ref, 'ffn_tail_int8'
    else:
        w1 = randn(g, (d, f), dtype, std=d ** -0.5)
        w2 = randn(g, (f, d), dtype, std=f ** -0.5)
        fn, ref, name = m.ffn_tail, m.ffn_tail_ref, 'ffn_tail'
    b1 = randn(g, (f,), dtype, std=0.1)
    b2 = randn(g, (d,), dtype, std=0.1)
    args = [x, res_, w1, b1, w2, b2]
    got = fn(*args)
    want = ref(*args)
    sync()
    err = max_err(got, want)
    require(close(got, want, dtype) and bool(torch.isfinite(got).all()),
            f'{name} d={d} f={f} {dtype}: err {err}')
    log(f'  {name} d={d} f={f} {str(dtype):14s} max err {err:.3g} '
        f'({tol_str(dtype)})')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: fn(*args))
        res['plain_ms'] = timer.ms(lambda: ref(*args))
        w1f, w2f = (dequant(w1, dtype), dequant(w2, dtype)) if int8 \
            else (w1, w2)
        res['unfused_ms'] = timer.ms(
            lambda: res_ + (torch.relu(x @ w1f + b1) @ w2f + b2))
        del w1f, w2f
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(*args, got), 2 * 2 * B * d * f, dtype)
        res['library_ms'] = None
        log_times(res)
    return res


def chosen_logit_gap(logits, ids, dtype):
    """How far below the maximum the chosen logit lies, per row, and the
    bound it is held to: exact expected, but where a kernel's f32 sum rounds
    a logit to the other side of a serving-dtype step a tie can resolve
    differently, so the chosen logit must lie within one step of the
    maximum. Returns (gap, bound, relative step)."""
    gap = (logits.max(-1).values
           - logits.gather(1, ids.long()[:, None])[:, 0]).abs()
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    return gap, logits.abs().max(-1).values * rel, rel


def check_lm_head(dtype, timer=None):
    from spt_proto_tpu_torch.ops import lm_head as m
    g = gen(SEED + 3)
    x = randn(g, (B, D), dtype)
    w = randn(g, (D, VOCAB), dtype, std=D ** -0.5)
    got = m.lm_head_argmax(x, w)
    want = m.lm_head_argmax_ref(x, w)
    sync()
    logits = (x.float() @ w.float()).to(dtype).float()
    gap, step, rel = chosen_logit_gap(logits, got, dtype)
    err = gap.max().item()
    require(bool((gap <= step).all()) and got.dtype == torch.int32,
            f'lm_head_argmax {dtype}: ids {got.tolist()} vs {want.tolist()}')
    log(f'  lm_head_argmax {str(dtype):13s} ids equal: '
        f'{torch.equal(got, want)}; chosen-logit gap {err:.3g} (tol '
        f'{rel:g}|max logit|)')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.lm_head_argmax(x, w))
        res['plain_ms'] = timer.ms(lambda: m.lm_head_argmax_ref(x, w))
        res['library_ms'] = timer.ms(lambda: torch.argmax(x @ w, -1))
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(x, w, got), 2 * B * D * VOCAB, dtype)
        log_times(res)
    return res


def check_int8_matmul(dtype, m, k, n, timer=None):
    """int8_matmul vs its twin: x [m, k] @ an int8 [k, n] weight. m = 8 is
    the decode regime (the skinny weight-stream kernel), m = 16,384 prefill
    (the tiled mma.sync kernel)."""
    from spt_proto_tpu_torch.ops import int8_matmul as mm
    g = gen(SEED + 7)
    wq = int8_weight(g, k, n, dtype)
    x = randn(g, (m, k), dtype)
    got = mm.int8_matmul(x, wq['q'], wq['scale'])
    want = mm.int8_matmul_ref(x, wq['q'], wq['scale'])
    sync()
    err = max_err(got, want)
    require(close(got, want, dtype) and bool(torch.isfinite(got).all()),
            f'int8_matmul m={m} k={k} n={n} {dtype}: err {err}')
    log(f'  int8_matmul m={m} k={k} n={n} {str(dtype):14s} max err '
        f'{err:.3g} ({tol_str(dtype)})')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: mm.int8_matmul(x, wq['q'], wq['scale']))
        res['plain_ms'] = timer.ms(
            lambda: mm.int8_matmul_ref(x, wq['q'], wq['scale']), reps=5)
        w_dq = dequant(wq, dtype)
        res['library_ms'] = timer.ms(lambda: x @ w_dq)
        del w_dq
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(x, wq, got), 2 * m * k * n, torch.bfloat16)
        log_times(res)
    return res


def check_lm_head_int8(dtype, d, timer=None):
    """lm_head_argmax_int8 vs its twin over the int8 head [d, 50432] with
    the true vocab 50272."""
    from spt_proto_tpu_torch.ops import lm_head as m
    g = gen(SEED + 8)
    x = randn(g, (B, d), dtype)
    wq = int8_weight(g, d, VOCAB, dtype)
    got = m.lm_head_argmax_int8(x, wq)
    want = m.lm_head_argmax_int8_ref(x, wq)
    sync()
    logits = m.int8_head_logits(x, wq['q'], wq['scale'])
    gap, step, rel = chosen_logit_gap(logits, got, dtype)
    err = gap.max().item()
    require(bool((gap <= step).all()) and got.dtype == torch.int32
            and bool((got < VOCAB).all()),
            f'lm_head_argmax_int8 d={d} {dtype}: ids {got.tolist()} vs '
            f'{want.tolist()}')
    log(f'  lm_head_argmax_int8 d={d} {str(dtype):14s} ids equal: '
        f'{torch.equal(got, want)}; chosen-logit gap {err:.3g} (tol '
        f'{rel:g}|max logit|)')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.lm_head_argmax_int8(x, wq))
        res['plain_ms'] = timer.ms(lambda: m.lm_head_argmax_int8_ref(x, wq),
                                   reps=5)
        w_dq = dequant(wq, dtype)
        res['library_ms'] = timer.ms(lambda: torch.argmax(x @ w_dq, -1))
        del w_dq
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(x, wq['q'][:, :VOCAB], wq['scale'], got),
            2 * B * d * VOCAB, torch.bfloat16)
        log_times(res)
    return res


def sparse_sel(s, n_sel, bh, block_q, g):
    """Selection from random PQ codes, as prefill builds it."""
    from spt_proto_tpu_torch.ops.block_sparse import (pq_tile_scores,
                                                      select_tiles)
    qc = torch.randint(0, N_CODE, (bh, s, N_SUB), generator=g, device=DEV,
                       dtype=torch.int32)
    kc = torch.randint(0, N_CODE, (bh, s, N_SUB), generator=g, device=DEV,
                       dtype=torch.int32)
    ts = pq_tile_scores(qc, kc, n_codewords=N_CODE, block_q=block_q,
                        block_k=128)
    return select_tiles(ts, n_sel, block_ratio=block_q // 128)


def causal_pairs(sel, block_q, block_k=128) -> int:
    """(query row, key column) pairs with col <= row in the selected tiles."""
    n_qt = sel.shape[1]
    r = (torch.arange(n_qt, device=sel.device)[:, None] * block_q
         + torch.arange(block_q, device=sel.device)[None])     # [nq, bq]
    c0 = sel.clamp(min=0).long() * block_k                     # [bh, nq, ns]
    per = (r[None, :, None, :] - c0[..., None] + 1).clamp(0, block_k)
    return int((per * (sel >= 0)[..., None]).sum())


def check_block_sparse(dtype, s, coeff, timer=None):
    from spt_proto_tpu_torch.ops.block_sparse import block_sparse_attention_ref
    from spt_proto_tpu_torch.ops import block_sparse_attention as m
    g = gen(SEED + 4)
    bh, block_q = B * HEADS, 256
    n_sel = max(2, (s // 128) // coeff)
    sel = sparse_sel(s, n_sel, bh, block_q, g)
    q = randn(g, (bh, s, DH), dtype, std=2.0)
    k = randn(g, (bh, s, DH), dtype)
    v = randn(g, (bh, s, DH), dtype)
    kw = dict(block_q=block_q, block_k=128, scale=DH ** -0.5, clamp=10.0)
    got = m.block_sparse_attention(q, k, v, sel, **kw)
    want = block_sparse_attention_ref(q, k, v, sel, **kw)
    sync()
    err = max_err(got, want)
    diag = (torch.arange(sel.shape[1], device=DEV) * 2)[None, :, None]
    off_diag = bool(((sel >= 0) & (sel < diag)).any())
    invalid = bool((sel < 0).any())
    require(close(got, want, dtype) and bool(torch.isfinite(got).all()),
            f'block_sparse_attention {dtype} S={s}: err {err}')
    if n_sel > block_q // 128:      # more tiles than the forced diagonal
        require(off_diag and invalid, f'sel at S={s} lacks off-diagonal or '
                f'-1 entries')
    log(f'  block_sparse S={s} n_sel={n_sel} {str(dtype):14s} max err '
        f'{err:.3g} ({tol_str(dtype)}); off-diagonal tiles {off_diag}, -1 '
        f'entries {invalid}')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.block_sparse_attention(q, k, v, sel,
                                                              **kw))
        res['plain_ms'] = timer.ms(
            lambda: block_sparse_attention_ref(q, k, v, sel, **kw), reps=5)
        # K/V bytes of the tiles some query tile selects, q read, o written
        used = sum(int(torch.unique(sel[i][sel[i] >= 0]).numel())
                   for i in range(bh))
        kv_bytes = used * 128 * DH * 2 * q.element_size()
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(q, sel, got) + kv_bytes,
            4 * DH * causal_pairs(sel, block_q), dtype)
        res['library_ms'] = None
        log_times(res)
    return res


def phase_kernels(timer):
    """Phase 2; returns the bf16 (serving dtype) results by kernel."""
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = timer if dtype == torch.bfloat16 else None
        r_front, front_out = check_front(dtype, t)
        r_front_bf, front_bf = check_front(dtype, t, quantized=False)
        r_attn = check_attention(dtype, front_out, t)
        r_attn_d = check_attention(dtype, None, t, dense=True)
        r_rows = check_rows(dtype, 'dense', None, t)
        r_rows4 = check_rows(dtype, 'dense-tps4', None, t)
        r_rows_s = check_rows(dtype, 'sparse', front_bf, t)
        r_ffn = check_ffn(dtype, D, FF, t)
        r_ffn13 = check_ffn(dtype, D_13B, FF_13B, t)
        r_head = check_lm_head(dtype, t)
        r_bsa = check_block_sparse(dtype, PROMPT, 8, t)
        check_block_sparse(dtype, 2 * PROMPT, 4)
        # int8 weight-only serving (w8)
        r_front8, _ = check_front(dtype, t, packed=True)
        r_front8_bf, _ = check_front(dtype, t, quantized=False, packed=True)
        r_mm = {name: check_int8_matmul(dtype, m_, k_, n_, t)
                for name, (m_, k_, n_) in INT8_MATMUL_SHAPES.items()}
        r_head8 = check_lm_head_int8(dtype, D, t)
        r_head8_13 = check_lm_head_int8(dtype, D_13B, t)
        r_ffn8 = check_ffn(dtype, D, FF, t, int8=True)
        r_ffn8_13 = check_ffn(dtype, D_13B, FF_13B, t, int8=True)
        if t is not None:
            res = dict(
                decode_front=dict(r_front, bf16_kv=r_front_bf,
                                  packed_int8=r_front8,
                                  packed_int8_bf16_kv=r_front8_bf),
                decode_attention_rows_q=dict(r_attn, dense_tps4=r_attn_d),
                lm_head_argmax=r_head, block_sparse_attention=r_bsa,
                decode_attention_rows=dict(r_rows, dense_tps4=r_rows4,
                                           sparse=r_rows_s),
                ffn_tail=dict(r_ffn, opt_1p3b=r_ffn13),
                int8_matmul=dict(r_mm['decode o 125m'], **{
                    k: v for k, v in r_mm.items() if k != 'decode o 125m'}),
                lm_head_argmax_int8=dict(r_head8, opt_1p3b=r_head8_13),
                ffn_tail_int8=dict(r_ffn8, opt_1p3b=r_ffn8_13))
        del front_out, front_bf
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 3, 4 and 5: the main paths through the engine
# ---------------------------------------------------------------------------

def opt_cfg(name, max_length, dtype, dense=False, **kw):
    from spt_proto_tpu_torch.config import opt_config
    return opt_config(name, max_length=max_length, dtype=dtype,
                      param_dtype=dtype,
                      attention='dense' if dense else 'sparse_v2',
                      pq_metric='l2', attn_impl='pallas', **kw)


def dense_params(params):
    """The same weights without the PQ codebook (bench.py's dense model is
    the sparse one before its PQ upgrade)."""
    mha = {k: v for k, v in params['blocks']['mha'].items()
           if k != 'quantizer'}
    return {**params, 'blocks': {**params['blocks'], 'mha': mha}}


def greedy(iw, tokens, max_len, steps, dev, quantized):
    from spt_proto_tpu_torch.inference import engine
    cache = engine.KVCache.create(iw.cfg, tokens.shape[0], max_len,
                                  dtype=iw.cfg.dtype, quantized=quantized,
                                  device=dev)
    logits, cache = engine.prefill(iw, tokens, cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    out = []
    for _ in range(steps):
        tok, cache = engine.decode_step_greedy(iw, tok, cache)
        out.append(tok)
    return logits, torch.stack(out, 1)


def stepwise(iw_cpu, iw_gpu, tokens, max_len, steps, quantized):
    """Greedy decisions of the card from the CPU twins' state: both
    prefill; then before each step the card gets a copy of the twins'
    cache and their token, takes one greedy step through its kernels, and
    the twins take theirs. Returns the prefill logits of both, the twins'
    logits at each decision [B, 1 + steps, V] and the card's choices
    [B, 1 + steps]."""
    from spt_proto_tpu_torch.inference import engine

    def create(dev):
        return engine.KVCache.create(iw_cpu.cfg, tokens.shape[0], max_len,
                                     dtype=iw_cpu.cfg.dtype,
                                     quantized=quantized, device=dev)
    lg_pre, cache = engine.prefill(iw_cpu, tokens, create('cpu'))
    lg_pre_g, _ = engine.prefill(iw_gpu, tokens.to(DEV), create(DEV))
    logits = [lg_pre[:, -1]]
    chosen = [torch.argmax(lg_pre_g[:, -1], -1).to(torch.int32).cpu()]
    tok = torch.argmax(lg_pre[:, -1], -1).to(torch.int32)
    for _ in range(steps):
        card = engine.KVCache(**{
            f: None if getattr(cache, f) is None else getattr(cache, f).to(DEV)
            for f in ('k', 'v', 'codes', 'length', 'k_scale', 'v_scale')})
        t_g, _ = engine.decode_step_greedy(iw_gpu, tok.to(DEV), card)
        lg, cache = engine.decode_step(iw_cpu, tok, cache)
        logits.append(lg)
        chosen.append(t_g.cpu())
        tok = torch.argmax(lg, -1).to(torch.int32)
    return lg_pre, lg_pre_g, torch.stack(logits, 1), torch.stack(chosen, 1)


def phase_parity():
    """f32 OPT-125M at full width: kernels on the card vs twins on the CPU,
    in six decode modes (two with int8 weights, built staged on the card
    from the CPU tree)."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    b, prompt, steps = 2, 512, 8
    max_len = prompt + TILE
    sparse = opt_cfg('125m', max_len, torch.float32)
    params = init_params(sparse, SEED, device='cpu')
    tokens = torch.randint(1, VOCAB, (b, prompt), generator=gen(SEED, 'cpu'))
    dense = opt_cfg('125m', max_len, torch.float32, dense=True)
    modes = [('sparse int8-KV', sparse, params, True, None),
             ('dense f32-KV', dense, dense_params(params), False, None),
             ('sparse f32-KV', sparse, params, False, None),
             ('sparse l1 unfused front int8-KV',
              sparse.replace(pq_metric='l1'), params, True, None),
             ('w8 sparse int8-KV', sparse, params, True, 'int8'),
             ('w8 dense f32-KV', dense, dense_params(params), False, 'int8')]
    out = {}
    for label, cfg, p, quantized, quant in modes:
        iw_cpu = InferenceWeights.from_params(cfg, p, quant=quant)
        iw_gpu = InferenceWeights.from_params(cfg, p, quant=quant, device=DEV)
        t0 = time.perf_counter()
        if quant is None:
            lg_gpu, tok_gpu = greedy(iw_gpu, tokens.to(DEV), max_len, steps,
                                     DEV, quantized)
            lg_cpu, tok_cpu = greedy(iw_cpu, tokens, max_len, steps, 'cpu',
                                     quantized)
            agree = (tok_gpu.cpu() == tok_cpu).float().mean().item()
            lg_err = max_err(lg_gpu.cpu(), lg_cpu)
            res = dict(agreement=agree, logits_max_err=lg_err)
            msg = f'greedy token agreement {agree} over {b}x{steps}'
            ok = agree >= 0.995
        else:
            # int8 weights round every projection's input to bf16: an f32
            # ulp between the card's and the CPU's plain ops (norm sums)
            # becomes a bf16 step of that operand where it sits on a
            # rounding boundary; the logits of one step drift by ~5e-3,
            # and over steps a flipped PQ code selects other tiles, so two
            # free-running greedy runs part. Each card decision is taken
            # from the twins' own state (prefill, then their cache and
            # token before every step) and must agree with theirs, or lie
            # within one bf16 step (2^-7 |max logit|) of their maximum.
            lg_cpu_pre, lg_gpu, lg_cpu, chosen = stepwise(
                iw_cpu, iw_gpu, tokens, max_len, steps, quantized)
            top = lg_cpu.max(-1).values
            gap = top - lg_cpu.gather(2, chosen.long()[..., None])[..., 0]
            tol = 2.0 ** -7 * lg_cpu.abs().max(-1).values
            agree = (torch.argmax(lg_cpu, -1) == chosen).float().mean().item()
            lg_err = max_err(lg_gpu.cpu(), lg_cpu_pre)
            res = dict(agreement=agree, max_gap=gap.max().item(),
                       logits_max_err=lg_err)
            msg = (f'stepwise greedy agreement {agree} over {b}x{steps + 1}, '
                   f'max chosen-logit gap {gap.max().item():.3g} (tol 2^-7 '
                   f'|max logit| >= {tol.min().item():.3g})')
            ok = bool((gap <= tol).all())
            tok_gpu = chosen
        t2 = time.perf_counter()
        log(f'  {label:32s} f32 OPT-125M B={b} prompt {prompt}: prefill '
            f'logits max err {lg_err:.3g}; {msg} ({t2 - t0:.1f} s)')
        require(ok, f'{label}: {msg}: {tok_gpu.tolist()}')
        out[label] = res
        del iw_gpu
    torch.cuda.empty_cache()
    return out


def wrappers():
    from spt_proto_tpu_torch.ops.block_sparse_attention import \
        block_sparse_attention
    from spt_proto_tpu_torch.ops.decode_attention import (
        decode_attention_rows, decode_attention_rows_q)
    from spt_proto_tpu_torch.ops.decode_front import decode_front
    from spt_proto_tpu_torch.ops.ffn_tail import ffn_tail, ffn_tail_int8
    from spt_proto_tpu_torch.ops.int8_matmul import int8_matmul
    from spt_proto_tpu_torch.ops.lm_head import (lm_head_argmax,
                                                 lm_head_argmax_int8)
    return dict(decode_front=decode_front,
                decode_attention_rows_q=decode_attention_rows_q,
                lm_head_argmax=lm_head_argmax,
                block_sparse_attention=block_sparse_attention,
                decode_attention_rows=decode_attention_rows,
                ffn_tail=ffn_tail, int8_matmul=int8_matmul,
                lm_head_argmax_int8=lm_head_argmax_int8,
                ffn_tail_int8=ffn_tail_int8)


def expected_launches(iw, quantized):
    """Launches per prefill and per decode step on each mode's path. With
    int8 weights (w8) every projection outside the fused kernels is one
    int8_matmul: per prefill qkv, o, fc1, fc2 a layer and the lm_head; per
    step o, plus qkv where the front is unfused, plus fc1 and fc2 where the
    FFN tail is (the tail is fused by default for int8 weights)."""
    from spt_proto_tpu_torch.inference.engine import _uses_fused_front
    cfg = iw.cfg
    layers = cfg.n_layers
    sparse = cfg.attention == 'sparse_v2'
    front = _uses_fused_front(cfg, iw.params['blocks']['mha'])
    w8 = iw.quant == 'int8'
    fused_ffn = w8 if cfg.decode_fused_ffn is None else cfg.decode_fused_ffn
    prefill = dict.fromkeys(wrappers(), 0)
    step = dict.fromkeys(wrappers(), 0)
    prefill['block_sparse_attention'] = layers if sparse else 0
    step['decode_front'] = layers if front else 0
    step['decode_attention_rows_q' if quantized
         else 'decode_attention_rows'] = layers
    step['ffn_tail_int8' if w8 else 'ffn_tail'] = layers if fused_ffn else 0
    step['lm_head_argmax_int8' if w8 else 'lm_head_argmax'] = 1
    if w8:
        prefill['int8_matmul'] = 4 * layers + 1
        step['int8_matmul'] = layers * (1 + (0 if front else 1)
                                        + (0 if fused_ffn else 2))
    return prefill, step


def serving_run(label, iw, tokens, max_len, steps, quantized, profile=True):
    """Prefill + `steps` greedy steps: the launch counters are zeroed just
    before the timed run and read after its prefill and after its decode
    loop, and must equal the mode's expected counts exactly."""
    from spt_proto_tpu_torch.inference import engine
    cfg = iw.cfg
    b = tokens.shape[0]
    ws = wrappers()

    def counts():
        return {n: w.launches for n, w in ws.items()}

    def run(n_steps, events=None):
        cache = engine.KVCache.create(cfg, b, max_len, dtype=cfg.dtype,
                                      quantized=quantized, device=DEV)
        if events:
            events[0].record()
        logits, cache = engine.prefill(iw, tokens, cache)
        if events:
            events[1].record()
        at_prefill = counts()
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        out = []
        for _ in range(n_steps):
            tok, cache = engine.decode_step_greedy(iw, tok, cache)
            out.append(tok)
        if events:
            events[2].record()
        return logits, torch.stack(out, 1), cache, at_prefill

    run(2)                                   # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats()
    for w in ws.values():
        w.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    logits, toks, cache, prefill_counts = run(steps, ev)
    sync()
    total = counts()
    decode_counts = {n: total[n] - prefill_counts[n] for n in total}
    per_prefill, per_step = expected_launches(iw, quantized)
    want_decode = {n: c * steps for n, c in per_step.items()}
    require(prefill_counts == per_prefill and decode_counts == want_decode,
            f'{label} launch counts: prefill {prefill_counts} (expected '
            f'{per_prefill}), {steps} decode steps {decode_counts} '
            f'(expected {want_decode})')
    require(bool(torch.isfinite(logits.float()).all()), 'NaN/inf logits')
    require(toks.shape == (b, steps) and bool(((toks >= 0)
                                               & (toks < VOCAB)).all()),
            f'token ids outside the vocabulary: {toks.tolist()}')
    require(cache.length.tolist() == [tokens.shape[1] + steps] * b,
            'cache length')
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = ev[1].elapsed_time(ev[2])
    res = dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
               prefill_tok_s=b * tokens.shape[1] / prefill_ms * 1e3,
               decode_tok_s=b * steps / decode_ms * 1e3,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=total, launches_per_prefill=prefill_counts,
               launches_per_step={n: c / steps
                                  for n, c in decode_counts.items()})
    log(f'  [{label}] launches: prefill {prefill_counts}; {steps} decode '
        f'steps {decode_counts}')
    log(f'  [{label}] prefill {prefill_ms:.2f} ms = '
        f'{res["prefill_tok_s"]:.0f} tok/s; {steps} decode steps '
        f'{decode_ms:.2f} ms = {res["decode_tok_s"]:.0f} tok/s '
        f'({decode_ms / steps:.3f} ms/step); peak memory '
        f'{res["peak_mem_gb"]:.2f} GB')
    if profile:
        cache = engine.KVCache.create(cfg, b, max_len, dtype=cfg.dtype,
                                      quantized=quantized, device=DEV)
        _, cache = engine.prefill(iw, tokens, cache)
        tok = toks[:, -1].contiguous()

        def steps4():
            t = tok
            for _ in range(4):
                t, _ = engine.decode_step_greedy(iw, t, cache)
        res['decode_profile'] = device_profile(f'{label}: 4 decode steps',
                                               steps4)
    return res


def phase_serving():
    """bf16 OPT-125M, B=8, prompt 2048, max_len 2176: bench.py's three
    decode modes, the fused FFN tail on the int8-KV mode, and int8 weights
    (w8) in the sparse int8-KV and dense bf16-KV modes."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    sparse = opt_cfg('125m', MAX_LEN, torch.bfloat16)
    params = init_params(sparse, SEED, device=DEV)
    tokens = torch.randint(1, VOCAB, (B, PROMPT), generator=gen(SEED),
                           device=DEV)
    iw = InferenceWeights.from_params(sparse, params)
    runs = {}
    runs['dense bf16-KV'] = serving_run(
        'dense bf16-KV', InferenceWeights.from_params(
            opt_cfg('125m', MAX_LEN, torch.bfloat16, dense=True),
            dense_params(params)), tokens, MAX_LEN, STEPS, False)
    runs['sparse bf16-KV'] = serving_run('sparse bf16-KV', iw, tokens,
                                         MAX_LEN, STEPS, False)
    runs['sparse int8-KV'] = serving_run('sparse int8-KV', iw, tokens,
                                         MAX_LEN, STEPS, True)
    runs['sparse int8-KV fused FFN tail'] = serving_run(
        'sparse int8-KV fused FFN tail', InferenceWeights.from_params(
            sparse.replace(decode_fused_ffn=True), params), tokens, MAX_LEN,
        STEPS, True)
    runs['sparse int8-KV w8'] = serving_run(
        'sparse int8-KV w8', InferenceWeights.from_params(
            sparse, params, quant='int8'), tokens, MAX_LEN, STEPS, True)
    runs['dense bf16-KV w8'] = serving_run(
        'dense bf16-KV w8', InferenceWeights.from_params(
            opt_cfg('125m', MAX_LEN, torch.bfloat16, dense=True),
            dense_params(params), quant='int8'), tokens, MAX_LEN, STEPS,
        False)
    cache = engine.KVCache.create(sparse, B, MAX_LEN, dtype=sparse.dtype,
                                  quantized=True, device=DEV)
    runs['sparse int8-KV']['prefill_profile'] = device_profile(
        'sparse int8-KV: prefill', lambda: engine.prefill(iw, tokens, cache))
    dense_tps = runs['dense bf16-KV']['decode_tok_s']
    ratios = {k: r['decode_tok_s'] / dense_tps for k, r in runs.items()}
    best = max(runs['sparse int8-KV']['decode_tok_s'],
               runs['sparse bf16-KV']['decode_tok_s'])
    log(f'  decode tok/s over dense bf16-KV: '
        + ', '.join(f'{k} {v:.3f}' for k, v in ratios.items())
        + f"; bench.py's vs_baseline (best sparse / dense) "
          f'{best / dense_tps:.3f}')
    return dict(runs=runs, vs_dense=ratios, vs_baseline=best / dense_tps)


def phase_1p3b():
    """bench.py's OPT-1.3B rung: dense bf16-KV vs sparse int8-KV, and sparse
    int8-KV with int8 weights (w8), B=8, prompt 2048, max_len 2176, 32
    steps, random weights made on the card."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    sparse = opt_cfg('1.3b', MAX_LEN, torch.bfloat16)
    params = init_params(sparse, SEED, device=DEV)
    tokens = torch.randint(1, VOCAB, (B, PROMPT), generator=gen(SEED),
                           device=DEV)
    runs = {}
    runs['dense bf16-KV'] = serving_run(
        '1.3B dense bf16-KV', InferenceWeights.from_params(
            opt_cfg('1.3b', MAX_LEN, torch.bfloat16, dense=True),
            dense_params(params)), tokens, MAX_LEN, STEPS, False,
        profile=False)
    runs['sparse int8-KV'] = serving_run(
        '1.3B sparse int8-KV', InferenceWeights.from_params(sparse, params),
        tokens, MAX_LEN, STEPS, True, profile=False)
    runs['sparse int8-KV w8'] = serving_run(
        '1.3B sparse int8-KV w8', InferenceWeights.from_params(
            sparse, params, quant='int8'), tokens, MAX_LEN, STEPS, True,
        profile=False)
    ratio = runs['sparse int8-KV']['decode_tok_s'] \
        / runs['dense bf16-KV']['decode_tok_s']
    log(f'  1.3B sparse int8-KV / dense bf16-KV decode tok/s {ratio:.3f}')
    log('  1.3B peak memory GB: ' + ', '.join(
        f'{k} {r["peak_mem_gb"]:.2f}' for k, r in runs.items()))
    del params
    torch.cuda.empty_cache()
    return dict(runs=runs, sparse_vs_dense=ratio)


def device_profile(label, fn, top=8):
    """Device busy share of a window and its device time by kernel, from
    torch.profiler (CUPTI) over one call of fn, bracketed by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        fn()
        ev[1].record()
        sync()
    window_us = ev[0].elapsed_time(ev[1]) * 1e3
    by_kernel = {}
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:      # kernels, copies, memsets
            t, n = by_kernel.get(a.key, (0.0, 0))
            by_kernel[a.key] = (t + a.device_time_total, n + a.count)
    busy_us = sum(t for t, _ in by_kernel.values())
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    out = dict(window_us=window_us, device_busy_us=busy_us,
               busy_share=busy_us / window_us if by_kernel else None,
               top=[(k[:90], t, n) for k, (t, n) in rows])
    log(f'  profile {label}: window {window_us:.0f} us, device busy '
        f'{busy_us:.0f} us ({out["busy_share"]})')
    for k, t, n in out['top']:
        log(f'    {t:9.1f} us {n:5d} calls  {k}')
    return out


# ---------------------------------------------------------------------------

# (name, source, TPU kernel it replaces, others it also replaces, the
# phase-4 run whose launch counts the kernel line reports)
KERNELS = [
    ('decode_front', 'spt_proto_tpu_torch/csrc/decode_front.cu',
     'spt_proto_tpu/ops/pallas/decode_front.py:359', [], 'sparse int8-KV'),
    ('decode_attention_rows_q', 'spt_proto_tpu_torch/csrc/decode_attention.cu',
     'spt_proto_tpu/ops/pallas/decode_attention.py:1627',
     ['spt_proto_tpu/ops/pallas/decode_attention.py:1275'], 'sparse int8-KV'),
    ('lm_head_argmax', 'spt_proto_tpu_torch/csrc/lm_head.cu',
     'spt_proto_tpu/ops/pallas/lm_head.py:69', [], 'sparse int8-KV'),
    ('block_sparse_attention',
     'spt_proto_tpu_torch/csrc/block_sparse_attention.cu',
     'spt_proto_tpu/ops/pallas/block_sparse_attention.py:373',
     ['spt_proto_tpu/ops/pallas/block_sparse_attention.py:108'],
     'sparse int8-KV'),
    ('decode_attention_rows', 'spt_proto_tpu_torch/csrc/decode_attention.cu',
     'spt_proto_tpu/ops/pallas/decode_attention.py:883',
     ['spt_proto_tpu/ops/pallas/decode_attention.py:571'], 'dense bf16-KV'),
    ('ffn_tail', 'spt_proto_tpu_torch/csrc/ffn_tail.cu',
     'spt_proto_tpu/ops/pallas/ffn_tail.py:99', [],
     'sparse int8-KV fused FFN tail'),
    ('int8_matmul', 'spt_proto_tpu_torch/csrc/int8_matmul.cu',
     'spt_proto_tpu/ops/pallas/int8_matmul.py:49', [], 'sparse int8-KV w8'),
    ('lm_head_argmax_int8', 'spt_proto_tpu_torch/csrc/lm_head.cu',
     'spt_proto_tpu/ops/pallas/lm_head.py:129', [], 'sparse int8-KV w8'),
    ('ffn_tail_int8', 'spt_proto_tpu_torch/csrc/ffn_tail.cu',
     'spt_proto_tpu/ops/pallas/ffn_tail.py:231', [], 'sparse int8-KV w8'),
]


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from spt_proto_tpu_torch import _build
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32 here
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f'torch {torch.__version__} cuda {torch.version.cuda}; '
        f'{torch.cuda.get_device_name(0)}')

    log('phase 1: build')
    log(f'  kernels built and loaded in {_build.build_timed():.1f} s')

    log('phase 2: kernels vs plain twins')
    res = phase_kernels(Timer())
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 3: f32 slice parity, card kernels vs CPU twins')
    parity = phase_parity()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 4: bf16 serving runs, OPT-125M B=8 prompt 2048')
    serving = phase_serving()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 5: OPT-1.3B rung, B=8 prompt 2048')
    big = phase_1p3b()

    rows = []
    for name, src, replaces, also, run in KERNELS:
        r = res[name]
        sv = serving['runs'][run]
        rows.append(dict(
            name=name, route='cuda', source=src, replaces=replaces,
            also_replaces=also, launches=sv['launches'][name],
            launches_run=run,
            launches_per_step=sv['launches_per_step'][name],
            launches_per_prefill=sv['launches_per_prefill'][name],
            launches_by_run={k: s['launches'][name]
                             for k, s in serving['runs'].items()},
            max_abs_err=r['max_abs_err'], ms=r['ms'], plain_ms=r['plain_ms'],
            bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            library_ms=r['library_ms'],
            **{k: v for k, v in r.items() if isinstance(v, dict)
               or k == 'unfused_ms'}))

    def brief(run):
        return {k: v for k, v in run.items() if not k.startswith('launches')}
    log(json.dumps(dict(
        device=smi, parity=parity,
        serving=dict(serving, runs={k: brief(r)
                                    for k, r in serving['runs'].items()}),
        opt_1p3b=dict(big, runs={k: brief(r) for k, r in big['runs'].items()}),
        seconds=time.perf_counter() - t_start)))
    log(json.dumps({'kernels': rows}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
