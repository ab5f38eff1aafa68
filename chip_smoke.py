#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spt_proto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card's name and power limit (nvidia-smi), build the CUDA
   kernels from spt_proto_tpu_torch/csrc and print the build time;
2. hold each kernel against its plain PyTorch twin on the same CUDA tensors,
   at the serving shapes (OPT-125M, B=8, context 2048) in bf16 and f32: the
   decode front (with and without int8 KV quantization, with the stacked fp
   and the packed int8 QKV weight; and LLaMA's RMSNorm + RoPE forms: the
   stack and packed int8 at LLaMA-7B width, B=4, and the GQA triple and
   triple_int8 at Llama-3-8B width, B=8), decode attention over a bf16/f32
   cache (dense tables at max_len 2176, dense supertiles of 4 at max_len
   2048, sparse tables) and over an int8 cache (sparse tables, and dense
   supertiles of 4 through one table row; and both at Llama-3-8B's G = 4),
   the lm_head argmax (fp, and int8 at OPT-125M and OPT-1.3B widths; both
   at d 4096 over 128,256 and 32,000 tokens), block-sparse prefill
   attention (d_head 64 and 128, at S=2048 and with off-diagonal and -1
   entries at S=4096, sparse_coeff 4), the fused FFN tail (fp and int8) at
   OPT-125M and OPT-1.3B widths, the gated tails (fp and int8) at LLaMA-7B
   and Llama-3-8B widths, m = 4 and 8, and the int8 matmul at the decode
   shapes (o and qkv of OPT-125M and OPT-1.3B; o and k / v of LLaMA) and
   two prefill shapes (m = 16,384: fc1 of OPT-125M, Llama-3-8B's gate),
   and the speculative block verify (OPT-125M and Llama-3-8B, union and
   dense tables at max_len 2304, one block across a tile boundary); time
   kernel, twin and the one-call library equivalent where there is one;
3. slice parity at full width: OPT-125M (random weights from a seed) in f32,
   B=2, prompt 512, 8 greedy steps, on the card through the kernels and on
   the CPU through the plain twins, in six decode modes (sparse int8-KV,
   dense f32-KV, sparse f32-KV, the unfused l1 front over int8 KV, and with
   int8 weights (w8, built staged on the card) sparse int8-KV and dense
   f32-KV), and Llama-3-8B at full width cut to 2 layers and a 32,000-token
   vocabulary in three (sparse int8-KV through the triple front, dense
   f32-KV, and w8 sparse int8-KV through the triple_int8 front and the
   gated int8 tail); the greedy tokens must agree (the w8 modes are held
   stepwise from the twins' state, codes and tables, each decision within
   one bf16 step of theirs); then, for both models, one speculative verify
   block against K sequential decode steps on the card and against the CPU
   twins, and greedy generate_speculative (n-gram, and at OPT-125M the
   model as its own draft) against greedy generate() on the card;
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
6. LLaMA serving at full depth and width in bf16, prompt 2048, max_len
   2176, 32 steps, with exact launch counts, decode ms/step, tokens per
   second, prefill ms and peak memory: Llama-3-8B at B=8 dense bf16-KV,
   sparse int8-KV, sparse int8-KV with the fused gated tail and sparse
   int8-KV w8, then LLaMA-7B sparse int8-KV w8 at B=4 (bench_ladder.py's
   llama-7b rung), each model freed before the next is built; and, while
   Llama-3-8B is loaded, its speculative serving run (as in phase 7);
7. speculative serving in bf16, bench_serving.py's workload (a 16-token
   phrase tiled through a 2048-token prompt, B=8, k=4, 64 new tokens,
   max_len 2304): OPT-125M with n-gram drafts over a bf16 KV cache (the
   verify kernel) and over an int8 one (the plain verify path), OPT-1.3B
   with OPT-125M as its draft; each prints acceptance, verify-step and
   decode-step ms, tok/s by bench_serving's formula, its token agreement
   with greedy generate() and its exact launch counts;
8. print the per-kernel JSON line, then the contract line
   {"ok": true, "device": {...}} last.

It needs the rest of the repository beside it and a CUDA device; without
either it exits non-zero before printing any result.
"""
from __future__ import annotations

import collections
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
# first is the one the kernel line reports (o runs every layer and step).
# LLaMA's are added below its widths.
INT8_MATMUL_SHAPES = {
    'decode o 125m': (B, D, D), 'decode qkv 125m': (B, D, 3 * D),
    'decode o 1.3b': (B, D_13B, D_13B),
    'decode qkv 1.3b': (B, D_13B, 3 * D_13B),
    'prefill fc1 125m': (B * PROMPT, D, FF)}
# LLaMA (llama_config '7b' and '3-8b'): d_model 4096, 32 query heads of
# d_head 128 (16 PQ subspaces, so the code width is 16); d_ff 11008 and
# 14336; Llama-3-8B has 8 kv heads (groups of 4). LLaMA-7B serves at B=4
# (bench_ladder.py's llama-7b rung), Llama-3-8B at B=8.
D_LL, HEADS_LL, DH_LL, N_SUB_LL = 4096, 32, 128, 16
FF_7B, FF_38B, KV_38B, B_7B = 11008, 14336, 8, 4
VOCAB_38B, VOCAB_7B = 128256, 32000
# int8_matmul on LLaMA's w8 paths: per decode step o (Llama-3-8B at B=8,
# LLaMA-7B at B=4); q and k / v where the front is unfused; per prefill
# (m = B x PROMPT) every projection, the widest being the gate and side
INT8_MATMUL_SHAPES.update({
    'decode o llama-3-8b': (B, D_LL, D_LL),
    'decode k/v llama-3-8b': (B, D_LL, KV_38B * DH_LL),
    'decode o llama-7b': (B_7B, D_LL, D_LL),
    'prefill gate llama-3-8b': (B * PROMPT, D_LL, FF_38B)})
# speculative decoding (bench_serving.py's speculative workload): a 16-token
# random phrase tiled through a 2048-token prompt, k = 4 proposals, a verify
# block of K = 5 columns, 64 new tokens, max_len 2304 (18 tiles a layer)
SPEC_K, SPEC_NEW, SPEC_MAX_LEN, SPEC_PERIOD = 4, 64, 2304, 16
KK = SPEC_K + 1
NT_SPEC = SPEC_MAX_LEN // TILE


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

def front_inputs(dtype, g, b=B, d=D, heads=HEADS, kv=HEADS, n_sub=N_SUB,
                 llama=False, triple=False, layers=LAYERS, nt=NT):
    """decode_front inputs at a serving shape, slots at positions
    (nt-1)*TILE + slot: x, norm scale / bias (None for LLaMA), the QKV
    weight (a [3, D, D] stack, or the (wq, wk, wv) triple), the QKV bias
    (None for LLaMA), bd / cbn, the code cache, pos, then cos / sin (None
    for OPT)."""
    dev = DEV
    from spt_proto_tpu_torch.layers.common import rope_cos_sin
    from spt_proto_tpu_torch.ops.decode_front import build_pq_bd
    dh = d // heads
    x = randn(g, (b, d), dtype, dev)
    nsc = (1 + randn(g, (d,), torch.float32, dev, 0.1)).to(dtype)
    nbi = None if llama else randn(g, (d,), dtype, dev, 0.1)
    if triple:
        w = tuple(randn(g, (d, n), dtype, dev, d ** -0.5)
                  for n in (heads * dh, kv * dh, kv * dh))
    else:
        w = randn(g, (3, d, d), dtype, dev, d ** -0.5)
    bq = None if llama else randn(g, (3, d), dtype, dev, 0.1)
    bd, cbn = build_pq_bd(randn(g, (n_sub, N_CODE, dh // n_sub),
                                torch.float32, dev))
    cc = torch.randint(0, N_CODE, (b, kv, layers * nt, n_sub, TILE),
                       generator=g, device=dev, dtype=torch.int32)
    pos = (nt - 1) * TILE + torch.arange(b, device=dev, dtype=torch.int32)
    cos = sin = None
    if llama:
        cos, sin = rope_cos_sin(pos, dh, base=10000.0)
    return [x, nsc, nbi, w, bq, bd, cbn, cc, pos, cos, sin]


# (label, front_inputs geometry) of the LLaMA front checks: LLaMA-7B's MHA
# forms at B=4, Llama-3-8B's GQA triples at B=8
LLAMA_FRONTS = {
    'llama-7b': dict(b=B_7B, d=D_LL, heads=HEADS_LL, kv=HEADS_LL,
                     n_sub=N_SUB_LL, llama=True),
    'llama-3-8b': dict(b=B, d=D_LL, heads=HEADS_LL, kv=KV_38B,
                       n_sub=N_SUB_LL, llama=True, triple=True)}


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


def check_front(dtype, timer=None, quantized=True, packed=False,
                model=None):
    """decode_front vs decode_front_ref at the serving shape (the middle
    layer's slab), with int8 KV quantization (sparse int8-KV decode) or
    without (sparse bf16-KV decode), with the fp weight or the int8 one
    (packed=True: int8 weight-only serving). model None: OPT-125M, the
    stacked QKV (int8: packed); else a LLAMA_FRONTS entry: LLaMA-7B's stack
    (int8: packed) or Llama-3-8B's GQA triple (int8: triple_int8), with
    RMSNorm and RoPE."""
    from spt_proto_tpu_torch.ops import decode_front as m
    from spt_proto_tpu_torch.inference.weights import quantize_int8
    geo = LLAMA_FRONTS[model] if model else {}
    b, n_sub = geo.get('b', B), geo.get('n_sub', N_SUB)
    layers = geo.get('layers', LAYERS)
    args = front_inputs(dtype, gen(SEED + 1), **geo)
    cos_sin = args[9:]
    args = args[:9]
    if packed and isinstance(args[3], tuple):
        args[3] = tuple(quantize_int8(w) for w in args[3])
    elif packed:
        args[3] = quantize_int8(torch.cat(list(args[3]), dim=-1))
    llama = model is not None
    kw = dict(nt=NT, nsel=NSEL, n_sub=n_sub, ps=TILE, quantized=quantized,
              eps=1e-6 if llama else 1e-5, arch='llama' if llama else 'opt')
    base = layers // 2 * NT
    got = m.decode_front(*args, base, *cos_sin, **kw)
    want = m.decode_front_ref(*args, base, *cos_sin, **kw)
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
    form = m.weight_form(args[3])
    label = (f'decode_front {form}{" " + model if model else ""} '
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
    log(f'  {label:45s} {str(dtype):15s} qkv max err {q_err:.3g} '
        f'({tol_str(tdt)}); code/table entries flipped {sel_flips} '
        f'(tol {sel_tol}){kv_msg}')
    res = dict(max_abs_err=q_err)
    if timer is not None:
        x, nsc, nbi, w, bq, bd, cbn, cc, pos = args
        res['ms'] = timer.ms(lambda: m.decode_front(*args, base, *cos_sin,
                                                    **kw))
        res['plain_ms'] = timer.ms(lambda: m.decode_front_ref(
            *args, base, *cos_sin, **kw), reps=5)
        cur = int(pos[0]) // TILE
        n_full = min(cur, NT)
        kv = cc.shape[1]
        slab = b * kv * n_full * n_sub * TILE * 4      # code slab it scans
        w_ts = [w] if not isinstance(w, tuple) else list(w)
        io = nbytes(x, nsc, nbi, *w_ts, bq, bd, cbn, pos, *cos_sin, *got)
        n_q, n_k = got[0].shape[1], got[1].shape[1]
        ops = 2 * b * x.shape[1] * (n_q + 2 * n_k) \
            + 2 * b * (n_q + n_k) * bd.shape[1]        # projection, encode
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


def check_ffn(dtype, d, f, timer=None, int8=False, gated=False, m_rows=B):
    """ffn_tail / ffn_tail_int8, or (gated=True, LLaMA) ffn_tail_gated /
    ffn_tail_gated_int8, vs its twin at (m_rows, d, d_ff); the engine's
    unfused torch sequence (over dequantized weights for int8) is timed
    beside it for reference (no single PyTorch call computes the
    function)."""
    from spt_proto_tpu_torch.ops import ffn_tail as m
    g = gen(SEED + (9 if int8 else 6) + (10 if gated else 0))
    x, res_ = randn(g, (m_rows, d), dtype), randn(g, (m_rows, d), dtype)
    if gated:
        shapes = ((d, f), (d, f), (f, d))
        if int8:
            ws = [int8_weight(g, k, n, dtype) for k, n in shapes]
            fn, ref = m.ffn_tail_gated_int8, m.ffn_tail_gated_int8_ref
        else:
            ws = [randn(g, (k, n), dtype, std=k ** -0.5) for k, n in shapes]
            fn, ref = m.ffn_tail_gated, m.ffn_tail_gated_ref
        args = [x, res_, *ws]
        n_w = 3
    else:
        if int8:
            w1, w2 = int8_weight(g, d, f, dtype), int8_weight(g, f, d, dtype)
            fn, ref = m.ffn_tail_int8, m.ffn_tail_int8_ref
        else:
            w1 = randn(g, (d, f), dtype, std=d ** -0.5)
            w2 = randn(g, (f, d), dtype, std=f ** -0.5)
            fn, ref = m.ffn_tail, m.ffn_tail_ref
        b1 = randn(g, (f,), dtype, std=0.1)
        b2 = randn(g, (d,), dtype, std=0.1)
        args = [x, res_, w1, b1, w2, b2]
        ws = [w1, w2]
        n_w = 2
    name = fn.__name__
    got = fn(*args)
    want = ref(*args)
    sync()
    err = max_err(got, want)
    require(close(got, want, dtype) and bool(torch.isfinite(got).all()),
            f'{name} m={m_rows} d={d} f={f} {dtype}: err {err}')
    log(f'  {name} m={m_rows} d={d} f={f} {str(dtype):14s} max err '
        f'{err:.3g} ({tol_str(dtype)})')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: fn(*args))
        res['plain_ms'] = timer.ms(lambda: ref(*args))
        wf = [dequant(w, dtype) for w in ws] if int8 else ws
        if gated:
            res['unfused_ms'] = timer.ms(lambda: res_ + (
                torch.nn.functional.silu(x @ wf[0]) * (x @ wf[1])) @ wf[2])
        else:
            res['unfused_ms'] = timer.ms(
                lambda: res_ + (torch.relu(x @ wf[0] + b1) @ wf[1] + b2))
        del wf
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(*args, got), n_w * 2 * m_rows * d * f, dtype)
        res['library_ms'] = None
        log_times(res)
    return res


def check_attention_gqa(dtype, int8, dense, timer=None):
    """decode_attention_rows_q (int8 cache) or decode_attention_rows
    (bf16/f32 cache) vs its twin at Llama-3-8B's decode shape: B=8, 8 kv
    heads with G = 4 query rows each, d_head 128, 17 tiles a layer (max_len
    2176), slots at 2048-2055; dense tables (one row, tps 1) or sparse ones
    (per kv head: two random full tiles, then the write tile)."""
    from spt_proto_tpu_torch.ops import decode_attention as m
    g = gen(SEED + 11)
    b, kv, grp, dh, layers = B, KV_38B, HEADS_LL // KV_38B, DH_LL, 4
    n_all, base = layers * NT, layers // 2 * NT
    pos = PROMPT + torch.arange(b, device=DEV, dtype=torch.int32)
    cur = (pos // TILE).long()
    if dense:
        tables, n_tiles = dense_tables(pos, NT, 1, base)
        width = 1
    else:
        full = torch.rand((b, kv, NT), generator=g, device=DEV)
        full = full.masked_fill(torch.arange(NT, device=DEV) >= cur[:, None,
                                                                   None], 2)
        pick = full.argsort(-1)[..., :NSEL - 1]
        tables = torch.cat([pick, cur[:, None, None].expand(b, kv, 1)],
                           -1).to(torch.int32) + base
        n_tiles = torch.full((b,), NSEL, device=DEV, dtype=torch.int32)
        width = N_SUB_LL
    q = randn(g, (b, kv, grp, dh), dtype)
    # a dense cache keeps one zero code column, which the kernels leave be
    cc = torch.randint(0, N_CODE if width > 1 else 1,
                       (b, kv, n_all, width, TILE), generator=g, device=DEV,
                       dtype=torch.int32)
    c_new = torch.randint(0, N_CODE if width > 1 else 1, (b, kv, width),
                          generator=g, device=DEV, dtype=torch.int32)
    tb = torch.full((b,), base, device=DEV, dtype=torch.int32)
    kw = dict(ps=TILE, tps=1, scale=dh ** -0.5, clamp=0.0 if dense else 10.0)
    if int8:
        kc, vc = (torch.randint(-127, 128, (b, kv, n_all, dh, TILE),
                                generator=g, device=DEV, dtype=torch.int8)
                  for _ in range(2))
        kvp = -(-kv // 8) * 8
        ksc, vsc = (torch.rand((b, n_all, kvp, TILE), generator=g,
                               device=DEV) * 0.05 for _ in range(2))
        kn, vn = (torch.randint(-127, 128, (b, kv, dh), generator=g,
                                device=DEV, dtype=torch.int8)
                  for _ in range(2))
        ksn, vsn = (torch.rand((b, kv), generator=g, device=DEV) * 0.05
                    for _ in range(2))
        args = [q, kc, vc, cc, ksc, vsc, tables, n_tiles, pos, kn, vn, c_new,
                ksn, vsn, tb]
        fn, ref = m.decode_attention_rows_q, m.decode_attention_rows_q_ref
        per_token = 2 * dh + 2 * 4                  # K, V int8 + 2 scales
    else:
        kc, vc = (randn(g, (b, kv, n_all, dh, TILE), dtype)
                  for _ in range(2))
        kn, vn = (randn(g, (b, kv, dh), dtype) for _ in range(2))
        args = [q, kc, vc, cc, tables, n_tiles, pos, kn, vn, c_new, tb]
        fn, ref = m.decode_attention_rows, m.decode_attention_rows_ref
        per_token = 2 * dh * q.element_size()
    ref_args = [a.clone() for a in args]
    got = fn(*args, **kw)
    want = ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    caches_equal = all(torch.equal(g_, w_) for g_, w_ in zip(got[1:],
                                                             want[1:]))
    label = (f'{fn.__name__} G={grp} {"dense" if dense else "sparse"} '
             f'(T={tables.shape[2]})')
    require(close(got[0], want[0], dtype) and caches_equal
            and bool(torch.isfinite(got[0]).all()),
            f'{label} {dtype}: o err {err}, appended caches equal: '
            f'{caches_equal}')
    log(f'  {label} {str(dtype):14s} o max err {err:.3g} '
        f'({tol_str(dtype)}); appended caches exact')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: fn(*args, **kw))
        res['plain_ms'] = timer.ms(lambda: ref(*ref_args, **kw), reps=5)
        tokens = covered_tokens(tables, n_tiles, pos, tb, 1, kv)
        new = [kn, vn] + ([ksn, vsn] if int8 else [])
        io = nbytes(q, tables, n_tiles, pos, c_new, tb, got[0], *new)
        res['bound_ms'], res['bound_by'] = bound_ms(
            tokens * per_token + io, tokens * 2 * 2 * dh * grp,
            torch.int8 if int8 else dtype)
        res['library_ms'] = None
        log_times(res)
    return res


def verify_inputs(dtype, model, dense, g):
    """verify_attention_rows inputs at the speculative serving shape: B=8
    slots at positions 2046 + 3 x slot (slot 0's block of K = 5 crosses the
    tile boundary at 2048, so its two write tiles differ; the others repeat
    one), 2 layers of 18 tiles (max_len 2304) with the second addressed.
    Tables and bits come from the engine's own table code over a random
    decode selection per block position (2 full tiles below its own, then
    its own: sparse_coeff 8 at 18 tiles), or dense."""
    from spt_proto_tpu_torch.inference.engine import _Block
    kv, grp, dh, n_sub = ((HEADS, 1, DH, N_SUB) if model == 'opt-125m' else
                          (KV_38B, HEADS_LL // KV_38B, DH_LL, N_SUB_LL))
    b, nt, base = B, NT_SPEC, NT_SPEC
    nsel = min(nt, max(1, nt // 8) + 1)
    pos = PROMPT - 2 + 3 * torch.arange(b, device=DEV, dtype=torch.int32)
    keep = None
    if not dense:
        ar = torch.arange(nt, device=DEV)
        own = (pos.long()[:, None] + torch.arange(KK, device=DEV)) // TILE
        r = torch.rand((b, kv, KK, nt), generator=g, device=DEV)
        r = r.masked_fill(ar >= own[:, None, :, None], 2.0)
        keep = torch.zeros(r.shape, dtype=torch.bool, device=DEV)
        keep.scatter_(-1, r.argsort(-1)[..., :nsel - 1], True)
        keep |= ar == own[:, None, :, None]
    tables, bits = _Block(pos, KK, nt, kv, nsel).tables(keep, base)
    width = 1 if dense else n_sub
    q = randn(g, (b, kv, grp * KK, dh), dtype)
    kc, vc = (randn(g, (b, kv, 2 * nt, dh, TILE), dtype) for _ in range(2))
    cc = torch.randint(0, N_CODE if width > 1 else 1,
                       (b, kv, 2 * nt, width, TILE), generator=g, device=DEV,
                       dtype=torch.int32)
    kn, vn = (randn(g, (b, kv, dh, KK), dtype) for _ in range(2))
    cn = torch.randint(0, N_CODE if width > 1 else 1, (b, kv, width, KK),
                       generator=g, device=DEV, dtype=torch.int32)
    tb = torch.full((b,), base, device=DEV, dtype=torch.int32)
    return [q, kc, vc, cc, tables, bits, pos, kn, vn, cn, tb]


def verify_work(args):
    """(entries read, visible (row, lane) pairs) of one verify launch: an
    entry is read when its tile id is valid and some block position sees
    it; row r (position j = r % K) sees a lane of it when bit j is set and
    the lane's position is <= pos + j."""
    q, tables, bits, pos, tb = args[0], args[4], args[5], args[6], args[10]
    n_all = args[1].shape[2]
    j = torch.arange(q.shape[2], device=q.device) % KK
    valid = (tables >= 0) & (tables < n_all) & (bits != 0)
    seen = ((bits[:, :, None, :] >> j[:, None]) & 1).bool() \
        & valid[:, :, None]                                  # [B,KV,GK,T]
    first = (tables.long() - tb.long()[:, None, None]) * TILE  # [B, KV, T]
    lanes = (pos.long()[:, None, None, None] + j[:, None] - first[:, :, None]
             + 1).clamp(0, TILE)
    return int(valid.sum()), int((lanes * seen).sum())


def check_verify(dtype, model, dense, timer=None):
    """verify_attention_rows vs its twin at the speculative serving shape
    (verify_inputs): OPT-125M (12 heads, d_head 64) or Llama-3-8B (8 kv
    heads of G = 4, d_head 128), union or dense tables. Kernel and twin
    round e at the same place (the TPU kernel's numerics), so the f32 and
    bf16 bounds of the other attention kernels hold; the appended caches
    and codes must be exact."""
    from spt_proto_tpu_torch.ops import decode_attention as m
    g = gen(SEED + 12)
    args = verify_inputs(dtype, model, dense, g)
    kw = dict(ps=TILE, scale=args[0].shape[3] ** -0.5,
              clamp=0.0 if dense else 10.0)
    ref_args = [a.clone() for a in args]
    got = m.verify_attention_rows(*args, **kw)
    want = m.verify_attention_rows_ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    caches_equal = all(torch.equal(g_, w_) for g_, w_ in zip(got[1:],
                                                             want[1:]))
    tables = args[4]
    crosses = bool((tables[:, 0, -2] != tables[:, 0, -1]).any())
    label = (f'verify_attention_rows {model} {"dense" if dense else "union"} '
             f'(GK={args[0].shape[2]}, T={tables.shape[2]})')
    require(close(got[0], want[0], dtype) and caches_equal and crosses
            and bool(torch.isfinite(got[0]).all()),
            f'{label} {dtype}: o err {err}, appended caches equal: '
            f'{caches_equal}, a block across a tile boundary: {crosses}')
    log(f'  {label} {str(dtype):14s} o max err {err:.3g} '
        f'({tol_str(dtype)}); appended caches exact; a block across a tile '
        f'boundary')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.verify_attention_rows(*args, **kw))
        res['plain_ms'] = timer.ms(
            lambda: m.verify_attention_rows_ref(*ref_args, **kw), reps=5)
        q, kn = args[0], args[7]
        entries, pairs = verify_work(args)
        kv_bytes = entries * 2 * kn.shape[2] * TILE * q.element_size()
        new = [args[7], args[8]] + ([args[9]] if args[3].shape[3] > 1 else [])
        io = nbytes(q, *args[4:7], args[10], got[0], *new)
        res['bound_ms'], res['bound_by'] = bound_ms(
            kv_bytes + io, pairs * 2 * 2 * kn.shape[2], dtype)
        # no one PyTorch call does the table gather + append + per-position
        # visibility
        res['library_ms'] = None
        res.update(entries_read=entries, visible_pairs=pairs)
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


def check_lm_head(dtype, timer=None, d=D, vocab=VOCAB):
    """lm_head_argmax vs its twin: x [B, d] @ w [d, vocab] (OPT-125M's head,
    or LLaMA's at d 4096 with the 128,256 or the 32,000 vocabulary)."""
    from spt_proto_tpu_torch.ops import lm_head as m
    g = gen(SEED + 3)
    x = randn(g, (B, d), dtype)
    w = randn(g, (d, vocab), dtype, std=d ** -0.5)
    got = m.lm_head_argmax(x, w)
    want = m.lm_head_argmax_ref(x, w)
    sync()
    logits = (x.float() @ w.float()).to(dtype).float()
    gap, step, rel = chosen_logit_gap(logits, got, dtype)
    err = gap.max().item()
    label = f'lm_head_argmax d={d} V={vocab}'
    require(bool((gap <= step).all()) and got.dtype == torch.int32,
            f'{label} {dtype}: ids {got.tolist()} vs {want.tolist()}')
    log(f'  {label} {str(dtype):14s} ids equal: '
        f'{torch.equal(got, want)}; chosen-logit gap {err:.3g} (tol '
        f'{rel:g}|max logit|)')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.lm_head_argmax(x, w))
        res['plain_ms'] = timer.ms(lambda: m.lm_head_argmax_ref(x, w))
        res['library_ms'] = timer.ms(lambda: torch.argmax(x @ w, -1))
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(x, w, got), 2 * B * d * vocab, dtype)
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


def check_lm_head_int8(dtype, d, timer=None, vocab=VOCAB):
    """lm_head_argmax_int8 vs its twin over the int8 head [d, vocab padded
    to 256] with the true vocab (OPT's 50,272, or LLaMA's 128,256 and
    32,000)."""
    from spt_proto_tpu_torch.ops import lm_head as m
    g = gen(SEED + 8)
    x = randn(g, (B, d), dtype)
    wq = int8_weight(g, d, vocab, dtype)
    got = m.lm_head_argmax_int8(x, wq)
    want = m.lm_head_argmax_int8_ref(x, wq)
    sync()
    logits = m.int8_head_logits(x, wq['q'], wq['scale'])
    gap, step, rel = chosen_logit_gap(logits, got, dtype)
    err = gap.max().item()
    label = f'lm_head_argmax_int8 d={d} V={vocab}'
    require(bool((gap <= step).all()) and got.dtype == torch.int32
            and bool((got < vocab).all()),
            f'{label} {dtype}: ids {got.tolist()} vs {want.tolist()}')
    log(f'  {label} {str(dtype):14s} ids equal: '
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
            nbytes(x, wq['q'][:, :vocab], wq['scale'], got),
            2 * B * d * vocab, torch.bfloat16)
        log_times(res)
    return res


def sparse_sel(s, n_sel, bh, block_q, g, n_sub=N_SUB):
    """Selection from random PQ codes, as prefill builds it."""
    from spt_proto_tpu_torch.ops.block_sparse import (pq_tile_scores,
                                                      select_tiles)
    qc = torch.randint(0, N_CODE, (bh, s, n_sub), generator=g, device=DEV,
                       dtype=torch.int32)
    kc = torch.randint(0, N_CODE, (bh, s, n_sub), generator=g, device=DEV,
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


def check_block_sparse(dtype, s, coeff, timer=None, bh=B * HEADS, dh=DH,
                       n_sub=N_SUB):
    """block_sparse_attention vs its twin over bh (slot, head) rows of s
    tokens and d_head dh (OPT-125M's 64, or LLaMA's 128, a kernel of its
    own), selection from random codes of n_sub subspaces."""
    from spt_proto_tpu_torch.ops.block_sparse import block_sparse_attention_ref
    from spt_proto_tpu_torch.ops import block_sparse_attention as m
    g = gen(SEED + 4)
    block_q = 256
    n_sel = max(2, (s // 128) // coeff)
    sel = sparse_sel(s, n_sel, bh, block_q, g, n_sub)
    q = randn(g, (bh, s, dh), dtype, std=2.0)
    k = randn(g, (bh, s, dh), dtype)
    v = randn(g, (bh, s, dh), dtype)
    kw = dict(block_q=block_q, block_k=128, scale=dh ** -0.5, clamp=10.0)
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
    log(f'  block_sparse S={s} d_head {dh} n_sel={n_sel} {str(dtype):14s} '
        f'max err {err:.3g} ({tol_str(dtype)}); off-diagonal tiles '
        f'{off_diag}, -1 entries {invalid}')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.block_sparse_attention(q, k, v, sel,
                                                              **kw))
        res['plain_ms'] = timer.ms(
            lambda: block_sparse_attention_ref(q, k, v, sel, **kw), reps=5)
        # K/V bytes of the tiles some query tile selects, q read, o written
        used = sum(int(torch.unique(sel[i][sel[i] >= 0]).numel())
                   for i in range(bh))
        kv_bytes = used * 128 * dh * 2 * q.element_size()
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(q, sel, got) + kv_bytes,
            4 * dh * causal_pairs(sel, block_q), dtype)
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
        # LLaMA: the front's RMSNorm + RoPE and GQA forms, the gated tails
        r_fl = {f'{"int8 " if packed else ""}{model} '
                f'{"int8-KV" if quantized else "bf16-KV"}': check_front(
                    dtype, t, quantized=quantized, packed=packed,
                    model=model)[0]
                for model in LLAMA_FRONTS for packed in (False, True)
                for quantized in (True, False)}
        r_gated = {}
        for int8 in (False, True):
            for f, name in ((FF_38B, 'llama-3-8b'), (FF_7B, 'llama-7b')):
                for m_rows in (B, B_7B):
                    r_gated[int8, f'{name} m={m_rows}'] = check_ffn(
                        dtype, D_LL, f, t, int8=int8, gated=True,
                        m_rows=m_rows)
        gated = {n: {k[1]: r for k, r in r_gated.items() if k[0] == int8}
                 for n, int8 in (('ffn_tail_gated', False),
                                 ('ffn_tail_gated_int8', True))}
        # both attention kernels at G = 4 (Llama-3-8B's groups)
        r_gqa = {(int8, dense): check_attention_gqa(dtype, int8, dense, t)
                 for int8 in (True, False) for dense in (False, True)}
        # the lm_head kernels at d 4096 over Llama-3-8B's vocabulary and the
        # 32,000 of LLaMA-7B (and of phase 3's cut), and block-sparse prefill
        # at d_head 128: B=8 x 32 heads at S 2048 (the serving shape), and
        # one slot's 32 heads at S 4096, sparse_coeff 4 (off-diagonal tiles)
        r_head_ll = {f'llama d={D_LL} V={v}': check_lm_head(
            dtype, t, D_LL, v) for v in (VOCAB_38B, VOCAB_7B)}
        r_head8_ll = {f'llama d={D_LL} V={v}': check_lm_head_int8(
            dtype, D_LL, t, v) for v in (VOCAB_38B, VOCAB_7B)}
        r_bsa_ll = check_block_sparse(dtype, PROMPT, 8, t, B * HEADS_LL,
                                      DH_LL, N_SUB_LL)
        check_block_sparse(dtype, 2 * PROMPT, 4, None, HEADS_LL, DH_LL,
                           N_SUB_LL)
        # the speculative block verify (OPT-125M and Llama-3-8B, union and
        # dense tables at max_len 2304)
        r_ver = {f'{model} {"dense" if dense else "union"}': check_verify(
            dtype, model, dense, t) for model in ('opt-125m', 'llama-3-8b')
            for dense in (False, True)}
        if t is not None:
            res = dict(
                decode_front=dict(r_front, bf16_kv=r_front_bf,
                                  packed_int8=r_front8,
                                  packed_int8_bf16_kv=r_front8_bf,
                                  **r_fl),
                decode_attention_rows_q=dict(
                    r_attn, dense_tps4=r_attn_d,
                    gqa_llama_3_8b_sparse=r_gqa[True, False],
                    gqa_llama_3_8b_dense=r_gqa[True, True]),
                lm_head_argmax=dict(r_head, **r_head_ll),
                block_sparse_attention=dict(r_bsa, llama_d_head_128=r_bsa_ll),
                decode_attention_rows=dict(
                    r_rows, dense_tps4=r_rows4, sparse=r_rows_s,
                    gqa_llama_3_8b_sparse=r_gqa[False, False],
                    gqa_llama_3_8b_dense=r_gqa[False, True]),
                ffn_tail=dict(r_ffn, opt_1p3b=r_ffn13),
                int8_matmul=dict(r_mm['decode o 125m'], **{
                    k: v for k, v in r_mm.items() if k != 'decode o 125m'}),
                lm_head_argmax_int8=dict(r_head8, opt_1p3b=r_head8_13,
                                         **r_head8_ll),
                ffn_tail_int8=dict(r_ffn8, opt_1p3b=r_ffn8_13),
                verify_attention_rows=dict(r_ver['opt-125m union'],
                                           **r_ver),
                # the kernel line reports Llama-3-8B at m = 8 (its run)
                **{n: dict(r[f'llama-3-8b m={B}'], **r)
                   for n, r in gated.items()})
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


def llama_cfg(name, max_length, dtype, dense=False, **kw):
    from spt_proto_tpu_torch.config import llama_config
    return llama_config(name, max_length=max_length, dtype=dtype,
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


class SelectionTap:
    """Gives each card decode step the CPU twins' PQ codes and tile tables
    (stepwise w8 parity). Inside `with tap:` the engine's decode_front is
    wrapped. A call on CPU tensors (the twins' step, taken first) runs the
    twin and is recorded, layer by layer. A call on CUDA tensors (the
    card's step from the same state) launches the kernel, is held against
    the record of the same layer, and passes on the twins' new key codes
    and tables in place of its own; its q / k / v / int8 k and v are the
    card's. Where the card's codes or tables differ from the twins', the
    difference must be one the gap between the card's and the twins'
    vectors can make: for z = the twins' k (or a query row), z' = the
    card's and codeword c, the score |c|^2 - 2 z.c moves by at most
    2 |z' - z|_sub |c - c'| between two codewords c, c' of a subspace, so
    a flipped key code c must lie within that of the twins' best code's
    score (+ 1e-4 of the scale for the f32 sums), and a table row may
    differ only where some query row of its group has a code that close
    to its best. Anything else raises."""

    def __init__(self):
        self.rec = collections.deque()
        self.stats = dict(fronts=0, key_codes=0, key_code_flips=0,
                          table_rows=0, table_row_flips=0)

    def __enter__(self):
        from spt_proto_tpu_torch.inference import engine
        self.engine, self.orig = engine, engine.decode_front
        engine.decode_front = self
        return self

    def __exit__(self, *exc):
        self.engine.decode_front = self.orig

    def __call__(self, *args, **kw):
        out = self.orig(*args, **kw)
        if args[0].device.type == 'cpu':
            self.rec.append((args, kw, out))
            return out
        t_args, t_kw, twin = self.rec.popleft()
        self.compare(t_args[5], t_args[6], t_kw['n_sub'], twin,
                     [o.cpu() for o in out[:5]])
        return tuple(out[:3]) + tuple(o.to(DEV) for o in twin[3:5]) \
            + tuple(out[5:])

    def room(self, bd, cbn, n_sub, z_t, z_c, best):
        """[N, n_sub, n_code]: how far each codeword's score (the twins' z)
        lies above the best code's, less what the card's z can move it;
        <= 0 where the card may pick that codeword."""
        bd, cbn = bd.float(), cbn.float().reshape(-1)
        n, n_code = z_t.shape[0], bd.shape[1] // n_sub
        sc = (cbn - 2 * z_t @ bd).reshape(n, n_sub, n_code)
        gap = sc - sc.gather(-1, best.long()[..., None])
        dist = (cbn[:, None] + cbn[None, :] - 2 * bd.T @ bd).clamp(
            min=0).sqrt().reshape(n_sub, n_code, n_sub, n_code).diagonal(
            dim1=0, dim2=2).permute(2, 0, 1)          # [n_sub, code, code]
        d_best = dist[torch.arange(n_sub)[None], best.long()]
        dz = (z_c - z_t).reshape(n, n_sub, -1).norm(dim=-1)
        zn = z_t.reshape(n, n_sub, -1).norm(dim=-1)
        cb = cbn.reshape(n_sub, n_code).max(-1).values
        eps = 1e-4 * (1 + zn * cb.sqrt() + cb)
        return gap - 2 * dz[..., None] * d_best - eps[..., None]

    def compare(self, bd, cbn, n_sub, twin, card):
        q_t, k_t, _, cn_t, tb_t = twin[:5]
        q_c, k_c, _, cn_c, tb_c = card
        b, kv, _ = cn_t.shape
        dh = bd.shape[0]
        n_code = bd.shape[1] // n_sub
        zk_t, zk_c = (z.float().reshape(b * kv, dh) for z in (k_t, k_c))
        best_k = cn_t[..., :n_sub].reshape(b * kv, n_sub)
        got_k = cn_c[..., :n_sub].reshape(b * kv, n_sub)
        room_k = self.room(bd, cbn, n_sub, zk_t, zk_c, best_k)
        flip_k = got_k != best_k
        bad_k = flip_k & (room_k.gather(
            -1, got_k.long().clamp(0, n_code - 1)[..., None])[..., 0] > 0)
        zq_t, zq_c = (z.float().reshape(-1, dh) for z in (q_t, q_c))
        sc_q = (cbn.float().reshape(-1) - 2 * zq_t @ bd.float()).reshape(
            zq_t.shape[0], n_sub, n_code)
        best_q = sc_q.argmin(-1)
        near = (self.room(bd, cbn, n_sub, zq_t, zq_c, best_q) <= 0).sum(-1) > 1
        may_flip = near.reshape(b, kv, -1).any(-1)    # [B, KV]
        flip_row = (tb_c != tb_t).any(-1)
        bad_rows = flip_row & ~may_flip
        pads_equal = torch.equal(cn_c[..., n_sub:], cn_t[..., n_sub:])
        st = self.stats
        st['fronts'] += 1
        st['key_codes'] += flip_k.numel()
        st['key_code_flips'] += int(flip_k.sum())
        st['table_rows'] += flip_row.numel()
        st['table_row_flips'] += int(flip_row.sum())
        require(not bool(bad_k.any()) and not bool(bad_rows.any())
                and pads_equal,
                f'decode_front in the engine: {int(bad_k.sum())} key codes '
                f'and {int(bad_rows.sum())} table rows differ from the '
                f'twins\' where the card\'s k / q cannot explain it (pad '
                f'columns equal: {pads_equal}); tables {tb_c.tolist()} vs '
                f'{tb_t.tolist()}')

    def step_done(self):
        require(not self.rec, f'{len(self.rec)} twin front calls unmatched')


def stepwise(iw_cpu, iw_gpu, tokens, max_len, steps, quantized):
    """Greedy decisions of the card from the CPU twins' state: both
    prefill; then before each step the card gets a copy of the twins'
    cache and their token, the twins take their step, and the card takes
    its greedy step through its kernels with the twins' codes and tables
    (SelectionTap). Returns the prefill logits of both, the twins' logits
    at each decision [B, 1 + steps, V], the card's choices [B, 1 + steps]
    and the tap's counts."""
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
    with SelectionTap() as tap:
        for _ in range(steps):
            card = engine.KVCache(**{
                f: None if getattr(cache, f) is None
                else getattr(cache, f).to(DEV)
                for f in ('k', 'v', 'codes', 'length', 'k_scale',
                          'v_scale')})
            lg, cache = engine.decode_step(iw_cpu, tok, cache)
            t_g, _ = engine.decode_step_greedy(iw_gpu, tok.to(DEV), card)
            tap.step_done()
            logits.append(lg)
            chosen.append(t_g.cpu())
            tok = torch.argmax(lg, -1).to(torch.int32)
    return (lg_pre, lg_pre_g, torch.stack(logits, 1), torch.stack(chosen, 1),
            tap.stats)


PARITY_B, PARITY_PROMPT, PARITY_STEPS = 2, 512, 8
PARITY_MAX_LEN = PARITY_PROMPT + TILE


def phase_parity():
    """f32 OPT-125M at full width: kernels on the card vs twins on the CPU,
    in six decode modes (two with int8 weights, built staged on the card
    from the CPU tree)."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    max_len = PARITY_MAX_LEN
    sparse = opt_cfg('125m', max_len, torch.float32)
    params = init_params(sparse, SEED, device='cpu')
    tokens = torch.randint(1, VOCAB, (PARITY_B, PARITY_PROMPT),
                           generator=gen(SEED, 'cpu'))
    dense = opt_cfg('125m', max_len, torch.float32, dense=True)
    modes = parity_modes('OPT-125M', tokens, [
        ('sparse int8-KV', sparse, params, True, None),
        ('dense f32-KV', dense, dense_params(params), False, None),
        ('sparse f32-KV', sparse, params, False, None),
        ('sparse l1 unfused front int8-KV', sparse.replace(pq_metric='l1'),
         params, True, None),
        ('w8 sparse int8-KV', sparse, params, True, 'int8'),
        ('w8 dense f32-KV', dense, dense_params(params), False, 'int8')])
    verify = verify_parity('OPT-125M', tokens, [
        ('sparse f32-KV', sparse, params, False),
        ('dense f32-KV', dense, dense_params(params), False),
        ('sparse int8-KV', sparse, params, True)])
    spec = speculative_parity('OPT-125M', sparse, params, True)
    return dict(modes=modes, verify=verify, speculative=spec)


def phase_parity_llama():
    """f32 Llama-3-8B at full width (d_model 4096, 32 query heads over 8 kv
    heads, d_ff 14336) cut to 2 layers and a 32,000-token vocabulary (the
    CPU twins' time): sparse int8-KV through the triple front and dense
    f32-KV free-running, and with int8 weights sparse int8-KV (the
    triple_int8 front, the gated int8 tail) stepwise."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    max_len = PARITY_MAX_LEN
    sparse = llama_cfg('3-8b', max_len, torch.float32, n_layers=2,
                       vocab_size=32000)
    params = init_params(sparse, SEED, device='cpu')
    tokens = torch.randint(1, 32000, (PARITY_B, PARITY_PROMPT),
                           generator=gen(SEED, 'cpu'))
    dense = llama_cfg('3-8b', max_len, torch.float32, dense=True,
                      n_layers=2, vocab_size=32000)
    modes = parity_modes('Llama-3-8B 2-layer', tokens, [
        ('sparse int8-KV', sparse, params, True, None),
        ('dense f32-KV', dense, dense_params(params), False, None),
        ('w8 sparse int8-KV', sparse, params, True, 'int8')])
    verify = verify_parity('Llama-3-8B 2-layer', tokens, [
        ('sparse f32-KV', sparse, params, False),
        ('dense f32-KV', dense, dense_params(params), False)])
    spec = speculative_parity('Llama-3-8B 2-layer', sparse, params, False)
    return dict(modes=modes, verify=verify, speculative=spec)


def parity_modes(model, tokens, modes):
    """Each (label, cfg, params, int8 KV, weight quantization) mode at f32:
    the card's kernels against the CPU twins on the same prompts."""
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    b, steps, max_len = PARITY_B, PARITY_STEPS, PARITY_MAX_LEN
    prompt = tokens.shape[1]
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
            # and a PQ code at a near-tie can flip and select other tiles,
            # so two free-running greedy runs part. Each card decision is
            # taken from the twins' own state (prefill, then their cache,
            # token, codes and tables before every step: SelectionTap,
            # which fails on a code or table the drift cannot explain) and
            # must agree with theirs, or lie within one bf16 step (2^-7
            # |max logit|) of their maximum.
            lg_cpu_pre, lg_gpu, lg_cpu, chosen, tap = stepwise(
                iw_cpu, iw_gpu, tokens, max_len, steps, quantized)
            top = lg_cpu.max(-1).values
            gap = top - lg_cpu.gather(2, chosen.long()[..., None])[..., 0]
            tol = 2.0 ** -7 * lg_cpu.abs().max(-1).values
            agree = (torch.argmax(lg_cpu, -1) == chosen).float().mean().item()
            lg_err = max_err(lg_gpu.cpu(), lg_cpu_pre)
            res = dict(agreement=agree, max_gap=gap.max().item(),
                       logits_max_err=lg_err, selection=tap)
            msg = (f'stepwise greedy agreement {agree} over {b}x{steps + 1}, '
                   f'max chosen-logit gap {gap.max().item():.3g} (tol 2^-7 '
                   f'|max logit| >= {tol.min().item():.3g}); card front vs '
                   f'twins: {tap["key_code_flips"]} of {tap["key_codes"]} '
                   f'key codes and {tap["table_row_flips"]} of '
                   f'{tap["table_rows"]} table rows differ, each within '
                   f'the drift')
            ok = bool((gap <= tol).all())
            tok_gpu = chosen
        t2 = time.perf_counter()
        log(f'  {label:32s} f32 {model} B={b} prompt {prompt}: prefill '
            f'logits max err {lg_err:.3g}; {msg} ({t2 - t0:.1f} s)')
        require(ok, f'{label}: {msg}: {tok_gpu.tolist()}')
        out[label] = res
        del iw_gpu
    torch.cuda.empty_cache()
    return out


CACHE_FIELDS = ('k', 'v', 'codes', 'length', 'k_scale', 'v_scale')


def copy_cache(cache, dev):
    """A copy of a KVCache's tensors on `dev`."""
    from spt_proto_tpu_torch.inference import engine
    return engine.KVCache(**{
        f: None if getattr(cache, f) is None
        else getattr(cache, f).to(dev, copy=True) for f in CACHE_FIELDS})


def verify_parity(model, tokens, modes):
    """f32 at full width, B=2, prompt 512, max_len 640, a block of K = 5
    random tokens: (a) on the card, from one prefilled cache, one
    verify_step against K sequential decode_step calls (the kernels of
    each: the verify kernel, or the plain path over an int8 cache, against
    the decode front and decode attention kernels); (b) the card's
    verify_step against the CPU twins', each from its own prefill. Bounds:
    logits within 2e-3 (f32 sums of full-width rows in other orders; the
    JAX tests hold a tiny model to 5e-4 - 1e-3) or 2e-2 over an int8 cache
    (a new column whose projections differ by an ulp can land one int8 step
    away), greedy decisions agreeing at >= 0.995 of the positions; the
    caches of (a): f32 entries to 1e-4, int8 entries within one step in <=
    1e-3 of them, scales to 1e-5 relative, codes flipped in <= 1e-3 of the
    block's code entries (an ulp at an argmin near-tie)."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    b, max_len = PARITY_B, PARITY_MAX_LEN
    out = {}
    for label, cfg, p, quantized in modes:
        block = torch.randint(1, cfg.vocab_size, (b, KK),
                              generator=gen(SEED + 13, 'cpu'))
        iw_cpu = InferenceWeights.from_params(cfg, p)
        iw_gpu = InferenceWeights.from_params(cfg, p, device=DEV)

        def prefilled(iw, dev):
            cache = engine.KVCache.create(cfg, b, max_len, dtype=cfg.dtype,
                                          quantized=quantized, device=dev)
            return engine.prefill(iw, tokens.to(dev), cache)[1]
        t0 = time.perf_counter()
        card = prefilled(iw_gpu, DEV)
        seq_cache = copy_cache(card, DEV)
        seq = []
        for j in range(KK):
            lg, seq_cache = engine.decode_step(iw_gpu, block[:, j].to(DEV),
                                               seq_cache)
            seq.append(lg)
        seq = torch.stack(seq, 1).cpu()
        blk, card = engine.verify_step(iw_gpu, block.to(DEV), card)
        blk = blk.cpu()
        blk_cpu, _ = engine.verify_step(iw_cpu, block,
                                        prefilled(iw_cpu, 'cpu'))
        sync()
        bound = 2e-2 if quantized else 2e-3
        err_seq, err_cpu = max_err(blk, seq), max_err(blk, blk_cpu)
        agree_seq = mismatch(blk.argmax(-1), seq.argmax(-1))
        agree_cpu = mismatch(blk.argmax(-1), blk_cpu.argmax(-1))
        agree_seq, agree_cpu = 1 - agree_seq, 1 - agree_cpu
        cache_msg, cache_ok = [], True
        for f in ('k', 'v'):
            a, c = getattr(card, f), getattr(seq_cache, f)
            if quantized:
                d = (a.int() - c.int()).abs()
                ok = int(d.max()) <= 1 and mismatch(a, c) <= 1e-3
                cache_msg.append(f'{f} int8 steps {int(d.max())} in '
                                 f'{mismatch(a, c):.2g}')
            else:
                ok = max_err(a, c) <= 1e-4
                cache_msg.append(f'{f} err {max_err(a, c):.3g}')
            cache_ok &= ok
        if quantized:
            s_err = max(((getattr(card, f) - getattr(seq_cache, f)).abs()
                         / getattr(seq_cache, f).abs().clamp(min=1e-30)
                         ).max().item() for f in ('k_scale', 'v_scale'))
            cache_ok &= s_err <= 1e-5
            cache_msg.append(f'scales rel err {s_err:.2g}')
        flips = int((card.codes != seq_cache.codes).sum())
        n_new = b * cfg.kv_heads * KK * cfg.n_layers * card.codes.shape[3]
        cache_ok &= flips <= 1e-3 * n_new and torch.equal(card.length,
                                                          seq_cache.length)
        cache_msg.append(f'codes flipped {flips} of {n_new}')
        msg = (f'verify vs {KK} decode steps: logits err {err_seq:.3g}, '
               f'decisions {agree_seq}; card vs CPU twins: logits err '
               f'{err_cpu:.3g}, decisions {agree_cpu} (bound {bound:g}, '
               f'>= 0.995); caches {", ".join(cache_msg)}')
        log(f'  {label:16s} f32 {model} verify K={KK}: {msg} '
            f'({time.perf_counter() - t0:.1f} s)')
        require(err_seq <= bound and err_cpu <= bound and agree_seq >= 0.995
                and agree_cpu >= 0.995 and cache_ok, f'{label}: {msg}')
        out[label] = dict(logits_err_vs_decode=err_seq,
                          logits_err_vs_cpu=err_cpu,
                          agreement_vs_decode=agree_seq,
                          agreement_vs_cpu=agree_cpu, code_flips=flips)
        del iw_gpu, card, seq_cache
    torch.cuda.empty_cache()
    return out


def spec_workload(vocab, b=B, prompt=PROMPT):
    """bench_serving.py's speculative prompts: a 16-token random phrase
    (numpy seed 7), shifted by the row index, tiled through the prompt."""
    import numpy as np
    phrase = np.random.RandomState(7).randint(1, vocab, size=SPEC_PERIOD)
    rows = [np.tile(phrase + i, prompt // SPEC_PERIOD + 1)[:prompt] % vocab
            for i in range(b)]
    return torch.tensor(np.stack(rows), dtype=torch.int64, device=DEV)


SPEC_PARITY_NEW = 16


def speculative_parity(model, cfg, params, self_draft):
    """f32 at full width, B=2, prompt 512 (the speculative workload's
    phrase), max_len 640: greedy generate_speculative (n-gram, and the
    model as its own draft) against greedy generate() on the card, 16 new
    tokens, held to the fp policy (>= 0.995 token agreement)."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.speculative import \
        generate_speculative
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    iw = InferenceWeights.from_params(cfg, params, device=DEV)
    prompts = spec_workload(cfg.vocab_size, PARITY_B, PARITY_PROMPT)
    ref = engine.generate(iw, prompts, SPEC_PARITY_NEW,
                          max_len=PARITY_MAX_LEN)
    out = {}
    for name, draft in (('n-gram', None),) + (
            (('self-draft', iw),) if self_draft else ()):
        got, st = generate_speculative(iw, prompts, SPEC_PARITY_NEW,
                                       draft=draft, k=SPEC_K,
                                       max_len=PARITY_MAX_LEN)
        agree = (got[:, PARITY_PROMPT:] == ref[:, PARITY_PROMPT:]
                 ).float().mean().item()
        log(f'  speculative {name:10s} f32 {model}: token agreement with '
            f'generate() {agree} over {PARITY_B}x{SPEC_PARITY_NEW}, '
            f'acceptance {st["acceptance"]:.3f} in {st["rounds"]} rounds')
        require(got.shape == ref.shape and agree >= 0.995,
                f'speculative {name} {model}: agreement {agree}: '
                f'{got.tolist()} vs {ref.tolist()}')
        out[name] = dict(agreement=agree, **st)
    del iw
    torch.cuda.empty_cache()
    return out


def wrappers():
    from spt_proto_tpu_torch.ops.block_sparse_attention import \
        block_sparse_attention
    from spt_proto_tpu_torch.ops.decode_attention import (
        decode_attention_rows, decode_attention_rows_q, verify_attention_rows)
    from spt_proto_tpu_torch.ops.decode_front import decode_front
    from spt_proto_tpu_torch.ops.ffn_tail import (ffn_tail, ffn_tail_gated,
                                                  ffn_tail_gated_int8,
                                                  ffn_tail_int8)
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
                ffn_tail_int8=ffn_tail_int8, ffn_tail_gated=ffn_tail_gated,
                ffn_tail_gated_int8=ffn_tail_gated_int8,
                verify_attention_rows=verify_attention_rows)


def expected_launches(iw, quantized):
    """Launches per prefill and per decode step on each mode's path. With
    int8 weights (w8) every projection outside the fused kernels is one
    int8_matmul: per prefill the q/k/v projection (one packed kernel for
    MHA, three for GQA), o, the FFN's fc1 and fc2 (LLaMA: gate, side, down)
    a layer and the lm_head; per step o, plus q/k/v where the front is
    unfused, plus the FFN's where the tail is (the tail is fused by default
    for int8 weights)."""
    from spt_proto_tpu_torch.inference.engine import _uses_fused_front
    cfg = iw.cfg
    layers = cfg.n_layers
    sparse = cfg.attention == 'sparse_v2'
    front = _uses_fused_front(cfg, iw.params['blocks']['mha'])
    w8 = iw.quant == 'int8'
    fused_ffn = w8 if cfg.decode_fused_ffn is None else cfg.decode_fused_ffn
    n_qkv = 1 if 'qkv' in iw.params['blocks']['mha'] else 3
    n_ffn = 3 if cfg.ffn_gated else 2
    tail = ('ffn_tail_gated' if cfg.ffn_gated else 'ffn_tail') \
        + ('_int8' if w8 else '')
    prefill = dict.fromkeys(wrappers(), 0)
    step = dict.fromkeys(wrappers(), 0)
    prefill['block_sparse_attention'] = layers if sparse else 0
    step['decode_front'] = layers if front else 0
    step['decode_attention_rows_q' if quantized
         else 'decode_attention_rows'] = layers
    step[tail] = layers if fused_ffn else 0
    step['lm_head_argmax_int8' if w8 else 'lm_head_argmax'] = 1
    if w8:
        prefill['int8_matmul'] = (n_qkv + 1 + n_ffn) * layers + 1
        step['int8_matmul'] = layers * (1 + (0 if front else n_qkv)
                                        + (0 if fused_ffn else n_ffn))
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
                                               & (toks < cfg.vocab_size)
                                               ).all()),
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


def spec_expected(iw, draft, quantized, rounds):
    """Launches of one generate_speculative run: (the prefills', the whole
    run's). The prefill(s) as in expected_launches; per round one
    verify_attention_rows a target layer (none over an int8 cache: its
    plain path) and, with a draft model, K draft decode_steps (their
    per-step kernels but the fused lm_head: decode_step's head is a plain
    matmul for the sampled logits)."""
    prefill, _ = expected_launches(iw, quantized)
    per_round = dict.fromkeys(prefill, 0)
    if draft is not None:
        d_pre, d_step = expected_launches(draft, quantized)
        for n in prefill:
            prefill[n] += d_pre[n]
            per_round[n] = 0 if n.startswith('lm_head') else KK * d_step[n]
    if not quantized:
        per_round['verify_attention_rows'] = iw.cfg.n_layers
    return prefill, {n: prefill[n] + rounds * per_round[n] for n in prefill}


def step_costs(iw, prompts, quantized, steps=16):
    """bench_serving.py's step costs at the workload's batch and context:
    ms per decode_step (+ argmax) and per verify_step of a K-column block
    rolled back by k (+1 token a step), each timed with CUDA events over
    `steps` steps after 2 warm-up steps, from one prefilled cache; and the
    share of the decode steps' greedy decisions at a near-tie."""
    from spt_proto_tpu_torch.inference import engine
    import dataclasses
    cfg = iw.cfg
    cache = engine.KVCache.create(cfg, prompts.shape[0], SPEC_MAX_LEN,
                                  dtype=cfg.dtype, quantized=quantized,
                                  device=DEV)
    logits, cache = engine.prefill(iw, prompts, cache)
    tok0 = torch.argmax(logits[:, -1], -1).to(torch.int32)
    del logits

    gaps = []

    def dec(tok, c):
        lg, c = engine.decode_step(iw, tok, c)
        gaps.append(lg.float().topk(2, -1).values)       # [B, 2]
        return torch.argmax(lg, -1).to(torch.int32), c

    def ver(tok, c):
        blk = tok[:, None].expand(-1, KK).contiguous()
        lg, c = engine.verify_step(iw, blk, c)
        c = dataclasses.replace(c, length=c.length - SPEC_K)
        return torch.argmax(lg[:, -1], -1).to(torch.int32), c

    out = {}
    for name, fn in (('decode', dec), ('verify', ver)):
        c, tok = copy_cache(cache, DEV), tok0
        for _ in range(2):
            tok, c = fn(tok, c)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(steps):
            tok, c = fn(tok, c)
        ev[1].record()
        sync()
        out[name] = ev[0].elapsed_time(ev[1]) / steps
        del c
    # greedy decisions whose two best logits lie within one bf16 step
    # (2^-7 |max logit|): where rounding in another order can pick the other
    top2 = torch.stack(gaps)
    out['near_ties'] = ((top2[..., 0] - top2[..., 1])
                        <= 2.0 ** -7 * top2[..., 0].abs()).float().mean().item()
    return out, cache, tok0


def spec_run(label, iw, prompts, quantized, draft=None, profile=True):
    """One speculative serving run, bench_serving.py's workload: greedy
    generate_speculative (k = 4, 64 new tokens, max_len 2304), the launch
    counters zeroed just before it and read just after, held exactly to
    spec_expected; its wall time (CUDA events); the token agreement with
    greedy generate() on the same prompts; the verify and decode step
    costs; tok/s by bench_serving's formula B (1 + acceptance k) / t_verify
    beside plain decode's B / t_decode; and a profiled window of 4 verify
    steps."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.speculative import \
        generate_speculative
    import dataclasses
    b = prompts.shape[0]
    ws = wrappers()
    kw = dict(draft=draft, k=SPEC_K, max_len=SPEC_MAX_LEN,
              quantized_kv=quantized)
    generate_speculative(iw, prompts, 2, **kw)              # warm-up
    sync()
    for w in ws.values():
        w.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out, st = generate_speculative(iw, prompts, SPEC_NEW, **kw)
    ev[1].record()
    sync()
    counts = {n: w.launches for n, w in ws.items()}
    rounds = st['rounds']
    per_prefill, want = spec_expected(iw, draft, quantized, rounds)
    require(counts == want, f'{label} launch counts {counts} (expected '
            f'{want}, {rounds} rounds)')
    require(out.shape == (b, prompts.shape[1] + SPEC_NEW)
            and bool(((out >= 0) & (out < iw.cfg.vocab_size)).all()),
            f'{label}: tokens {out.shape}')
    wall_ms = ev[0].elapsed_time(ev[1])
    ref = engine.generate(iw, prompts, SPEC_NEW, max_len=SPEC_MAX_LEN,
                          quantized_kv=quantized)
    s0 = prompts.shape[1]
    same = out[:, s0:] == ref[:, s0:]
    agree = same.float().mean().item()
    # each row's first generated token that differs (SPEC_NEW: none)
    first_div = torch.where(same.all(1), SPEC_NEW,
                            (~same).int().argmax(1)).tolist()
    costs, cache, tok0 = step_costs(iw, prompts, quantized)
    acc = st['acceptance']
    res = dict(st, wall_ms=wall_ms, wall_tok_s=b * SPEC_NEW / wall_ms * 1e3,
               agreement_with_generate=agree, near_ties=costs['near_ties'],
               first_divergence=first_div, verify_ms=costs['verify'],
               decode_ms=costs['decode'],
               verify_over_decode=costs['verify'] / costs['decode'],
               spec_tok_s=b * (1 + acc * SPEC_K) / costs['verify'] * 1e3,
               plain_tok_s=b / costs['decode'] * 1e3,
               launches=counts, launches_per_prefill=per_prefill,
               launches_per_step={n: (c - per_prefill[n]) / rounds
                                  for n, c in counts.items()})
    log(f'  [{label}] launches in {rounds} rounds: {counts}')
    log(f'  [{label}] acceptance {acc:.3f} ({st["accepted"]} of '
        f'{st["proposed"]}); verify step {costs["verify"]:.3f} ms, decode '
        f'step {costs["decode"]:.3f} ms (ratio '
        f'{res["verify_over_decode"]:.3f}); B(1 + acc k) / t_verify = '
        f'{res["spec_tok_s"]:.0f} tok/s vs plain decode {res["plain_tok_s"]:.0f}'
        f' tok/s; whole run {wall_ms:.1f} ms = {res["wall_tok_s"]:.0f} tok/s; '
        f'token agreement with generate() {agree:.4f} (rows part at tokens '
        f'{first_div}; {costs["near_ties"]:.3f} of the decode steps\' '
        f'decisions lie at a bf16 near-tie)')
    if profile:
        def steps4():
            c, tok = cache, tok0
            for _ in range(4):
                blk = tok[:, None].expand(-1, KK).contiguous()
                lg, c = engine.verify_step(iw, blk, c)
                c = dataclasses.replace(c, length=c.length - SPEC_K)
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)
        res['verify_profile'] = device_profile(f'{label}: 4 verify steps',
                                               steps4)
    del cache
    torch.cuda.empty_cache()
    return res


def phase_speculative():
    """bf16 speculative serving, bench_serving.py's workload (B=8, prompt
    2048, k = 4, 64 new tokens, max_len 2304): OPT-125M with n-gram drafts
    over a bf16 KV cache (the verify kernel) and over an int8 one (the
    plain verify path), and OPT-1.3B with OPT-125M as the draft model, both
    with random weights from a seed."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    cfg = opt_cfg('125m', SPEC_MAX_LEN, torch.bfloat16)
    small = InferenceWeights.from_params(cfg, init_params(cfg, SEED,
                                                          device=DEV))
    prompts = spec_workload(cfg.vocab_size)
    runs = {}
    runs['spec 125M n-gram bf16-KV'] = spec_run(
        'spec 125M n-gram bf16-KV', small, prompts, False)
    runs['spec 125M n-gram int8-KV'] = spec_run(
        'spec 125M n-gram int8-KV', small, prompts, True, profile=False)
    cfg13 = opt_cfg('1.3b', SPEC_MAX_LEN, torch.bfloat16)
    big = InferenceWeights.from_params(cfg13, init_params(cfg13, SEED,
                                                          device=DEV))
    runs['spec 1.3B draft 125M bf16-KV'] = spec_run(
        'spec 1.3B draft 125M bf16-KV', big, prompts, False, draft=small)
    del big, small
    torch.cuda.empty_cache()
    return dict(runs=runs)


LLAMA_PROMPT, LLAMA_STEPS = 2048, 32


def phase_llama():
    """bf16 LLaMA at full depth and width, prompt 2048, max_len 2176, 32
    steps, random weights made on the card: Llama-3-8B at B=8 dense
    bf16-KV (the baseline), sparse int8-KV, the same with the fused gated
    tail, and sparse int8-KV w8; LLaMA-7B sparse int8-KV w8 at B=4
    (bench_ladder.py's llama-7b rung). Each model is freed before the next
    is built."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    runs = {}

    def run(label, cfg, params, tokens, quantized, quant=None):
        iw = InferenceWeights.from_params(cfg, params, quant=quant)
        runs[label] = serving_run(label, iw, tokens, MAX_LEN, LLAMA_STEPS,
                                  quantized)
        del iw
        torch.cuda.empty_cache()

    sparse = llama_cfg('3-8b', MAX_LEN, torch.bfloat16)
    params = init_params(sparse, SEED, device=DEV)
    tokens = torch.randint(1, sparse.vocab_size, (B, LLAMA_PROMPT),
                           generator=gen(SEED), device=DEV)
    run('3-8B dense bf16-KV', llama_cfg('3-8b', MAX_LEN, torch.bfloat16,
                                        dense=True),
        dense_params(params), tokens, False)
    run('3-8B sparse int8-KV', sparse, params, tokens, True)
    run('3-8B sparse int8-KV fused FFN tail',
        sparse.replace(decode_fused_ffn=True), params, tokens, True)
    run('3-8B sparse int8-KV w8', sparse, params, tokens, True, 'int8')
    # speculative serving while the model is loaded: n-gram drafts over a
    # bf16 KV cache (the device-bound case for the verify / decode ratio)
    iw = InferenceWeights.from_params(sparse, params)
    runs['spec 3-8B n-gram bf16-KV'] = spec_run(
        'spec 3-8B n-gram bf16-KV', iw, spec_workload(sparse.vocab_size),
        False)
    del iw, params
    torch.cuda.empty_cache()
    sparse = llama_cfg('7b', MAX_LEN, torch.bfloat16)
    params = init_params(sparse, SEED, device=DEV)
    tokens = torch.randint(1, sparse.vocab_size, (B_7B, LLAMA_PROMPT),
                           generator=gen(SEED), device=DEV)
    run('7B sparse int8-KV w8 B=4', sparse, params, tokens, True, 'int8')
    del params
    torch.cuda.empty_cache()
    log('  LLaMA decode ms/step: ' + ', '.join(
        f'{k} {r["decode_ms"] / LLAMA_STEPS:.3f}' for k, r in runs.items()
        if not k.startswith('spec')))
    log('  LLaMA peak memory GB: ' + ', '.join(
        f'{k} {r["peak_mem_gb"]:.2f}' for k, r in runs.items()
        if not k.startswith('spec')))
    return dict(runs=runs)


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
# phase-4 or phase-6 run whose launch counts the kernel line reports)
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
    ('ffn_tail_gated', 'spt_proto_tpu_torch/csrc/ffn_tail.cu',
     'spt_proto_tpu/ops/pallas/ffn_tail.py:137', [],
     '3-8B sparse int8-KV fused FFN tail'),
    ('ffn_tail_gated_int8', 'spt_proto_tpu_torch/csrc/ffn_tail.cu',
     'spt_proto_tpu/ops/pallas/ffn_tail.py:278', [],
     '3-8B sparse int8-KV w8'),
    ('verify_attention_rows', 'spt_proto_tpu_torch/csrc/decode_attention.cu',
     'spt_proto_tpu/ops/pallas/decode_attention.py:2002', [],
     'spec 125M n-gram bf16-KV'),
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
    parity_llama = phase_parity_llama()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 4: bf16 serving runs, OPT-125M B=8 prompt 2048')
    serving = phase_serving()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 5: OPT-1.3B rung, B=8 prompt 2048')
    big = phase_1p3b()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 6: bf16 LLaMA serving runs, prompt 2048, full depth')
    llama = phase_llama()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 7: bf16 speculative serving, B=8 prompt 2048, k=4')
    spec = phase_speculative()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    all_runs = {**serving['runs'], **llama['runs'], **spec['runs']}
    rows = []
    for name, src, replaces, also, run in KERNELS:
        r = res[name]
        sv = all_runs[run]
        rows.append(dict(
            name=name, route='cuda', source=src, replaces=replaces,
            also_replaces=also, launches=sv['launches'][name],
            launches_run=run,
            launches_per_step=sv['launches_per_step'][name],
            launches_per_prefill=sv['launches_per_prefill'][name],
            launches_by_run={k: s['launches'][name]
                             for k, s in all_runs.items()},
            max_abs_err=r['max_abs_err'], ms=r['ms'], plain_ms=r['plain_ms'],
            bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            library_ms=r['library_ms'],
            **{k: v for k, v in r.items() if isinstance(v, dict)
               or k == 'unfused_ms'}))

    def brief(run):
        return {k: v for k, v in run.items() if not k.startswith('launches')}
    log(json.dumps(dict(
        device=smi, parity=parity, parity_llama=parity_llama,
        serving=dict(serving, runs={k: brief(r)
                                    for k, r in serving['runs'].items()}),
        opt_1p3b=dict(big, runs={k: brief(r) for k, r in big['runs'].items()}),
        llama=dict(runs={k: brief(r) for k, r in llama['runs'].items()}),
        speculative=dict(runs={k: brief(r) for k, r in spec['runs'].items()}),
        seconds=time.perf_counter() - t_start)))
    log(json.dumps({'kernels': rows}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
