#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spt_proto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card's name and power limit (nvidia-smi), build the CUDA
   kernels from spt_proto_tpu_torch/csrc and print the build time;
2. hold each kernel against its plain PyTorch twin on the same CUDA tensors,
   at the serving shapes (OPT-125M, B=8, context 2048) in bf16 and f32, plus
   a block-sparse selection with off-diagonal and -1 entries (S=4096,
   sparse_coeff 4), and time kernel, twin and the one-call library
   equivalent where there is one;
3. slice parity at full width: OPT-125M (random weights from a seed) in f32,
   B=2, prompt 512, 8 greedy steps, on the card through the kernels and on
   the CPU through the plain twins; the greedy tokens must agree;
4. the serving run: OPT-125M in bf16, B=8, prompt 2048, max_len 2176, int8
   KV cache, prefill + 32 greedy steps, with the kernel launch counters read
   around it and prefill / decode tokens per second from CUDA events;
5. print the per-kernel JSON line, then the contract line
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
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
            torch.int8: 1979e12}   # dense bf16 / f32 (no tensor core) / int8
SEED = 0
DEV = 'cuda'
L2_FLUSH_BYTES = 128 << 20          # > the 50 MB L2: launches start cold
SPIN_CYCLES = 10_000_000            # ~5 ms at the H100's clock

# serving shapes (bench.py's decode headline, OPT-125M)
B, PROMPT, MAX_LEN, STEPS = 8, 2048, 2176, 32
D, HEADS, LAYERS, VOCAB = 768, 12, 12, 50272
DH, N_SUB, N_CODE, TILE = 64, 8, 16, 128
NT = -(-MAX_LEN // TILE)                      # 17 tiles per layer
NSEL = min(NT, max(1, NT // 8) + 1)           # sparse_coeff 8 -> 3


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
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


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


def check_front(dtype, timer=None):
    """decode_front vs decode_front_ref at the serving shape (the middle
    layer's slab)."""
    from spt_proto_tpu_torch.ops import decode_front as m
    args = front_inputs(dtype, gen(SEED + 1))
    kw = dict(nt=NT, nsel=NSEL, n_sub=N_SUB, ps=TILE, quantized=True)
    base = LAYERS // 2 * NT
    got = m.decode_front(*args, base, **kw)
    want = m.decode_front_ref(*args, base, **kw)
    sync()
    q_err = max(max_err(g_, w_) for g_, w_ in zip(got[:3], want[:3]))
    # exact expected; the kernel and torch sum the projection in different
    # orders, so a projection one rounding step apart can move a value
    # across an argmin or int8 boundary. Codes and tables: none in f32, at
    # most one flipped entry each in bf16 (a wrong selection on a head
    # shows as more). k8/v8: a few values one int8 step apart.
    sel_flips = max(int((got[i] != want[i]).sum()) for i in (3, 4))
    sel_tol = 0 if dtype == torch.float32 else 1
    kv_flips = max(mismatch(got[i], want[i]) for i in (5, 6))
    kv_tol = 1e-3 if dtype == torch.float32 else 1e-2
    step = max(max_err(got[i], want[i]) for i in (5, 6))
    s_err = max(((got[i] - want[i]).abs() / want[i]).max().item()
                for i in (7, 8))
    qkv_ok = all(close(g_, w_, dtype) for g_, w_ in zip(got[:3], want[:3]))
    require(qkv_ok and sel_flips <= sel_tol and kv_flips <= kv_tol
            and step <= 1
            and s_err <= (1e-5 if dtype == torch.float32 else 1e-2),
            f'decode_front {dtype}: qkv err {q_err}, code/table flips '
            f'{sel_flips} (tol {sel_tol}), k8/v8 mismatch {kv_flips} (tol '
            f'{kv_tol}), int8 step {step}, scale err {s_err}')
    log(f'  decode_front {str(dtype):15s} qkv max err {q_err:.3g} '
        f'({tol_str(dtype)}); code/table entries flipped {sel_flips} '
        f'(tol {sel_tol}); k8/v8 mismatch {kv_flips:.3g} (tol {kv_tol}); '
        f'scale rel err {s_err:.3g}')
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
    return res, got


def attention_inputs(dtype, front_out, g):
    """Caches at the serving shape; tables and the new token from the
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


def check_attention(dtype, front_out, timer=None):
    from spt_proto_tpu_torch.ops import decode_attention as m
    args = attention_inputs(dtype, front_out, gen(SEED + 2))
    kw = dict(ps=TILE, scale=DH ** -0.5, clamp=10.0)
    ref_args = [a.clone() for a in args]
    got = m.decode_attention_rows_q(*args, **kw)
    want = m.decode_attention_rows_q_ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    caches_equal = all(torch.equal(g_, w_) for g_, w_ in zip(got[1:],
                                                             want[1:]))
    require(close(got[0], want[0], dtype) and caches_equal,
            f'decode_attention {dtype}: o err {err}, appended '
            f'caches equal: {caches_equal}')
    log(f'  decode_attention {str(dtype):11s} o max err {err:.3g} '
        f'({tol_str(dtype)}); '
        f'appended caches exact')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.decode_attention_rows_q(*args, **kw))
        res['plain_ms'] = timer.ms(
            lambda: m.decode_attention_rows_q_ref(*ref_args, **kw), reps=5)
        q, tables, n_tiles, pos, tb = args[0], args[6], args[7], args[8], \
            args[14]
        # tokens the tables cover: full tiles below the write tile, the
        # write tile up to the new token (masking as in the kernel)
        wt = (tb + pos // TILE)[:, None, None]
        ok = (tables >= 0) & (torch.arange(tables.shape[2], device=DEV)
                              < n_tiles[:, None, None])
        per = torch.where(tables == wt, (pos % TILE + 1)[:, None, None],
                          torch.where(tables < wt, TILE, 0))
        tokens = int((per * ok).sum())
        moved = tokens * (2 * DH + 2 * 4)           # K, V int8 + 2 scales
        io = nbytes(q, *args[6:15], got[0])
        ops = tokens * 2 * 2 * DH
        res['bound_ms'], res['bound_by'] = bound_ms(moved + io, ops,
                                                    torch.int8)
        res['library_ms'] = None
    return res


def check_lm_head(dtype, timer=None):
    from spt_proto_tpu_torch.ops import lm_head as m
    g = gen(SEED + 3)
    x = randn(g, (B, D), dtype)
    w = randn(g, (D, VOCAB), dtype, std=D ** -0.5)
    got = m.lm_head_argmax(x, w)
    want = m.lm_head_argmax_ref(x, w)
    sync()
    # exact expected; where the kernel's f32 sum rounds a logit to the
    # other side of a serving-dtype step, a tie can resolve differently:
    # the chosen logit must then be within one step of the maximum
    logits = (x.float() @ w.float()).to(dtype).float()
    gap = (logits.max(-1).values
           - logits.gather(1, got.long()[:, None])[:, 0]).abs()
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    step = logits.abs().max(-1).values * rel
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
    return res


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path through the engine
# ---------------------------------------------------------------------------

def opt125m(max_length, dtype):
    from spt_proto_tpu_torch.config import opt_config
    return opt_config('125m', max_length=max_length, dtype=dtype,
                      attention='sparse_v2', pq_metric='l2',
                      attn_impl='pallas')


def greedy(iw, tokens, max_len, steps, dev):
    from spt_proto_tpu_torch.inference import engine
    cache = engine.KVCache.create(iw.cfg, tokens.shape[0], max_len,
                                  dtype=iw.cfg.dtype, quantized=True,
                                  device=dev)
    logits, cache = engine.prefill(iw, tokens, cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    out = []
    for _ in range(steps):
        tok, cache = engine.decode_step_greedy(iw, tok, cache)
        out.append(tok)
    return logits, torch.stack(out, 1)


def phase_parity():
    """f32 OPT-125M at full width: kernels on the card vs twins on the CPU."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    b, prompt, steps = 2, 512, 8
    max_len = prompt + TILE
    cfg = opt125m(max_len, torch.float32)
    params = init_params(cfg, SEED, device='cpu')
    tokens = torch.randint(1, VOCAB, (b, prompt), generator=gen(SEED, 'cpu'))
    iw_cpu = InferenceWeights.from_params(cfg, params)
    iw_gpu = InferenceWeights.from_params(
        cfg, {k: _to(v, DEV) for k, v in params.items()})
    t0 = time.perf_counter()
    lg_gpu, tok_gpu = greedy(iw_gpu, tokens.to(DEV), max_len, steps, DEV)
    sync()
    t1 = time.perf_counter()
    lg_cpu, tok_cpu = greedy(iw_cpu, tokens, max_len, steps, 'cpu')
    t2 = time.perf_counter()
    agree = (tok_gpu.cpu() == tok_cpu).float().mean().item()
    lg_err = max_err(lg_gpu.cpu(), lg_cpu)
    log(f'  f32 OPT-125M B={b} prompt {prompt}: prefill logits max err '
        f'{lg_err:.3g}; greedy token agreement {agree} over {b}x{steps} '
        f'(card {t1 - t0:.1f} s, CPU twins {t2 - t1:.1f} s)')
    require(agree >= 0.995, f'token agreement {agree} < 0.995: '
            f'{tok_gpu.tolist()} vs {tok_cpu.tolist()}')
    return dict(agreement=agree, logits_max_err=lg_err)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def wrappers():
    from spt_proto_tpu_torch.ops.block_sparse_attention import \
        block_sparse_attention
    from spt_proto_tpu_torch.ops.decode_attention import \
        decode_attention_rows_q
    from spt_proto_tpu_torch.ops.decode_front import decode_front
    from spt_proto_tpu_torch.ops.lm_head import lm_head_argmax
    return dict(decode_front=decode_front,
                decode_attention_rows_q=decode_attention_rows_q,
                lm_head_argmax=lm_head_argmax,
                block_sparse_attention=block_sparse_attention)


def phase_serving():
    """bf16 OPT-125M, B=8, prompt 2048, int8 KV: prefill + 32 greedy steps,
    with the kernels' launch counters read around the timed run."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    cfg = opt125m(MAX_LEN, torch.bfloat16)
    iw = InferenceWeights.from_params(cfg, init_params(cfg, SEED, device=DEV))
    tokens = torch.randint(1, VOCAB, (B, PROMPT), generator=gen(SEED),
                           device=DEV)

    ws = wrappers()

    def counts():
        return {n: w.launches for n, w in ws.items()}

    def run(steps, events=None):
        cache = engine.KVCache.create(cfg, B, MAX_LEN, dtype=cfg.dtype,
                                      quantized=True, device=DEV)
        if events:
            events[0].record()
        logits, cache = engine.prefill(iw, tokens, cache)
        if events:
            events[1].record()
        at_prefill = counts()
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        out = []
        for _ in range(steps):
            tok, cache = engine.decode_step_greedy(iw, tok, cache)
            out.append(tok)
        if events:
            events[2].record()
        return logits, torch.stack(out, 1), cache, at_prefill

    run(2)                                   # warm-up
    sync()
    for w in ws.values():
        w.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    logits, toks, cache, prefill_counts = run(STEPS, ev)
    sync()
    total = counts()
    decode_counts = {n: total[n] - prefill_counts[n] for n in total}
    want_prefill = dict(decode_front=0, decode_attention_rows_q=0,
                        lm_head_argmax=0, block_sparse_attention=LAYERS)
    want_decode = dict(decode_front=LAYERS * STEPS,
                       decode_attention_rows_q=LAYERS * STEPS,
                       lm_head_argmax=STEPS, block_sparse_attention=0)
    require(prefill_counts == want_prefill and decode_counts == want_decode,
            f'launch counts: prefill {prefill_counts} (expected '
            f'{want_prefill}), {STEPS} decode steps {decode_counts} '
            f'(expected {want_decode})')
    require(bool(torch.isfinite(logits.float()).all()), 'NaN/inf logits')
    require(toks.shape == (B, STEPS) and bool(((toks >= 0)
                                               & (toks < VOCAB)).all()),
            f'token ids outside the vocabulary: {toks.tolist()}')
    require(cache.length.tolist() == [PROMPT + STEPS] * B, 'cache length')
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = ev[1].elapsed_time(ev[2])
    res = dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
               prefill_tok_s=B * PROMPT / prefill_ms * 1e3,
               decode_tok_s=B * STEPS / decode_ms * 1e3,
               launches=total,
               launches_per_prefill=prefill_counts,
               launches_per_step={n: c / STEPS
                                  for n, c in decode_counts.items()})
    log(f'  launches: prefill {prefill_counts}; {STEPS} decode steps '
        f'{decode_counts}')
    log(f'  prefill {prefill_ms:.2f} ms = {res["prefill_tok_s"]:.0f} tok/s; '
        f'{STEPS} decode steps {decode_ms:.2f} ms = '
        f'{res["decode_tok_s"]:.0f} tok/s '
        f'({decode_ms / STEPS:.3f} ms/step)')

    cache = engine.KVCache.create(cfg, B, MAX_LEN, dtype=cfg.dtype,
                                  quantized=True, device=DEV)
    res['prefill_profile'] = device_profile(
        'prefill', lambda: engine.prefill(iw, tokens, cache))
    tok = toks[:, -1].contiguous()

    def steps4():
        t = tok
        for _ in range(4):
            t, _ = engine.decode_step_greedy(iw, t, cache)
    res['decode_profile'] = device_profile('4 decode steps', steps4)
    return res


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

KERNELS = [
    ('decode_front', 'spt_proto_tpu_torch/csrc/decode_front.cu',
     'spt_proto_tpu/ops/pallas/decode_front.py:359', []),
    ('decode_attention_rows_q', 'spt_proto_tpu_torch/csrc/decode_attention.cu',
     'spt_proto_tpu/ops/pallas/decode_attention.py:1627',
     ['spt_proto_tpu/ops/pallas/decode_attention.py:1275']),
    ('lm_head_argmax', 'spt_proto_tpu_torch/csrc/lm_head.cu',
     'spt_proto_tpu/ops/pallas/lm_head.py:69', []),
    ('block_sparse_attention',
     'spt_proto_tpu_torch/csrc/block_sparse_attention.cu',
     'spt_proto_tpu/ops/pallas/block_sparse_attention.py:373',
     ['spt_proto_tpu/ops/pallas/block_sparse_attention.py:108']),
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
    timer = Timer()
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        main_dtype = dtype == torch.bfloat16
        t = timer if main_dtype else None
        r_front, front_out = check_front(dtype, t)
        r_attn = check_attention(dtype, front_out, t)
        r_head = check_lm_head(dtype, t)
        r_bsa = check_block_sparse(dtype, PROMPT, 8, t)
        check_block_sparse(dtype, 2 * PROMPT, 4)
        if main_dtype:
            res = dict(decode_front=r_front, decode_attention_rows_q=r_attn,
                       lm_head_argmax=r_head, block_sparse_attention=r_bsa)
        del front_out
    torch.cuda.empty_cache()

    log('phase 3: f32 slice parity, card kernels vs CPU twins')
    parity = phase_parity()

    log('phase 4: bf16 serving run, OPT-125M B=8 prompt 2048 int8 KV')
    serving = phase_serving()

    rows = []
    for name, src, replaces, also in KERNELS:
        r = res[name]
        rows.append(dict(
            name=name, route='cuda', source=src, replaces=replaces,
            also_replaces=also, launches=serving['launches'][name],
            launches_per_step=serving['launches_per_step'][name],
            launches_per_prefill=serving['launches_per_prefill'][name],
            max_abs_err=r['max_abs_err'], ms=r['ms'], plain_ms=r['plain_ms'],
            bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            library_ms=r['library_ms']))
    log(json.dumps(dict(
        device=smi, parity=parity,
        serving={k: v for k, v in serving.items() if not
                 k.startswith('launches')},
        seconds=time.perf_counter() - t_start)))
    log(json.dumps({'kernels': rows}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
