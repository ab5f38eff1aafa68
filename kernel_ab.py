#!/usr/bin/env python3
"""Time the port's OPT decode kernels, or its flash-attention or
int8_matmul_t kernels, or its greedy heads and LLaMA decode steps, or
end-to-end training steps, or its grouped matmuls and the gmm tune step,
or its decode front and int8-KV decode attention with the decode steps
they serve, from several checkouts, in turns, on one CUDA card.

    python3 kernel_ab.py PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --flash PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --int8t PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --head PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --e2e PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --gmm PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --int8 PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --int8-sweep CHECKOUT
    python3 kernel_ab.py --int8-losses CHECKOUT
    python3 kernel_ab.py --front PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --host PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --dense-attn PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --bsa PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --attn-sweep CHECKOUT
    python3 kernel_ab.py --paged PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --verify PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --bsa-bwd PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository; each runs in a
process of its own, which builds that checkout's kernels and times, with
chip_smoke.py's Timer (cold L2, device time, bf16): decode_front (stacked
fp QKV and packed int8 QKV, int8 KV), ffn_tail, ffn_tail_int8 and
lm_head_argmax at OPT-125M serving shapes; or (--flash) the flash forward,
dq and dk/dv at the checkout's chip_smoke.FLASH_SHAPES of S 512 and 2048,
each checked against its twin first (check_flash); or (--int8t)
int8_matmul_t at chip_smoke.INT8_T_SHAPES, each checked first
(check_int8_matmul_t); or (--head) lm_head_argmax and lm_head_argmax_int8
at HEAD_SHAPES (B=8), each checked first (check_lm_head /
check_lm_head_int8) and timed beside argmax(x @ W), also from a clean L2
(clean_timer), then phase 6's decode steps (serving_run, LLAMA_LAYERS
deep, prompt 2048, 32 steps): Llama-3-8B B=8 dense bf16-KV, sparse
int8-KV fp and w8, LLaMA-7B w8 B=4, with ms a step, peak memory and,
from a profiled 4-step window, the head's and decode_front's device time
a step; or (--e2e) with chip_smoke's own runs: cli.profile
at OPT-125M, B=8, S 2048, bf16 (dense forward, dense and lora train
steps) and cli.tune's LLaMA-7B --int8_base step (bf16, B=4, S=512,
--remat, phase 10's run), each with its peak memory and losses; or (--gmm)
the grouped matmuls at OPT-125M's tune shape, each product of
check_gmm / check_tgmm checked against its twin first and timed beside
torch._grouped_mm, from a cold L2 and a clean one (clean_timer), then
phase 10's OPT-125M gmm tune run (bf16, tune
defaults, ffn_impl='gmm') with its step ms, peak memory and the in-situ us
of gmm and tgmm (kernel + reduce) a call; or (--int8) int8_matmul at
chip_smoke.INT8_MATMUL_SHAPES beside x @ w_dq and the four fused FFN tails
at phase 2's check_ffn shapes beside the unfused torch sequence, each
checked against its twin first, from a cold and a clean L2, then phase 6's
Llama-3-8B B=8 and LLaMA-7B B=4 sparse int8-KV w8 serving runs (decode ms
a step, prefill ms, peak memory, and from profiled windows the in-situ us
a call of int8_matmul in the prefill and in the steps and of the gated
int8 tail) and phase 10's LLaMA-7B int8_base tune step (ms, peak memory,
int8_matmul in situ); or (--int8-sweep) the tile, ring and split choices
of the tensor-core int8 and tail kernels at their heaviest decode and
prefill shapes, each variant checked against the twin and timed (cold L2,
and per kernel from the profiler), and the LLaMA-7B int8_base losses with
int8_matmul's plain twin in place of its kernel; or (--int8-losses)
phase 10's LLaMA-7B int8_base run on three synthetic-data seeds, each
with int8_matmul's forward on the wgmma kernel, the CUDA-core kernels and
the plain twin (int8_losses); or (--front) decode_front at its six
form x model shapes (OPT-125M stack and packed int8, LLaMA-7B stack and
packed int8 at B=4, Llama-3-8B triple and triple_int8) and
decode_attention_rows_q at four cases (OPT-125M sparse and dense
supertiles of 4, Llama-3-8B sparse G = 4 and dense T = 17), each checked
against its twin first (check_front / check_attention /
check_attention_gqa) and timed from a cold and a clean L2, the front's
kernels apart from the profiler (cold L2) and the cuBLAS product hn @ [wq
| wk | wv] of the same widths beside them, then phase 6's Llama-3-8B B=8
sparse int8-KV fp and w8 runs and LLaMA-7B w8 B=4, and phase 4's OPT-125M
sparse int8-KV run, with ms a step, busy share, peak memory and both
kernels' in-situ us a call (front); or (--host) the same four decode runs
on the host's clock and the card's (host_steps: the steps after a sync,
step by step; a window behind an unsynced prefill; the device busy time;
the two wrappers' host us a call; cProfile's top functions); or
(--dense-attn) decode_attention_rows at six bf16-KV shapes, cold and clean
L2 beside their bounds and dense SDPA, then the OPT-125M dense and sparse
bf16-KV and Llama-3-8B dense bf16-KV decode runs with the attention in
situ, synced, and the wrapper's host us a call (dense_attn); or (--bsa)
the block-sparse forward at OPT-125M and Llama-3-8B prefill shapes and
the lse training shape beside dense causal SDPA, then both sparse
prefills with the forward in situ and the wrapper's host us a call (bsa);
or (--attn-sweep) the split walk's entries a chunk and the forward's warps
a CTA around their rules' picks, each checked and timed (attn_sweep); or
(--paged) paged_attention at the four serving shapes (OPT-125M and
Llama-3-8B G=4, fp and int8 pages of 64 tokens), each checked against its
twin first, from a cold L2 beside its bound, its kernels alone and the
wrapper's torch ops apart (profiler), then the OPT-125M paged dense
bf16-KV and int8-KV engines and the Llama-3-8B (16 layers) paged dense one
on phase 8's traffic: the kernel's in-situ us a call, device ms an engine
step (profiler) and engine steps timed after a sync (paged); or (--verify)
verify_attention_rows at five speculative shapes (OPT-125M and Llama-3-8B
union and dense tables, K = 30 at G = 4), each checked first, cold L2
beside its bound, the kernel and the wrapper's torch ops apart, then the
n-gram speculative runs (OPT-125M, Llama-3-8B at
16 layers) and phase 8's speculative engine: the kernel in situ, device ms
a verify round, verify steps timed after a sync (verify); or (--bsa-bwd)
the block-sparse backward's dq and dk/dv at four training shapes, each
checked first, cold L2 beside their bounds, dense causal SDPA's backward
and the plain glue (dd, reverse_table), then the bf16 OPT-125M tune steps
at S 512 and 2048 (synced step ms, device ms a step, the kernels in situ)
and, where the checkout has the tensor-core pair, the sweep of its dq key
step and dk/dv chunk height (bsa_bwd).
One JSON
line per checkout. Two versions are compared only within one call, on one
card, in turns.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

MODES = ('--flash', '--int8t', '--head', '--e2e', '--gmm', '--int8',
         '--int8-sweep', '--int8-losses', '--front', '--host',
         '--dense-attn', '--bsa', '--attn-sweep', '--paged', '--verify',
         '--bsa-bwd')
# the greedy heads' timed shapes, B=8: the fp head over Llama-3-8B's and
# LLaMA-7B's vocabularies at d 4096 and at OPT-125M; the int8 head at d
# 4096 (V 128,256), OPT-1.3B and OPT-125M
HEAD_SHAPES = (('lm_head_argmax', 4096, 128256),
               ('lm_head_argmax', 4096, 32000),
               ('lm_head_argmax', 768, 50272),
               ('lm_head_argmax_int8', 4096, 128256),
               ('lm_head_argmax_int8', 2048, 50272),
               ('lm_head_argmax_int8', 768, 50272))


def e2e(cs) -> dict:
    """Phase 11's profile runs and phase 10's LLaMA-7B int8_base tune run
    (the checkout's own chip_smoke functions)."""
    from spt_proto_tpu_torch.config import llama_config
    out = {}
    step = dict.fromkeys(cs.FLASH_KERNELS, 1)
    for name, argv, per_iter in (
            ('profile dense forward', ['--tuning', 'dense'],
             dict.fromkeys(cs.FLASH_KERNELS[:1], 1)),
            ('profile dense step', ['--tuning', 'dense', '--backward'], step),
            ('profile lora step', ['--tuning', 'lora', '--backward'], step)):
        r = cs.profile_run(f'{name} S=2048', argv, per_iter)
        out[f'{name} ms'] = r['step_ms']
        out[f'{name} peak GB'] = r['peak_gb']
    ll = llama_config('7b')
    argv = ['--device', cs.DEV, '--config', 'llama-7b', '--dtype',
            'bfloat16', '--batch_size', str(cs.B_7B), '--lr', '1e-3',
            '--remat', '--int8_base']
    r = cs.train_run('llama-7b int8_base', argv, cs.B_7B, 512, ll.n_layers,
                     cs.train_launches(ll, 'int8_base', remat=True),
                     timed=6, stop_after=True)
    out.update({'int8_base step ms': r['step_ms'],
                'int8_base peak GB': r['peak_mem_gb'],
                'int8_base losses': r['losses'],
                'int8_base kernels in situ us': r['kernel_us_in_situ']})
    return out


def gmm(cs, timer) -> dict:
    """check_gmm / check_tgmm (bf16, timed), then phase 10's OPT-125M gmm
    tune run."""
    import torch
    from spt_proto_tpu_torch.config import opt_config
    bf = torch.bfloat16
    out = {}
    for t, tag in ((timer, ''), (clean_timer(cs), ' clean L2')):
        for name, res in (('gmm', cs.check_gmm(bf, t)),
                          ('tgmm', cs.check_tgmm(bf, t))):
            for case, r in res.items():
                if isinstance(r, dict) and 'ms' in r:
                    out[f'{name} {case}{tag} us'] = r['ms'] * 1e3
                    out[f'{name} {case}{tag} library us'] = (
                        r['library_ms'] * 1e3)
                    out[f'{name} {case} bound us'] = r['bound_ms'] * 1e3
    del t
    torch.cuda.empty_cache()
    argv = ['--device', cs.DEV, '--config', 'opt-125m', '--batch_size',
            str(cs.B), '--dtype', 'bfloat16']
    r = cs.train_run('train 125M gmm bf16 B=8 S=512', argv, cs.B, 512,
                     cs.LAYERS, cs.train_launches(opt_config('125m'), 'gmm'),
                     cfg_patch=lambda c: c.replace(ffn_impl='gmm'))
    out.update({'gmm tune step ms': r['step_ms'],
                'gmm tune peak GB': r['peak_mem_gb'],
                'gmm tune busy': r['busy_share'],
                'gmm tune losses': r['losses'],
                'gmm tune kernels in situ us': {
                    k: r['kernel_us_in_situ'][k] for k in ('gmm', 'tgmm')},
                'gmm tune by kernel in situ': {
                    k: r.get('kernel_names_in_situ', {}).get(k)
                    for k in ('gmm', 'tgmm')}})
    return out


class CleanFlush:
    """A Timer flush that rewrites its 128 MB (which leaves the L2 full of
    dirty lines that the timed call would write back) and then reads
    another 128 MB, so that the call finds a cold and clean L2."""

    def __init__(self, flush, other):
        self.flush, self.other = flush, other

    def zero_(self):
        self.flush.zero_()
        self.other.sum()


def clean_timer(cs):
    """chip_smoke's Timer with a CleanFlush."""
    import torch
    t = cs.Timer()
    t.flush = CleanFlush(t.flush, torch.ones(cs.L2_FLUSH_BYTES // 4,
                                             device=cs.DEV))
    return t


def head(cs, timer) -> dict:
    """The heads at HEAD_SHAPES, then phase 6's decode steps."""
    import torch
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    bf = torch.bfloat16
    out = {}
    for t, tag in ((timer, ''), (clean_timer(cs), ' clean L2')):
        for name, d, v in HEAD_SHAPES:
            r = (cs.check_lm_head_int8(bf, d, t, v) if name.endswith('int8')
                 else cs.check_lm_head(bf, t, d, v))
            out[f'{name} d={d} V={v}{tag} us'] = r['ms'] * 1e3
            out[f'{name} d={d} V={v}{tag} library us'] = r['library_ms'] * 1e3
    del t
    torch.cuda.empty_cache()

    def per_step(prof, key):
        return sum(t for k, (t, _) in prof['by_kernel'].items()
                   if key in k) / 4

    for model, b, runs in (
            ('3-8b', cs.B, (('dense bf16-KV', True, False, None),
                            ('sparse int8-KV', False, True, None),
                            ('sparse int8-KV w8', False, True, 'int8'))),
            ('7b', cs.B_7B, (('sparse int8-KV w8', False, True, 'int8'),))):
        cfg = cs.llama_cfg(model, cs.MAX_LEN, bf, n_layers=cs.LLAMA_LAYERS)
        params = init_params(cfg, cs.SEED, device=cs.DEV)
        tokens = torch.randint(1, cfg.vocab_size, (b, cs.LLAMA_PROMPT),
                               generator=cs.gen(cs.SEED), device=cs.DEV)
        for mode, dense, quantized, quant in runs:
            label = f'{model} B={b} {mode}'
            iw = InferenceWeights.from_params(
                cs.llama_cfg(model, cs.MAX_LEN, bf, dense=True,
                             n_layers=cs.LLAMA_LAYERS) if dense else cfg,
                cs.dense_params(params) if dense else params, quant=quant)
            r = cs.serving_run(label, iw, tokens, cs.MAX_LEN, cs.LLAMA_STEPS,
                               quantized)
            prof = r['decode_profile']
            out[f'{label} ms/step'] = r['decode_ms'] / cs.LLAMA_STEPS
            out[f'{label} peak GB'] = r['peak_mem_gb']
            out[f'{label} head us/step'] = per_step(prof, 'lm_head')
            out[f'{label} head reduce us/step'] = per_step(prof,
                                                           'lm_head_reduce')
            out[f'{label} decode_front us/step'] = per_step(prof,
                                                            'decode_front')
            out[f'{label} busy'] = prof['busy_share']
            del iw
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    return out


def int8_kernels(cs, timer) -> dict:
    """int8_matmul and the four fused FFN tails, cold and clean L2."""
    import torch
    bf = torch.bfloat16
    # (form, d, d_ff, gated, int8, m): phase 2's check_ffn shapes
    tails = [(n, d, f, False, int8, cs.B)
             for n, d, f in (('opt-125m', cs.D, cs.FF),
                             ('opt-1.3b', cs.D_13B, cs.FF_13B))
             for int8 in (False, True)]
    tails += [(n, cs.D_LL, f, True, int8, m)
              for n, f in (('llama-3-8b', cs.FF_38B), ('llama-7b', cs.FF_7B))
              for int8 in (False, True) for m in (cs.B, cs.B_7B)]
    out = {}
    for t, tag in ((timer, ''), (clean_timer(cs), ' clean L2')):
        for name, (m, k, n) in cs.INT8_MATMUL_SHAPES.items():
            r = cs.check_int8_matmul(bf, m, k, n, t)
            out[f'int8_matmul {name}{tag} us'] = r['ms'] * 1e3
            out[f'int8_matmul {name}{tag} library us'] = r['library_ms'] * 1e3
            out[f'int8_matmul {name} bound us'] = r['bound_ms'] * 1e3
        for name, d, f, gated, int8, m in tails:
            r = cs.check_ffn(bf, d, f, t, int8=int8, gated=gated, m_rows=m)
            key = (f'{"gated " if gated else ""}tail{" int8" if int8 else ""}'
                   f' {name} m={m}')
            out[f'{key}{tag} us'] = r['ms'] * 1e3
            out[f'{key}{tag} unfused us'] = r['unfused_ms'] * 1e3
            out[f'{key} bound us'] = r['bound_ms'] * 1e3
    del t
    torch.cuda.empty_cache()
    return out


def in_situ(by_kernel, names, call_names) -> float | None:
    """Device us a call of the kernels matching `names` in a profile's
    by_kernel, calls counted on those matching `call_names`."""
    t = sum(v for k, (v, _) in by_kernel.items()
            if any(n in k for n in names))
    calls = sum(c for k, (_, c) in by_kernel.items()
                if any(n in k for n in call_names))
    return t / calls if calls else None


# kernel names of int8_matmul and of the fused tails in either checkout
# (the CUDA-core kernels before, the tensor-core ones after), and the
# kernels whose count is the number of calls
INT8_NAMES = (('int8_matmul_skinny', 'int8_matmul_tiled', 'int8_matmul_wgmma',
               'int8_matmul_stream', 'int8_matmul_reduce'),
              ('int8_matmul_skinny', 'int8_matmul_tiled', 'int8_matmul_wgmma',
               'int8_matmul_stream'))
TAIL_NAMES = (('ffn_partial', 'ffn_up', 'ffn_act', 'ffn_down', 'ffn_reduce'),
              ('ffn_partial', 'ffn_up'))


def int8_runs(cs) -> dict:
    """Phase 6's w8 serving runs and phase 10's int8_base tune step."""
    import torch
    from spt_proto_tpu_torch.config import llama_config
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    bf = torch.bfloat16
    out = {}
    for model, b in (('3-8b', cs.B), ('7b', cs.B_7B)):
        cfg = cs.llama_cfg(model, cs.MAX_LEN, bf, n_layers=cs.LLAMA_LAYERS)
        params = init_params(cfg, cs.SEED, device=cs.DEV)
        tokens = torch.randint(1, cfg.vocab_size, (b, cs.LLAMA_PROMPT),
                               generator=cs.gen(cs.SEED), device=cs.DEV)
        iw = InferenceWeights.from_params(cfg, params, quant='int8')
        del params
        label = f'{model} B={b} sparse int8-KV w8'
        r = cs.serving_run(label, iw, tokens, cs.MAX_LEN, cs.LLAMA_STEPS,
                           True)
        prof = r['decode_profile']['by_kernel']
        out[f'{label} ms/step'] = r['decode_ms'] / cs.LLAMA_STEPS
        out[f'{label} prefill ms'] = r['prefill_ms']
        out[f'{label} peak GB'] = r['peak_mem_gb']
        out[f'{label} busy'] = r['decode_profile']['busy_share']
        out[f'{label} int8_matmul step us a call'] = in_situ(prof,
                                                             *INT8_NAMES)
        out[f'{label} tail us a call'] = in_situ(prof, *TAIL_NAMES)

        def prefill():
            cache = engine.KVCache.create(cfg, b, cs.MAX_LEN, dtype=bf,
                                          quantized=True, device=cs.DEV)
            engine.prefill(iw, tokens, cache)
        pp = cs.device_profile(f'{label}: prefill', prefill)['by_kernel']
        out[f'{label} int8_matmul prefill us a call'] = in_situ(pp,
                                                                *INT8_NAMES)
        del iw
        torch.cuda.empty_cache()
    ll = llama_config('7b')
    argv = ['--device', cs.DEV, '--config', 'llama-7b', '--dtype',
            'bfloat16', '--batch_size', str(cs.B_7B), '--lr', '1e-3',
            '--remat', '--int8_base']
    r = cs.train_run('llama-7b int8_base', argv, cs.B_7B, 512, ll.n_layers,
                     cs.train_launches(ll, 'int8_base', remat=True),
                     timed=6, stop_after=True)
    out.update({'int8_base step ms': r['step_ms'],
                'int8_base peak GB': r['peak_mem_gb'],
                'int8_base losses': r['losses'],
                'int8_base int8_matmul us a call': in_situ(
                    {k: (v['us'] * v['calls'], v['calls']) for k, v in
                     r['kernel_names_in_situ']['int8_matmul'].items()},
                    *INT8_NAMES)})
    return out


def by_kernel(cs, fn, reps=10) -> dict:
    """Device us a call of each spt kernel fn launches (the profiler over
    reps calls, each after chip_smoke's L2 flush)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    timer = cs.Timer()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {a.key.split('(')[0].removeprefix('void ').split('<')[0]:
            a.device_time_total / reps for a in prof.key_averages()
            if 'spt::' in a.key}


def int8_sweep(cs, timer) -> dict:
    """The plan choices of int8_matmul (wgmma BN, beside x @ w_dq; the
    stream's K slices) and of the tails (the up product's tile, ring and K
    split, the down product's d_ff split) around the rules' picks, each
    variant checked against its twin, cold-L2 us and per-kernel us; then
    10 int8_base steps (phase 10's run) with int8_matmul's plain twin as
    the forward."""
    import torch
    from spt_proto_tpu_torch.config import llama_config
    from spt_proto_tpu_torch.ops import ffn_tail as ft
    from spt_proto_tpu_torch.ops import int8_matmul as mm
    bf = torch.bfloat16
    out = {}

    def variants(module, name, fn, want, plans):
        rule = getattr(module, name)
        try:
            for tag, plan in plans:
                setattr(module, name, lambda *a, _p=plan, **k: _p)
                got = fn()
                torch.cuda.synchronize()
                ok = cs.close(got, want, bf)
                out[f'{tag} ok'] = ok
                out[f'{tag} us'] = timer.ms(fn) * 1e3
                out[f'{tag} by kernel us'] = by_kernel(cs, fn)
        finally:
            setattr(module, name, rule)

    for m, k, n in ((64, 4096, 4096), (512, 4096, 4096), (1024, 4096, 4096),
                    (2048, 4096, 11008), (16384, 4096, 14336)):
        g = cs.gen(cs.SEED + 7)
        wq = cs.int8_weight(g, k, n, bf)
        x = cs.randn(g, (m, k), bf)
        variants(mm, 'int8_matmul_plan',
                 lambda: mm.int8_matmul(x, wq['q'], wq['scale']),
                 mm.int8_matmul_ref(x, wq['q'], wq['scale']),
                 [(f'wgmma {m}x{k}x{n} bn={bn}', dict(route='wgmma', bn=bn))
                  for bn in (128, 256)])
        w_dq = cs.dequant(wq, bf)
        out[f'wgmma {m}x{k}x{n} library us'] = timer.ms(lambda: x @ w_dq) * 1e3
        del w_dq
    for m, k, n in ((8, 4096, 4096), (8, 2048, 2048), (8, 768, 768)):
        g = cs.gen(cs.SEED + 7)
        wq = cs.int8_weight(g, k, n, bf)
        x = cs.randn(g, (m, k), bf)
        variants(mm, 'int8_matmul_plan',
                 lambda: mm.int8_matmul(x, wq['q'], wq['scale']),
                 mm.int8_matmul_ref(x, wq['q'], wq['scale']),
                 [(f'stream {m}x{k}x{n} kslice={ks}',
                   dict(route='stream', cw=8, ng=1, stages=4, kslice=ks,
                        slices=-(-k // ks)))
                  for ks in (128, 256, 512, 1024) if ks <= k])
    for int8 in (False, True):
        d, f = cs.D_LL, cs.FF_38B
        g = cs.gen(cs.SEED + 16)
        x, res = cs.randn(g, (cs.B, d), bf), cs.randn(g, (cs.B, d), bf)
        shapes = ((d, f), (d, f), (f, d))
        ws = ([cs.int8_weight(g, a, b, bf) for a, b in shapes] if int8 else
              [cs.randn(g, s_, bf, std=s_[0] ** -0.5) for s_ in shapes])
        fn = ft.ffn_tail_gated_int8 if int8 else ft.ffn_tail_gated
        ref = ft.ffn_tail_gated_int8_ref if int8 else ft.ffn_tail_gated_ref
        rule = ft.ffn_tail_plan(cs.B, d, f, bf, gated=True, int8=int8)
        out[f'gated{" int8" if int8 else ""} rule'] = rule

        def split(kk, ns):
            ks = -(-(-(-kk // ns)) // 64) * 64
            return dict(kslice=ks, slices=-(-kk // ks))
        plans = [(f'gated{" int8" if int8 else ""} up cw={cw} S={st} '
                  f'ns={ns}', dict(rule, up=dict(
                      cw=cw, ng=1, stages=st, **split(d, ns))))
                 for cw in (8, 4) for st in (4, 3) for ns in (1, 2, 3)]
        plans += [(f'gated{" int8" if int8 else ""} down ns={ns}',
                   dict(rule, down=dict(rule['down'], **split(f, ns))))
                  for ns in (4, 7, 8, 9, 16)]
        variants(ft, 'ffn_tail_plan', lambda: fn(x, res, *ws),
                 ref(x, res, *ws), plans)
        del ws
        torch.cuda.empty_cache()
    ll = llama_config('7b')
    argv = ['--device', cs.DEV, '--config', 'llama-7b', '--dtype',
            'bfloat16', '--batch_size', str(cs.B_7B), '--lr', '1e-3',
            '--remat', '--int8_base']
    kernel = mm.int8_matmul
    mm.int8_matmul = mm.int8_matmul_ref
    try:
        r = cs.train_run('llama-7b int8_base, plain int8_matmul', argv,
                         cs.B_7B, 512, ll.n_layers,
                         dict(cs.train_launches(ll, 'int8_base', remat=True),
                              int8_matmul=0), timed=6, stop_after=True)
    finally:
        mm.int8_matmul = kernel
    out['int8_base plain int8_matmul losses'] = r['losses']
    return out


# the synthetic-data seeds of --int8-losses (0: the tune CLI's own batches)
# and the steps whose every int8_matmul call its first run holds against the
# twin (0: the first, 5: the loss's peak, 9: the last)
LOSS_SEEDS = (0, 1, 2)
LOSS_CHECK_STEPS = (0, 5, 9)


def int8_losses(cs) -> dict:
    """Phase 10's LLaMA-7B int8_base tune run (10 steps, lr 1e-3, --remat)
    on the synthetic batches of each LOSS_SEEDS numpy seed, with
    int8_matmul's forward on the wgmma kernel (its rule), on the CUDA-core
    kernels (the rule forced to route 'cuda_core') and as its plain twin:
    the losses of each run. The first run (wgmma, seed 0) also holds every
    int8_matmul call of LOSS_CHECK_STEPS, the --remat recompute included,
    against the twin on the call's own tensors (BF16_OUTPUT_TOL, its
    absolute part scaled by the call's largest output)."""
    import numpy as np
    import torch
    from spt_proto_tpu_torch.cli import tune
    from spt_proto_tpu_torch.config import llama_config
    from spt_proto_tpu_torch.ops import int8_matmul as mm
    ll = llama_config('7b')
    argv = ['--device', cs.DEV, '--config', 'llama-7b', '--dtype',
            'bfloat16', '--batch_size', str(cs.B_7B), '--lr', '1e-3',
            '--remat', '--int8_base']
    per_layer = cs.train_launches(ll, 'int8_base', remat=True)
    per_step = ll.n_layers * per_layer['int8_matmul']
    kernel, rule, batches = mm.int8_matmul, mm.int8_matmul_plan, \
        tune.synthetic_batches
    checked = {}

    def seeded(seed):
        def gen_batches(vocab_size, batch_size, seq_length):
            r = np.random.RandomState(seed)
            while True:
                x = r.randint(0, vocab_size, size=(batch_size, seq_length)
                              ).astype(np.int32)
                yield {'inputs': x[:, :-1], 'targets': x[:, 1:]}
        return gen_batches

    def checking(x, q, scale):
        i = checking.calls
        checking.calls += 1
        out = kernel(x, q, scale)    # counts its launch on `checking`
        step = i // per_step
        if step in LOSS_CHECK_STEPS:
            want = mm.int8_matmul_ref(x, q, scale)
            tol = (cs.BF16_OUTPUT_TOL[0] * want.float().abs().max().item(),
                   cs.BF16_OUTPUT_TOL[1])
            err = (out.float() - want.float()).abs()
            ratio = (err / (tol[0] + tol[1] * want.float().abs())).max()
            c = checked.setdefault(f'step {step}', dict(
                calls=0, worst_of_bound=0.0, forms=set()))
            c['calls'] += 1
            c['worst_of_bound'] = max(c['worst_of_bound'], ratio.item())
            c['forms'].add(cs.call_form('int8_matmul', (x, q))[1])
        return out
    checking.calls = checking.launches = 0

    out = {}
    forwards = (('wgmma', None, None), ('cuda_core', None,
                                        dict(route='cuda_core')),
                ('twin', mm.int8_matmul_ref, None))
    for seed in LOSS_SEEDS:
        for name, fn, plan in forwards:
            first = seed == LOSS_SEEDS[0] and name == 'wgmma'
            tune.synthetic_batches = seeded(seed)
            mm.int8_matmul = checking if first else fn or kernel
            if plan is not None:
                mm.int8_matmul_plan = lambda *a, _p=plan, **k: _p
            try:
                r = cs.train_run(
                    f'llama-7b int8_base seed {seed} {name}', argv, cs.B_7B,
                    512, ll.n_layers, dict(per_layer, int8_matmul=0)
                    if name == 'twin' else per_layer, timed=6,
                    stop_after=True, loss_slack=float('inf'))
            finally:
                mm.int8_matmul, mm.int8_matmul_plan = kernel, rule
                tune.synthetic_batches = batches
            losses = r['losses']
            out[f'seed {seed} {name} losses'] = losses
            out[f'seed {seed} {name} last below first'] = (losses[-1]
                                                           < losses[0])
            torch.cuda.empty_cache()
    for c in checked.values():
        c['forms'] = sorted(c['forms'])
    out['wgmma seed 0 every call vs twin'] = checked
    out['every checked call within the bound'] = all(
        c['worst_of_bound'] <= 1 and c['calls'] == per_step
        for c in checked.values()) and len(checked) == len(LOSS_CHECK_STEPS)
    return out


# decode_front's timed shapes: (label, check_front's model, packed)
FRONT_SHAPES = (('opt-125m stack', None, False),
                ('opt-125m packed_int8', None, True),
                ('llama-7b stack', 'llama-7b', False),
                ('llama-7b packed_int8', 'llama-7b', True),
                ('llama-3-8b triple', 'llama-3-8b', False),
                ('llama-3-8b triple_int8', 'llama-3-8b', True))


def front_weights(cs, model, packed):
    """The concatenated [D, Nq + 2 Nkv] weight of a FRONT_SHAPES entry in
    bf16 (dequantized for the int8 forms) and its slots: the cuBLAS
    yardstick of the front's projection."""
    import torch
    from spt_proto_tpu_torch.inference.weights import quantize_int8
    geo = cs.LLAMA_FRONTS[model] if model else {}
    bf = torch.bfloat16
    w = cs.front_inputs(bf, cs.gen(cs.SEED + 1), **geo)[3]
    parts = list(w)
    if packed:
        parts = [cs.dequant(quantize_int8(t), bf) for t in parts]
    return torch.cat(parts, 1), geo.get('b', cs.B)


def front_ab(cs, timer) -> dict:
    """decode_front at FRONT_SHAPES and decode_attention_rows_q at four
    cases (cold and clean L2; the front's kernels apart), then the decode
    runs of phase 6 and phase 4 with both kernels in situ."""
    import torch
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    from spt_proto_tpu_torch.ops import decode_front as F
    bf = torch.bfloat16
    out = {}
    rec = {}
    f0 = F.decode_front

    def recording(*a, **k):
        rec['front'] = (a, k)
        return f0(*a, **k)
    recording.launches = 0
    for t, tag in ((timer, ''), (clean_timer(cs), ' clean L2')):
        for name, model, packed in FRONT_SHAPES:
            F.decode_front = recording
            try:
                r, fo = cs.check_front(bf, t, packed=packed, model=model)
            finally:
                F.decode_front = f0
            out[f'decode_front {name}{tag} us'] = r['ms'] * 1e3
            out[f'decode_front {name} bound us'] = r['bound_ms'] * 1e3
            if not tag:
                a, k = rec['front']
                out[f'decode_front {name} kernels us'] = by_kernel(
                    cs, lambda: f0(*a, **k))
                wcat, b = front_weights(cs, model, packed)
                hn = torch.randn((b, wcat.shape[0]), device=cs.DEV).to(bf)
                out[f'decode_front {name} cuBLAS hn @ w us'] = t.ms(
                    lambda: hn @ wcat) * 1e3
                del wcat
            if name == 'opt-125m stack':
                opt_front = fo
        cases = (('opt-125m sparse', lambda: cs.check_attention(
                     bf, opt_front, t)),
                 ('opt-125m dense tps 4', lambda: cs.check_attention(
                     bf, None, t, dense=True)),
                 ('llama-3-8b sparse G=4', lambda: cs.check_attention_gqa(
                     bf, True, False, t)),
                 ('llama-3-8b dense T=17', lambda: cs.check_attention_gqa(
                     bf, True, True, t)))
        for name, fn in cases:
            r = fn()
            out[f'attention {name}{tag} us'] = r['ms'] * 1e3
            out[f'attention {name} bound us'] = r['bound_ms'] * 1e3
        del opt_front
    del t
    torch.cuda.empty_cache()

    def per_call(prof, key, calls_key):
        return in_situ(prof['by_kernel'], (key,), (calls_key,))

    def record(label, r):
        prof = r['decode_profile']
        bk = prof['by_kernel']
        calls = ('decode_front_tail' if any('decode_front_tail' in k
                                            for k in bk)
                 else 'decode_front_kernel')
        out[f'{label} ms/step'] = r['decode_ms'] / r['steps']
        out[f'{label} peak GB'] = r['peak_mem_gb']
        out[f'{label} busy'] = prof['busy_share']
        out[f'{label} decode_front us a call'] = per_call(prof,
                                                          'decode_front',
                                                          calls)
        out[f'{label} attention us a call'] = per_call(
            prof, 'decode_attention_q', 'decode_attention_q')

    for model, b, runs in (
            ('3-8b', cs.B, (('sparse int8-KV', None),
                            ('sparse int8-KV w8', 'int8'))),
            ('7b', cs.B_7B, (('sparse int8-KV w8', 'int8'),))):
        cfg = cs.llama_cfg(model, cs.MAX_LEN, bf, n_layers=cs.LLAMA_LAYERS)
        params = init_params(cfg, cs.SEED, device=cs.DEV)
        tokens = torch.randint(1, cfg.vocab_size, (b, cs.LLAMA_PROMPT),
                               generator=cs.gen(cs.SEED), device=cs.DEV)
        for mode, quant in runs:
            label = f'{model} B={b} {mode}'
            iw = InferenceWeights.from_params(cfg, params, quant=quant)
            r = cs.serving_run(label, iw, tokens, cs.MAX_LEN,
                               cs.LLAMA_STEPS, True)
            record(label, dict(r, steps=cs.LLAMA_STEPS))
            del iw
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    sparse = cs.opt_cfg('125m', cs.MAX_LEN, bf)
    params = init_params(sparse, cs.SEED, device=cs.DEV)
    tokens = torch.randint(1, cs.VOCAB, (cs.B, cs.PROMPT),
                           generator=cs.gen(cs.SEED), device=cs.DEV)
    r = cs.serving_run('125m B=8 sparse int8-KV',
                       InferenceWeights.from_params(sparse, params), tokens,
                       cs.MAX_LEN, cs.STEPS, True)
    record('125m B=8 sparse int8-KV', dict(r, steps=cs.STEPS))
    return out


HOST_STEPS = 32


def host_run(cs, label, cfg, iw, tokens, quantized=True,
             wrappers=('decode_front', 'decode_attention_rows_q')) -> dict:
    """One decode run of host_steps (quantized: an int8 KV cache): after a
    warm-up (prefill and 2 steps), (synced) a sync, then HOST_STEPS steps
    with time.perf_counter read around each step's enqueue and a CUDA event
    after it: host ms a step, and the card's ms between consecutive events,
    which is the slower of the host and the card; (behind prefill) events
    around a prefill and the steps after it with no sync between them,
    beside the host's enqueue ms of each; (busy) the profiler's device time
    over 4 steps started after a sync; (wrappers) each named engine
    wrapper's host us a call (the engine's calls, 8 steps); (cprofile) the
    12 functions with the most own host time over 4 steps."""
    import cProfile
    import pstats
    import statistics
    import time
    import torch
    from spt_proto_tpu_torch.inference import engine
    bf = torch.bfloat16
    pc = time.perf_counter
    b = tokens.shape[0]

    def fresh():
        cache = engine.KVCache.create(cfg, b, cs.MAX_LEN, dtype=bf,
                                      quantized=quantized, device=cs.DEV)
        logits, cache = engine.prefill(iw, tokens, cache)
        return torch.argmax(logits[:, -1], -1).to(torch.int32), cache

    def steps(tok, cache, n, host=None, events=None):
        for _ in range(n):
            t0 = pc()
            tok, cache = engine.decode_step_greedy(iw, tok, cache)
            if host is not None:
                host.append((pc() - t0) * 1e3)
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        return tok, cache

    steps(*fresh(), 2)                                  # warm-up
    tok, cache = fresh()
    torch.cuda.synchronize()
    host, ev = [], [torch.cuda.Event(enable_timing=True)]
    ev[0].record()
    steps(tok, cache, HOST_STEPS, host, ev)
    torch.cuda.synchronize()
    dev = [a.elapsed_time(z) for a, z in zip(ev, ev[1:])]
    r = {'synced host ms/step median': statistics.median(host),
         'synced host ms first 3': host[:3],
         'synced card ms/step median': statistics.median(dev),
         'synced card ms first 3': dev[:3],
         'synced ms/step': ev[0].elapsed_time(ev[-1]) / HOST_STEPS}
    cache = engine.KVCache.create(cfg, b, cs.MAX_LEN, dtype=bf,
                                  quantized=quantized, device=cs.DEV)
    torch.cuda.synchronize()
    e3 = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = pc()
    e3[0].record()
    logits, cache = engine.prefill(iw, tokens, cache)
    e3[1].record()
    t1 = pc()
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    steps(tok, cache, HOST_STEPS)
    e3[2].record()
    t2 = pc()
    torch.cuda.synchronize()
    r.update({
        'behind prefill ms/step': e3[1].elapsed_time(e3[2]) / HOST_STEPS,
        'behind prefill card prefill ms': e3[0].elapsed_time(e3[1]),
        'behind prefill host prefill ms': (t1 - t0) * 1e3,
        'behind prefill host ms/step': (t2 - t1) * 1e3 / HOST_STEPS})
    tok, cache = fresh()
    torch.cuda.synchronize()
    prof = cs.device_profile(f'{label}: 4 steps after a sync',
                             lambda: steps(tok, cache, 4))
    r['busy card ms/step'] = prof['device_busy_us'] / 4e3
    r['busy window ms/step'] = prof['window_us'] / 4e3
    spent = {}
    saved = {}
    for name in wrappers:
        f0 = saved[name] = getattr(engine, name)

        def timed(*a, _f=f0, _n=name, **k):
            t = pc()
            o = _f(*a, **k)
            spent.setdefault(_n, []).append(pc() - t)
            return o
        setattr(engine, name, timed)
    try:
        tok, cache = fresh()
        torch.cuda.synchronize()
        steps(tok, cache, 8)
        torch.cuda.synchronize()
    finally:
        for name, f0 in saved.items():
            setattr(engine, name, f0)
    for name, ts in spent.items():
        r[f'{name} host us a call'] = statistics.median(ts) * 1e6
    tok, cache = fresh()
    torch.cuda.synchronize()
    cp = cProfile.Profile()
    cp.enable()
    steps(tok, cache, 4)
    cp.disable()
    st = pstats.Stats(cp)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]
    r['cprofile own ms/step'] = [
        f'{fn[0].rsplit("/", 1)[-1]}:{fn[1]}({fn[2]}) '
        f'{v[2] / 4 * 1e3:.3f} ms, {v[1] // 4} calls'
        for fn, v in rows]
    r['cprofile total ms/step'] = st.total_tt / 4 * 1e3
    print(f'{label}: {json.dumps(r)}', file=sys.stderr, flush=True)
    return {f'{label} {k}': v for k, v in r.items()}


def host_steps(cs) -> dict:
    """Decode steps on the host's clock and the card's (host_run), at phase
    6's Llama-3-8B B=8 sparse int8-KV fp and w8 runs, LLaMA-7B w8 B=4 and
    phase 4's OPT-125M sparse int8-KV run, with decode_front's and
    decode_attention_rows_q's host us a call."""
    import torch
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    bf = torch.bfloat16
    out = {}
    for model, b, runs in (
            ('3-8b', cs.B, ((None, 'sparse int8-KV'),
                            ('int8', 'sparse int8-KV w8'))),
            ('7b', cs.B_7B, (('int8', 'sparse int8-KV w8'),))):
        cfg = cs.llama_cfg(model, cs.MAX_LEN, bf, n_layers=cs.LLAMA_LAYERS)
        params = init_params(cfg, cs.SEED, device=cs.DEV)
        tokens = torch.randint(1, cfg.vocab_size, (b, cs.LLAMA_PROMPT),
                               generator=cs.gen(cs.SEED), device=cs.DEV)
        for quant, mode in runs:
            iw = InferenceWeights.from_params(cfg, params, quant=quant)
            out.update(host_run(cs, f'{model} B={b} {mode}', cfg, iw,
                                tokens))
            del iw
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    cfg = cs.opt_cfg('125m', cs.MAX_LEN, bf)
    params = init_params(cfg, cs.SEED, device=cs.DEV)
    tokens = torch.randint(1, cs.VOCAB, (cs.B, cs.PROMPT),
                           generator=cs.gen(cs.SEED), device=cs.DEV)
    out.update(host_run(cs, '125m B=8 sparse int8-KV', cfg,
                        InferenceWeights.from_params(cfg, params), tokens))
    return out


# profiler names of the bf16-KV decode attention's kernels and of the
# block-sparse forward's, in either checkout
ROWS_NAMES = ('decode_attention_kernel', 'decode_attention_walk_kernel',
              'decode_attention_split_kernel')
BSA_NAMES = ('block_sparse_fwd_kernel',)


def sdpa_ms(timer, b, h, kv, s_q, s_k, d, causal):
    """Dense SDPA's time over q [b, h, s_q, d] and k / v [b, h, s_k, d]
    (the kv heads repeated to h outside the timed call), bf16."""
    import torch
    g = torch.Generator(device='cuda')
    g.manual_seed(0)
    q = torch.randn((b, h, s_q, d), generator=g, device='cuda').bfloat16()
    k, v = (torch.randn((b, kv, s_k, d), generator=g, device='cuda')
            .bfloat16().repeat_interleave(h // kv, 1) for _ in range(2))
    return timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal))


def dense_attn(cs, timer) -> dict:
    """decode_attention_rows at six shapes (OPT-125M dense T=17, dense
    supertiles of 4, sparse; Llama-3-8B G=4 sparse, dense T=17 and T=96),
    each checked against its twin first, from a cold and a clean L2 beside
    its bound and dense SDPA of one query row over the same context; then
    phase 4's OPT-125M dense and sparse bf16-KV decode runs and phase 6's
    Llama-3-8B dense bf16-KV run (serving_run: ms a step, the attention's
    in-situ us a call from the profiled 4 steps) and, on the host's clock,
    the same runs synced (host_run, with decode_attention_rows' host us a
    call)."""
    import torch
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    bf = torch.bfloat16
    out = {}
    _, fo = cs.check_front(bf, None, quantized=False)
    for t, tag in ((timer, ''), (clean_timer(cs), ' clean L2')):
        cases = (
            ('opt-125m dense T=17', lambda: cs.check_rows(bf, 'dense', None,
                                                          t)),
            ('opt-125m dense tps 4', lambda: cs.check_rows(
                bf, 'dense-tps4', None, t)),
            ('opt-125m sparse', lambda: cs.check_rows(bf, 'sparse', fo, t)),
            ('llama-3-8b sparse G=4', lambda: cs.check_attention_gqa(
                bf, False, False, t)),
            ('llama-3-8b dense T=17', lambda: cs.check_attention_gqa(
                bf, False, True, t)),
            ('llama-3-8b dense T=96', lambda: cs.check_attention_gqa(
                bf, False, True, t, nt=97, pos0=96 * cs.TILE - cs.B,
                layers=2)))
        for name, fn in cases:
            r = fn()
            out[f'{name}{tag} us'] = r['ms'] * 1e3
            out[f'{name} bound us'] = r['bound_ms'] * 1e3
    # one query row over the same number of tokens (no table gather)
    for name, (h, kv, s_k, d) in (
            ('opt-125m dense T=17', (cs.HEADS, cs.HEADS, cs.PROMPT + 1,
                                     cs.DH)),
            ('opt-125m sparse', (cs.HEADS, cs.HEADS, 3 * cs.TILE, cs.DH)),
            ('llama-3-8b sparse G=4', (cs.HEADS_LL, cs.KV_38B, 3 * cs.TILE,
                                       cs.DH_LL)),
            ('llama-3-8b dense T=17', (cs.HEADS_LL, cs.KV_38B, cs.PROMPT + 1,
                                       cs.DH_LL)),
            ('llama-3-8b dense T=96', (cs.HEADS_LL, cs.KV_38B,
                                       96 * cs.TILE, cs.DH_LL))):
        out[f'{name} SDPA us'] = sdpa_ms(timer, cs.B, h, kv, 1, s_k, d,
                                         False) * 1e3
    torch.cuda.empty_cache()

    def record(label, r, steps):
        bk = r['decode_profile']['by_kernel']
        out[f'{label} ms/step'] = r['decode_ms'] / steps
        out[f'{label} busy'] = r['decode_profile']['busy_share']
        out[f'{label} attention us a call'] = in_situ(bk, ROWS_NAMES,
                                                      ROWS_NAMES)
        out[f'{label} attention kernels'] = sorted(
            k[:60] for k in bk if any(n in k for n in ROWS_NAMES))
    wrap = ('decode_attention_rows',)
    sparse = cs.opt_cfg('125m', cs.MAX_LEN, bf)
    params = init_params(sparse, cs.SEED, device=cs.DEV)
    tokens = torch.randint(1, cs.VOCAB, (cs.B, cs.PROMPT),
                           generator=cs.gen(cs.SEED), device=cs.DEV)
    for label, cfg, p in (
            ('125m B=8 dense bf16-KV', cs.opt_cfg('125m', cs.MAX_LEN, bf,
                                                  dense=True),
             cs.dense_params(params)),
            ('125m B=8 sparse bf16-KV', sparse, params)):
        iw = InferenceWeights.from_params(cfg, p)
        record(label, cs.serving_run(label, iw, tokens, cs.MAX_LEN, cs.STEPS,
                                     False), cs.STEPS)
        out.update(host_run(cs, label, cfg, iw, tokens, False, wrap))
        del iw
    del params
    torch.cuda.empty_cache()
    cfg = cs.llama_cfg('3-8b', cs.MAX_LEN, bf, dense=True,
                       n_layers=cs.LLAMA_LAYERS)
    params = init_params(cfg, cs.SEED, device=cs.DEV)
    tokens = torch.randint(1, cfg.vocab_size, (cs.B, cs.LLAMA_PROMPT),
                           generator=cs.gen(cs.SEED), device=cs.DEV)
    iw = InferenceWeights.from_params(cfg, params)
    label = '3-8b B=8 dense bf16-KV'
    record(label, cs.serving_run(label, iw, tokens, cs.MAX_LEN,
                                 cs.LLAMA_STEPS, False), cs.LLAMA_STEPS)
    out.update(host_run(cs, label, cfg, iw, tokens, False, wrap))
    return out


def bsa(cs, timer) -> dict:
    """The block-sparse forward at three shapes (OPT-125M d 64 and
    Llama-3-8B d 128, 256-row q tiles at S 2048, and the lse form at the
    training shape, 96 x 512 x 64), each checked against its twin first,
    from a cold and a clean L2 beside its bound and dense causal SDPA over
    the same rows; then the OPT-125M (B=8) and Llama-3-8B (B=8, 16 layers)
    sparse prefills of prompt 2048 after a sync: prefill ms (CUDA events,
    median of 3), the forward's in-situ us a call (profiled prefill) and
    block_sparse_attention's host us a call."""
    import statistics
    import time
    import torch
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    bf = torch.bfloat16
    out = {}
    for t, tag in ((timer, ''), (clean_timer(cs), ' clean L2')):
        for name, fn in (
                ('opt-125m d 64 S 2048', lambda: cs.check_block_sparse(
                    bf, cs.PROMPT, 8, t)),
                ('llama-3-8b d 128 S 2048', lambda: cs.check_block_sparse(
                    bf, cs.PROMPT, 8, t, cs.B * cs.HEADS_LL, cs.DH_LL,
                    cs.N_SUB_LL)),
                ('lse 96 x 512 x 64', lambda: cs.check_block_sparse_train(
                    bf, cs.B * cs.HEADS, 512, cs.DH, 8, t)[
                        'block_sparse_attention_lse'])):
            r = fn()
            out[f'{name}{tag} us'] = r['ms'] * 1e3
            out[f'{name} bound us'] = r['bound_ms'] * 1e3
    for name, (bh, s, d) in (('opt-125m d 64 S 2048', (cs.B * cs.HEADS,
                                                       cs.PROMPT, cs.DH)),
                             ('llama-3-8b d 128 S 2048', (
                                 cs.B * cs.HEADS_LL, cs.PROMPT, cs.DH_LL)),
                             ('lse 96 x 512 x 64', (cs.B * cs.HEADS, 512,
                                                    cs.DH))):
        out[f'{name} SDPA causal us'] = sdpa_ms(timer, 1, bh, bh, s, s, d,
                                                True) * 1e3
    torch.cuda.empty_cache()
    pc = time.perf_counter
    for label, cfg, prompt in (
            ('125m B=8 sparse prefill', cs.opt_cfg('125m', cs.MAX_LEN, bf),
             cs.PROMPT),
            ('3-8b B=8 sparse prefill', cs.llama_cfg(
                '3-8b', cs.MAX_LEN, bf, n_layers=cs.LLAMA_LAYERS),
             cs.LLAMA_PROMPT)):
        params = init_params(cfg, cs.SEED, device=cs.DEV)
        iw = InferenceWeights.from_params(cfg, params)
        tokens = torch.randint(1, cfg.vocab_size, (cs.B, prompt),
                               generator=cs.gen(cs.SEED), device=cs.DEV)

        def prefill():
            cache = engine.KVCache.create(cfg, cs.B, cs.MAX_LEN, dtype=bf,
                                          device=cs.DEV)
            return engine.prefill(iw, tokens, cache)
        prefill()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            prefill()
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        out[f'{label} ms'] = statistics.median(times)
        torch.cuda.synchronize()
        prof = cs.device_profile(label, prefill)
        bk = prof['by_kernel']
        out[f'{label} forward us a call'] = in_situ(bk, BSA_NAMES, BSA_NAMES)
        out[f'{label} forward kernels'] = sorted(
            k[:60] for k in bk if any(n in k for n in BSA_NAMES))
        spent = []
        f0 = engine.block_sparse_attention

        def timed(*a, **k):
            t0 = pc()
            o = f0(*a, **k)
            spent.append(pc() - t0)
            return o
        engine.block_sparse_attention = timed
        try:
            torch.cuda.synchronize()
            prefill()
            torch.cuda.synchronize()
        finally:
            engine.block_sparse_attention = f0
        out[f'{label} block_sparse_attention host us a call'] = \
            statistics.median(spent) * 1e6
        del iw, params
        torch.cuda.empty_cache()
    return out


def attn_sweep(cs, timer) -> dict:
    """The plans of the bf16-KV split walk and the block-sparse tensor-core
    forward around their rules' picks, each call checked against its twin
    and timed (cold L2): the split walk's entries a chunk (ROWS_CHUNK) at
    dense_attn's six shapes, and the forward's warps a CTA (FWD_WARPS) at
    bsa's three; then (where the checkout has them) the paged split walk's
    steps a chunk (PAGED_CHUNK_STEPS) at the four paged shapes, and the
    verify split walk's entries a chunk and rows a CTA (VERIFY_CHUNK,
    VERIFY_ROWS) at the five verify shapes."""
    import torch
    from spt_proto_tpu_torch.ops import block_sparse_attention as bsa_m
    from spt_proto_tpu_torch.ops import decode_attention as rows_m
    bf = torch.bfloat16
    out = {}
    _, fo = cs.check_front(bf, None, quantized=False)
    shapes = (
        ('opt-125m dense T=17', lambda: cs.check_rows(bf, 'dense', None,
                                                      timer)),
        ('opt-125m dense tps 4', lambda: cs.check_rows(bf, 'dense-tps4', None,
                                                       timer)),
        ('opt-125m sparse', lambda: cs.check_rows(bf, 'sparse', fo, timer)),
        ('llama-3-8b sparse G=4', lambda: cs.check_attention_gqa(
            bf, False, False, timer)),
        ('llama-3-8b dense T=17', lambda: cs.check_attention_gqa(
            bf, False, True, timer)),
        ('llama-3-8b dense T=96', lambda: cs.check_attention_gqa(
            bf, False, True, timer, nt=97, pos0=96 * cs.TILE - cs.B,
            layers=2)))
    chunk0 = rows_m.ROWS_CHUNK
    try:
        for name, fn in shapes:
            for chunk in ((12, 16, 24, 48) if 'T=96' in name
                          else (1, 2, 3, 6, 8, 17)):
                rows_m.ROWS_CHUNK = chunk
                rows_m.rows_split_plan.cache_clear()
                out[f'{name} entries a chunk {chunk} us'] = fn()['ms'] * 1e3
    finally:
        rows_m.ROWS_CHUNK = chunk0
        rows_m.rows_split_plan.cache_clear()
    warps0 = dict(bsa_m.FWD_WARPS)
    try:
        for w in (4, 8):
            bsa_m.FWD_WARPS = {64: w, 128: w}
            for name, fn in (
                    ('opt-125m d 64 S 2048', lambda: cs.check_block_sparse(
                        bf, cs.PROMPT, 8, timer)),
                    ('llama-3-8b d 128 S 2048',
                     lambda: cs.check_block_sparse(
                         bf, cs.PROMPT, 8, timer, cs.B * cs.HEADS_LL,
                         cs.DH_LL, cs.N_SUB_LL)),
                    ('lse 96 x 512 x 64', lambda: cs.check_block_sparse_train(
                        bf, cs.B * cs.HEADS, 512, cs.DH, 8, timer)[
                            'block_sparse_attention_lse'])):
                out[f'{name} {w} warps us'] = fn()['ms'] * 1e3
    finally:
        bsa_m.FWD_WARPS = warps0
    from spt_proto_tpu_torch.ops import paged_attention as pa_m
    if hasattr(pa_m, 'PAGED_CHUNK_STEPS'):
        steps0 = dict(pa_m.PAGED_CHUNK_STEPS)
        try:
            for model in ('opt-125m', 'llama-3-8b'):
                for int8 in (False, True):
                    for st in (4, 8, 16):
                        pa_m.PAGED_CHUNK_STEPS = {False: st, True: st}
                        pa_m.paged_split_plan.cache_clear()
                        out[f'paged {model} {"int8" if int8 else "fp"} '
                            f'{st} steps us'] = cs.check_paged(
                                bf, model, int8, timer)['ms'] * 1e3
        finally:
            pa_m.PAGED_CHUNK_STEPS = steps0
            pa_m.paged_split_plan.cache_clear()
    if hasattr(rows_m, 'VERIFY_CHUNK'):
        v0 = dict(rows_m.VERIFY_CHUNK), rows_m.VERIFY_ROWS
        try:
            for name, args in (('opt-125m union', ('opt-125m', False)),
                               ('opt-125m dense', ('opt-125m', True)),
                               ('llama-3-8b union', ('llama-3-8b', False)),
                               ('llama-3-8b dense', ('llama-3-8b', True)),
                               ('llama-3-8b union K=30',
                                ('llama-3-8b', False, 30))):
                for ch, rows in ((2, 64), (3, 64), (4, 64), (6, 64),
                                 (4, 32)):
                    rows_m.VERIFY_CHUNK = {64: ch, 128: ch}
                    rows_m.VERIFY_ROWS = rows
                    rows_m.verify_split_plan.cache_clear()
                    out[f'verify {name} {ch} entries rows {rows} '
                        f'us'] = cs.check_verify(
                            bf, args[0], args[1], timer,
                            *args[2:])['ms'] * 1e3
        finally:
            rows_m.VERIFY_CHUNK, rows_m.VERIFY_ROWS = v0
            rows_m.verify_split_plan.cache_clear()
    return out


# the block-sparse backward's timed shapes: (label, B*H, S, d_head,
# sparse_coeff, PQ subspaces); coeff 8 lists are the diagonal pair, coeff 4
# ones hold off-diagonal and -1 entries
BSA_BWD_SHAPES = (('96 x 512 x 64 coeff 8', 96, 512, 64, 8, 8),
                  ('96 x 2048 x 64 coeff 8', 96, 2048, 64, 8, 8),
                  ('96 x 2048 x 64 coeff 4', 96, 2048, 64, 4, 8),
                  ('32 x 2048 x 128 coeff 4', 32, 2048, 128, 4, 16))
# the sweep's (dq keys a step, dk/dv rows a chunk) by d_head: every key
# step and chunk height the library holds
BSA_BWD_PLANS = {64: ((32, 16), (64, 32), (32, 64)), 128: ((32, 16),
                                                           (32, 32))}
BSA_BWD_NAMES = ('block_sparse_dq_kernel', 'block_sparse_dkv_kernel')


def sdpa_bwd_ms(timer, bh, s, d) -> float:
    """Dense causal SDPA's backward (dq, dk, dv through autograd) over q,
    k, v [1, bh, s, d] bf16: the yardstick of the block-sparse backward."""
    import torch
    g = torch.Generator(device='cuda')
    g.manual_seed(0)
    leaves = [torch.randn((1, bh, s, d), generator=g, device='cuda')
              .bfloat16().requires_grad_() for _ in range(3)]
    do = torch.randn((1, bh, s, d), generator=g, device='cuda').bfloat16()
    out = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                           is_causal=True)
    return timer.ms(lambda: torch.autograd.grad(out, leaves, do,
                                                retain_graph=True))


def bwd_glue_us(cs, bh, s, d, coeff, n_sub) -> float:
    """Device us a call of the backward's plain glue, dd = sum(g * o) and
    reverse_table(sel), at one shape (profiler, 10 calls, warm L2)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from spt_proto_tpu_torch.ops import block_sparse_attention as m
    g_ = cs.gen(cs.SEED + 9)
    sel = cs.sparse_sel(s, max(2, (s // 128) // coeff), bh, 256, g_, n_sub)
    g, o = (cs.randn(g_, (bh, s, d), torch.bfloat16) for _ in range(2))

    def glue():
        (g.float() * o.float()).sum(-1)
        m.reverse_table(sel, s // 128)
    for _ in range(3):
        glue()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            glue()
        torch.cuda.synchronize()
    return sum(a.device_time_total for a in prof.key_averages()
               if a.device_time_total > 0) / 10


def tune_steps(cs, seq) -> dict:
    """cli.tune.main at OPT-125M, bf16, B=8, S=seq: 2 warm-up steps, 4
    steps each between a sync and CUDA events (synced step ms, median),
    then 2 profiled steps after a sync: device ms a step, busy share, and
    the in-situ us a call of the lse forward, dq and dk/dv."""
    import statistics
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from spt_proto_tpu_torch.cli import tune
    from spt_proto_tpu_torch.tuning import trainer
    warm, synced, profiled = 2, 4, 2
    rec = dict(times=[])
    make = trainer.make_train_step

    def instrumented(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            i = state.step
            if i == warm + synced:
                torch.cuda.synchronize()
                rec['prof'] = profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
                rec['prof'].__enter__()
                rec['window'] = [torch.cuda.Event(enable_timing=True)
                                 for _ in range(2)]
                rec['window'][0].record()
            if warm <= i < warm + synced:
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                state, m = step(state, batch)
                ev[1].record()
                torch.cuda.synchronize()
                rec['times'].append(ev[0].elapsed_time(ev[1]))
            else:
                state, m = step(state, batch)
            if i == warm + synced + profiled - 1:
                rec['window'][1].record()
                torch.cuda.synchronize()
                rec['prof'].__exit__(None, None, None)
                raise cs._StopRun
            return state, m
        return run

    trainer.make_train_step = instrumented
    argv = ['--device', cs.DEV, '--config', 'opt-125m', '--batch_size',
            str(cs.B), '--dtype', 'bfloat16', '--seq_length', str(seq + 1),
            '--steps', str(warm + synced + profiled)]
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            tune.main(argv + ['--out', out_dir + '/tuned'])
    except cs._StopRun:
        pass
    finally:
        trainer.make_train_step = make
    prof = cs.profile_summary(f'tune S={seq}', rec['prof'],
                              rec['window'][0].elapsed_time(
                                  rec['window'][1]) * 1e3)
    bk = prof['by_kernel']
    out = {f'tune S={seq} synced step ms': statistics.median(rec['times']),
           f'tune S={seq} device ms a step': prof['device_busy_us']
           / profiled / 1e3,
           f'tune S={seq} busy': prof['busy_share']}
    for name in ('block_sparse_attention_lse', 'block_sparse_attention_dq',
                 'block_sparse_attention_dkv'):
        hits = [(t, c) for k, (t, c) in bk.items() if cs.IN_SITU[name](k)]
        out[f'tune S={seq} {name} in situ us'] = (
            sum(t for t, _ in hits) / max(1, sum(c for _, c in hits)))
    out[f'tune S={seq} backward kernels'] = sorted(
        k[:60] for k in bk if any(n in k for n in BSA_BWD_NAMES))
    return out


def bsa_bwd(cs, timer) -> dict:
    """The block-sparse backward: dq and dk/dv at BSA_BWD_SHAPES, each
    checked against its twin first (the checkout's check_block_sparse_train),
    cold L2, beside their bounds, dense causal SDPA's backward over the
    same rows and the plain glue's device us a call (dd and reverse_table);
    then the bf16 OPT-125M tune steps at S 512 and 2048 (tune_steps); and,
    in a checkout that has the tensor-core pair's plan, the sweep of its dq
    key step and dk/dv chunk height (BSA_BWD_PLANS) at the same shapes."""
    import torch
    from spt_proto_tpu_torch.ops import block_sparse_attention as m
    bf = torch.bfloat16
    out = {}
    for name, bh, s, d, coeff, n_sub in BSA_BWD_SHAPES:
        r = cs.check_block_sparse_train(bf, bh, s, d, coeff, timer, n_sub)
        for kern in ('dq', 'dkv'):
            row = r[f'block_sparse_attention_{kern}']
            out[f'{name} {kern} us'] = row['ms'] * 1e3
            out[f'{name} {kern} bound us'] = row['bound_ms'] * 1e3
        out[f'{name} lse us'] = r['block_sparse_attention_lse']['ms'] * 1e3
        out[f'{name} SDPA backward us'] = sdpa_bwd_ms(timer, bh, s, d) * 1e3
        out[f'{name} glue us'] = bwd_glue_us(cs, bh, s, d, coeff, n_sub)
    torch.cuda.empty_cache()
    for seq in (512, 2048):
        out.update(tune_steps(cs, seq))
        torch.cuda.empty_cache()
    if hasattr(m, 'BWD_DQ_KEYS'):
        keys0, rows0 = dict(m.BWD_DQ_KEYS), dict(m.BWD_DKV_ROWS)
        try:
            for name, bh, s, d, coeff, n_sub in BSA_BWD_SHAPES:
                for keys, rows in BSA_BWD_PLANS[d]:
                    m.BWD_DQ_KEYS, m.BWD_DKV_ROWS = {d: keys}, {d: rows}
                    r = cs.check_block_sparse_train(bf, bh, s, d, coeff,
                                                    timer, n_sub)
                    out[f'sweep {name} dq {keys} keys us'] = r[
                        'block_sparse_attention_dq']['ms'] * 1e3
                    out[f'sweep {name} dkv {rows} rows us'] = r[
                        'block_sparse_attention_dkv']['ms'] * 1e3
        finally:
            m.BWD_DQ_KEYS, m.BWD_DKV_ROWS = keys0, rows0
    return out


# profiler names of the paged and verify kernels in either checkout
PAGED_NAMES = ('paged_attention_kernel', 'paged_attention_split_kernel')
VERIFY_NAMES = ('verify_attention_kernel', 'verify_attention_split_kernel')
SYNCED = 8            # steps timed one by one after a sync


def kernel_and_glue(cs, fn, reps=10) -> tuple[float, float, float]:
    """Device us a call of fn's spt kernels and of its other device work
    (the wrapper's torch ops), and those ops' count, from the profiler over
    reps calls, each after chip_smoke's L2 flush (the flush excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    timer = cs.Timer()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    spt = glue = ops = 0.0
    for a in prof.key_averages():
        if a.device_time_total <= 0 or 'FillFunctor<unsigned char' in a.key:
            continue
        if 'spt::' in a.key:
            spt += a.device_time_total / reps
        else:
            glue += a.device_time_total / reps
            ops += a.count / reps
    return spt, glue, ops


def synced_median(step, n=SYNCED) -> float:
    """Median ms of n calls of step, each between a sync and CUDA events."""
    import statistics
    import torch
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step()
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(times)


def engine_record(cs, out, label, iw, prompts, names, **kw) -> None:
    """One phase-8 engine run (engine_run, profiled) and its numbers: the
    kernels' in-situ us a call and their launches a profiled step, device
    ms and busy share a step (4 profiled steps), mean and decode-only step
    ms, and engine steps of 8 decoding slots timed after a sync."""
    from spt_proto_tpu_torch.inference import batching
    r = cs.engine_run(label, iw, prompts, profile=True, **kw)
    prof = r['step_profile']
    out[f'{label} kernel us a call'] = in_situ(prof['by_kernel'], names,
                                               names)
    out[f'{label} kernels'] = sorted(k[:60] for k in prof['by_kernel']
                                     if any(n in k for n in names))
    out[f'{label} device ms a step'] = prof['device_busy_us'] / 4e3
    out[f'{label} busy'] = prof['busy_share']
    out[f'{label} mean step ms'] = r['mean_step_ms']
    out[f'{label} decode-only step ms'] = r['decode_only_step_ms']
    kw = {**dict(n_slots=cs.SERVE_SLOTS, max_len=cs.MAX_LEN,
                 prefill_bucket=cs.SERVE_BUCKET), **kw}
    eng = batching.ContinuousBatchingEngine(iw, **kw)
    for p in prompts[:cs.SERVE_SLOTS]:
        eng.submit(p, max_new_tokens=SYNCED + 4)
    eng.step()
    eng.step()
    out[f'{label} synced step ms'] = synced_median(eng.step)
    del eng


def paged(cs, timer) -> dict:
    """paged_attention at the four serving shapes, then the paged engines
    (engine_record) at OPT-125M (dense bf16-KV and int8-KV) and Llama-3-8B
    (16 layers, dense bf16-KV)."""
    import torch
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    bf = torch.bfloat16
    out = {}
    from spt_proto_tpu_torch.ops import paged_attention as pa
    for model in ('opt-125m', 'llama-3-8b'):
        for int8 in (False, True):
            name = f'{model} {"int8" if int8 else "fp"}'
            r = cs.check_paged(bf, model, int8, timer)
            out[f'{name} us'] = r['ms'] * 1e3
            out[f'{name} bound us'] = r['bound_ms'] * 1e3
            out[f'{name} plain us'] = r['plain_ms'] * 1e3
            if r.get('library_ms') is not None:
                out[f'{name} SDPA us'] = r['library_ms'] * 1e3
            args, sc = cs.paged_inputs(bf, model, int8, cs.gen(cs.SEED + 13))
            scale = args[0].shape[2] ** -0.5
            (out[f'{name} kernel us'], out[f'{name} glue us'],
             out[f'{name} glue ops']) = kernel_and_glue(
                cs, lambda: pa.paged_attention(*args, scale=scale, **sc))
    torch.cuda.empty_cache()
    cfg = cs.opt_cfg('125m', cs.MAX_LEN, bf, dense=True)
    params = init_params(cs.opt_cfg('125m', cs.MAX_LEN, bf), cs.SEED,
                         device=cs.DEV)
    iw = InferenceWeights.from_params(cfg, cs.dense_params(params))
    prompts = cs.serve_traffic(cs.VOCAB)[0]
    for label, kw in (('125m paged dense bf16-KV', {}),
                      ('125m paged dense int8-KV', dict(quantized_kv=True))):
        engine_record(cs, out, label, iw, prompts, PAGED_NAMES, paged=True,
                      page_size=cs.PAGED_PS, **kw)
    del iw, params
    torch.cuda.empty_cache()
    cfg = cs.llama_cfg('3-8b', cs.MAX_LEN, bf, dense=True,
                       n_layers=cs.LLAMA_LAYERS)
    params = init_params(cs.llama_cfg('3-8b', cs.MAX_LEN, bf,
                                      n_layers=cs.LLAMA_LAYERS),
                         cs.SEED, device=cs.DEV)
    iw = InferenceWeights.from_params(cfg, cs.dense_params(params))
    del params
    engine_record(cs, out, '3-8b paged dense bf16-KV', iw,
                  cs.serve_traffic(cfg.vocab_size)[0], PAGED_NAMES,
                  paged=True, page_size=cs.PAGED_PS)
    return out


def verify(cs, timer) -> dict:
    """verify_attention_rows at five speculative shapes, then the n-gram
    speculative runs (spec_run: OPT-125M, Llama-3-8B at 16 layers) with the
    kernel in situ, device ms a verify round and verify steps timed after
    a sync, and phase 8's speculative engine (engine_record)."""
    import dataclasses
    import torch
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    from spt_proto_tpu_torch.ops import decode_attention as da
    bf = torch.bfloat16
    out = {}
    for name, args in (('opt-125m union', ('opt-125m', False)),
                       ('opt-125m dense', ('opt-125m', True)),
                       ('llama-3-8b union', ('llama-3-8b', False)),
                       ('llama-3-8b dense', ('llama-3-8b', True)),
                       ('llama-3-8b union K=30', ('llama-3-8b', False, 30))):
        r = cs.check_verify(bf, args[0], args[1], timer, *args[2:])
        out[f'{name} us'] = r['ms'] * 1e3
        out[f'{name} bound us'] = r['bound_ms'] * 1e3
        out[f'{name} plain us'] = r['plain_ms'] * 1e3
        if r.get('library_ms') is not None:
            out[f'{name} SDPA us'] = r['library_ms'] * 1e3
        va = cs.verify_inputs(bf, args[0], args[1], cs.gen(cs.SEED + 12),
                              *args[2:])
        kw = dict(ps=cs.TILE, scale=va[0].shape[3] ** -0.5,
                  clamp=0.0 if args[1] else 10.0)
        (out[f'{name} kernel us'], out[f'{name} glue us'],
         out[f'{name} glue ops']) = kernel_and_glue(
            cs, lambda: da.verify_attention_rows(*va, **kw))
    torch.cuda.empty_cache()

    def spec(label, cfg, iw):
        prompts = cs.spec_workload(cfg.vocab_size)
        r = cs.spec_run(label, iw, prompts, False)
        prof = r['verify_profile']
        out[f'{label} kernel us a call'] = in_situ(
            prof['by_kernel'], VERIFY_NAMES, VERIFY_NAMES)
        out[f'{label} device ms a round'] = prof['device_busy_us'] / 4e3
        out[f'{label} busy'] = prof['busy_share']
        out[f'{label} verify ms (events)'] = r['verify_ms']
        out[f'{label} decode ms (events)'] = r['decode_ms']
        out[f'{label} acceptance'] = r['acceptance']
        cache = engine.KVCache.create(cfg, prompts.shape[0], cs.SPEC_MAX_LEN,
                                      dtype=bf, device=cs.DEV)
        logits, cache = engine.prefill(iw, prompts, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        box = [tok, cache]

        def ver():
            blk = box[0][:, None].expand(-1, cs.KK).contiguous()
            lg, c = engine.verify_step(iw, blk, box[1])
            box[1] = dataclasses.replace(c, length=c.length - cs.SPEC_K)
            box[0] = torch.argmax(lg[:, -1], -1).to(torch.int32)
        ver()
        out[f'{label} synced verify ms'] = synced_median(ver)
        del cache, box
        torch.cuda.empty_cache()

    cfg = cs.opt_cfg('125m', cs.SPEC_MAX_LEN, bf)
    params = init_params(cfg, cs.SEED, device=cs.DEV)
    spec('spec 125m n-gram bf16-KV', cfg,
         InferenceWeights.from_params(cfg, params))
    ecfg = cs.opt_cfg('125m', cs.MAX_LEN, bf)
    engine_record(cs, out, '125m engine speculative=4',
                  InferenceWeights.from_params(ecfg, params),
                  cs.serve_traffic(cs.VOCAB)[0], VERIFY_NAMES,
                  speculative=cs.SPEC_K)
    del params
    torch.cuda.empty_cache()
    cfg = cs.llama_cfg('3-8b', cs.SPEC_MAX_LEN, bf, n_layers=cs.LLAMA_LAYERS)
    params = init_params(cfg, cs.SEED, device=cs.DEV)
    spec('spec 3-8b n-gram bf16-KV', cfg,
         InferenceWeights.from_params(cfg, params))
    return out


def one(root: str, mode: str | None) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    timer, bf = cs.Timer(), torch.bfloat16
    out = dict(tree=root)
    if mode == '--flash':
        for name, shape in cs.FLASH_SHAPES.items():
            if shape[2] in (512, 2048):
                res = cs.check_flash(bf, shape, timer)
                out.update({f'{name} {k} us': r['ms'] * 1e3
                            for k, r in res.items()})
                out[f'{name} fwd from contiguous us'] = (
                    res['flash_attention']['contiguous_inputs_ms'] * 1e3)
        return out
    if mode == '--int8t':
        for name, (m, k, n) in cs.INT8_T_SHAPES.items():
            res = cs.check_int8_matmul_t(bf, m, k, n, timer)
            out[f'{name} us'] = res['ms'] * 1e3
        return out
    if mode == '--head':
        return dict(out, **head(cs, timer))
    if mode == '--e2e':
        return dict(out, **e2e(cs))
    if mode == '--gmm':
        return dict(out, **gmm(cs, timer))
    if mode == '--int8':
        return dict(out, **int8_kernels(cs, timer), **int8_runs(cs))
    if mode == '--int8-sweep':
        return dict(out, **int8_sweep(cs, timer))
    if mode == '--int8-losses':
        return dict(out, **int8_losses(cs))
    if mode == '--front':
        return dict(out, **front_ab(cs, timer))
    if mode == '--host':
        return dict(out, **host_steps(cs))
    if mode == '--dense-attn':
        return dict(out, **dense_attn(cs, timer))
    if mode == '--bsa':
        return dict(out, **bsa(cs, timer))
    if mode == '--attn-sweep':
        return dict(out, **attn_sweep(cs, timer))
    if mode == '--paged':
        return dict(out, **paged(cs, timer))
    if mode == '--verify':
        return dict(out, **verify(cs, timer))
    if mode == '--bsa-bwd':
        return dict(out, **bsa_bwd(cs, timer))
    front = cs.check_front(bf, timer)[0]['ms']
    front8 = cs.check_front(bf, timer, packed=True)[0]['ms']
    tail8 = cs.check_ffn(bf, cs.D, cs.FF, timer, int8=True)['ms']
    return dict(out, decode_front_us=front * 1e3,
                decode_front_packed_int8_us=front8 * 1e3,
                ffn_tail_us=cs.check_ffn(bf, cs.D, cs.FF, timer)['ms'] * 1e3,
                ffn_tail_int8_us=tail8 * 1e3,
                lm_head_argmax_us=cs.check_lm_head(bf, timer)['ms'] * 1e3)


def main() -> int:
    args = sys.argv[1:]
    mode = args[0] if args and args[0] in MODES else None
    args = args[mode is not None:]
    if len(args) == 2 and args[0] == '--one':
        print('AB ' + json.dumps(one(args[1], mode)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or not args:
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for root in args:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              *([mode] if mode else []), '--one', root],
                             capture_output=True, text=True,
                             timeout=2400 if mode == '--int8-losses' else 900)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith('AB ')]
        if out.returncode != 0 or not lines:
            print(out.stdout[-2000:], out.stderr[-2000:], file=sys.stderr)
            return 1
        print(lines[-1][3:], flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
