#!/usr/bin/env python3
"""Time the port's OPT decode kernels, or its flash-attention or
int8_matmul_t kernels, or its greedy heads and LLaMA decode steps, or
end-to-end training steps, or its grouped matmuls and the gmm tune step,
from several checkouts, in turns, on one CUDA card.

    python3 kernel_ab.py PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --flash PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --int8t PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --head PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --e2e PARENT CHANGE CHANGE PARENT
    python3 kernel_ab.py --gmm PARENT CHANGE CHANGE PARENT

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
of gmm and tgmm (kernel + reduce) a call. One JSON
line per checkout. Two versions are compared only within one call, on one
card, in turns.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

MODES = ('--flash', '--int8t', '--head', '--e2e', '--gmm')
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
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith('AB ')]
        if out.returncode != 0 or not lines:
            print(out.stdout[-2000:], out.stderr[-2000:], file=sys.stderr)
            return 1
        print(lines[-1][3:], flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
