"""Profiling harness CLI (port of spt_proto_tpu/cli/profile.py).

    python -m spt_proto_tpu_torch.cli.profile --config opt-125m \\
        --tuning dense --backward --seq_length 2048 --dtype bfloat16

Builds a named config's seeded random weights (or loads --ckpt), upgrades
them (--tuning lora: the LoRA stage; sparse: the four stages), and times
one of: the teacher-forced forward (default), a train step (--backward:
dense tunes every leaf, lora and sparse the trainable leaves, sparse also
trains the PQ quantizer), or the serving decode step (--decode, after a
prefill of --seq_length tokens; --quantized_kv for an int8 cache; --spec_k
also times a speculative verify block of k + 1 columns, rolled back each
time). On the card (--device cuda, the default) every path attends
through the kernels (attn_impl='pallas'): dense and LoRA models through
flash attention, sparse ones through the block-sparse kernels, decode
through the decode kernels. One warm-up iteration, then --iters timed with
CUDA events (the host clock on the CPU, whose twins these numbers then
time); the JSON line has the JAX CLI's keys, with compile_s the warm-up's
seconds and memory from torch.cuda.memory_stats() (bytes_in_use, its peak
since the CLI started, bytes_limit the card's memory; empty on the CPU).
--trace_dir writes a torch.profiler trace of one more timed loop, and
the JSON line then holds its top device operations (`trace_top`: name,
device µs an iteration, calls an iteration; empty on the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from spt_proto_tpu_torch.cli.common import (add_model_args, apply_dtype,
                                            load_or_init)
from spt_proto_tpu_torch.inference.bridge import resolve_device


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_model_args(p)
    p.add_argument('--tuning', choices=['dense', 'lora', 'sparse'],
                   default='dense')
    p.add_argument('--seq_length', type=int, default=1024)
    p.add_argument('--batch_size', type=int, default=4)
    p.add_argument('--iters', type=int, default=10)
    p.add_argument('--backward', action='store_true')
    p.add_argument('--decode', action='store_true',
                   help='profile the serving decode step instead: prefill '
                        '--seq_length tokens, time --iters decode steps')
    p.add_argument('--quantized_kv', action='store_true',
                   help='with --decode: int8 KV cache')
    p.add_argument('--spec_k', type=int, default=None,
                   help='with --decode: also time a speculative verify '
                        'block of k proposals (k+1 columns) against '
                        'sequential decode steps')
    p.add_argument('--trace_dir', type=str, default=None,
                   help='write a torch.profiler trace here')
    return p


def _sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _seconds_per_iter(loop, n: int, dev: torch.device) -> float:
    """Device time of loop(n) / n: CUDA events on the card, the host clock
    on the CPU."""
    if dev.type == 'cuda':
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loop(n)
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / 1e3 / n
    t0 = time.perf_counter()
    loop(n)
    return (time.perf_counter() - t0) / n


def _memory(dev: torch.device) -> dict:
    if dev.type != 'cuda':
        return {}
    st = torch.cuda.memory_stats(dev)
    return {'bytes_in_use': st['allocated_bytes.all.current'],
            'peak_bytes_in_use': st['allocated_bytes.all.peak'],
            'bytes_limit': torch.cuda.get_device_properties(dev).total_memory}


def _decode_loops(cfg, params, args, dev):
    """(the decode loop, the verify-block loop or None, k + 1): one
    prefill of --seq_length random prompt tokens (numpy seed 0); each loop
    restarts from that cache's length."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    b, s, n = args.batch_size, args.seq_length, args.iters
    iw = InferenceWeights.from_params(cfg, params)
    prompts = torch.as_tensor(np.random.RandomState(0).randint(
        1, cfg.vocab_size, (b, s)), device=dev)
    cache = engine.KVCache.create(cfg, b, s + n + 2 + (args.spec_k or 0),
                                  dtype=cfg.dtype,
                                  quantized=args.quantized_kv, device=dev)
    logits, cache = engine.prefill(iw, prompts, cache)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    length = cache.length.clone()

    def decode(m):
        nonlocal cache
        cache.length.copy_(length)
        t = tok
        for _ in range(m):
            lg, cache = engine.decode_step(iw, t, cache)
            t = lg.argmax(-1).to(torch.int32)
        return t

    verify, kk = None, None
    if args.spec_k:
        kk = args.spec_k + 1
        block = tok[:, None].expand(b, kk).contiguous()

        def verify(m):
            nonlocal cache
            acc = torch.zeros((), device=dev)
            for _ in range(m):
                cache.length.copy_(length)
                lg, cache = engine.verify_step(iw, block, cache)
                acc += lg[:, -1, :8].float().sum()
            return acc
    return decode, verify, kk


def _device_top(prof, n: int, top: int = 15) -> list:
    """The `top` device operations (kernels, copies, memsets) of a finished
    profile of n iterations: [name, device µs an iteration, calls an
    iteration], the longest first."""
    from torch.autograd import DeviceType
    rows = [(a.key, a.device_time_total / n, a.count / n)
            for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return [[k[:120], round(t, 1), c] for k, t, c in rows[:top]]


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if args.decode and args.backward:
        raise ValueError('--decode and --backward are exclusive')
    from spt_proto_tpu_torch.models.decoder import DecoderLM
    from spt_proto_tpu_torch.tuning import surgery
    from spt_proto_tpu_torch.tuning.trainer import (create_train_state,
                                                    make_train_step)

    dev = resolve_device(args.device)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    # decode positions run to seq_length + the timed steps (+ a block)
    need = (args.seq_length + args.iters + 2 + (args.spec_k or 0)
            if args.decode else args.seq_length)
    cfg, params = load_or_init(args, min_length=need)
    cfg = apply_dtype(cfg, args)
    if dev.type == 'cuda':
        cfg = cfg.replace(attn_impl='pallas')
    if args.tuning == 'lora':
        cfg, params = surgery.upgrade(cfg, params, 'lora', 1)
    elif args.tuning == 'sparse':
        cfg, params = surgery.full_upgrade(cfg, params, 1)
    cfg.validate()

    b, s, n = args.batch_size, args.seq_length, args.iters
    tokens = torch.zeros((b, s), dtype=torch.int64, device=dev)
    spec = {}
    if args.decode:
        loop, verify, kk = _decode_loops(cfg, params, args, dev)
        tokens_per_iter = b
    elif args.backward:
        state = create_train_state(cfg, params,
                                   freeze_base=args.tuning != 'dense')
        step = make_train_step(cfg, train_quantizer=args.tuning == 'sparse')
        batch = {'inputs': tokens, 'targets': tokens}

        def loop(m):
            nonlocal state
            for _ in range(m):
                state, metrics = step(state, batch)
            return metrics['loss']
        tokens_per_iter = b * s
    else:
        model = DecoderLM(cfg, params)

        def loop(m):
            acc = torch.zeros((), device=dev)
            with torch.no_grad():
                for i in range(m):
                    out = model((tokens + i) % cfg.vocab_size)['logits']
                    acc += out[:, -1, :8].float().sum()
            return acc
        tokens_per_iter = b * s

    t0 = time.perf_counter()
    loop(1)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    dt = _seconds_per_iter(loop, n, dev)
    if args.decode and verify is not None:
        verify(1)
        dt_blk = _seconds_per_iter(verify, n, dev)
        spec = {'spec_k': args.spec_k,
                'spec_block_ms': round(dt_blk * 1e3, 3),
                # > 1: one verify block costs less than the k + 1 decode
                # steps it can replace (the 100%-acceptance bound)
                'spec_ceiling_speedup': round(kk * dt / dt_blk, 2)}
    mem = _memory(dev)

    traced = {}
    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == 'cuda' else [])
        with profile(activities=acts) as prof:
            loop(n)
            _sync(dev)
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, 'trace.json'))
        traced = {'trace_top': _device_top(prof, n)}

    out = {
        'config': args.config if not args.ckpt else args.ckpt,
        'tuning': args.tuning,
        'mode': 'decode' if args.decode else
                ('train_step' if args.backward else 'forward'),
        'batch': b, 'seq': s,
        'compile_s': round(compile_s, 2),
        'step_ms': round(dt * 1e3, 3),
        'tokens_per_s': round(tokens_per_iter / dt, 1),
        'memory': mem,
        'device': (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
                   else 'cpu'),
        **spec, **traced,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
