"""Decode-throughput benchmark: steady-state output tokens/sec (port of
spt_proto_tpu/cli/bench_serving.py).

    python -m spt_proto_tpu_torch.cli.bench_serving --config opt-125m \\
        --batch 8 --prompt_len 512 --max_len 1024 --steps 32 \\
        --mode dense sparse int8 paged --spec_k 4

Each mode prefills --batch random prompts (numpy RandomState(0),
`random_prompts`) and runs --steps greedy decode steps (decode_step, then
the argmax of its logits; paged: paged_decode_step over pages of 64
tokens): dense, sparse (sparse_v2, the weights upgraded mha_v1 -> mha_v2
when the tree has no quantizer), int8 (int8 weights) and paged. On the
card (--device cuda, the default) the models run in bf16 with
attn_impl='pallas' (every attention through the kernels) and the l2 PQ
metric; on the CPU in f32 with 'ref' and l1, as the JAX CLI does on TPU
and CPU.

Timing differs from the JAX CLI, which times one jitted lax.scan of the
steps (one dispatch): here a Python loop of the steps runs after a
prefill and a torch.cuda.synchronize(), between two CUDA events (the host
clock on the CPU), so `ms_per_step` includes the host's time to issue each
step. `compile_s` is the first (warm-up) run's seconds, prefill and
steps, with the kernels' build at first use.

--spec_k k adds `_bench_speculative`: acceptance of k-token n-gram
speculation measured end to end with the continuous batching engine on a
repetitive workload (`spec_prompts`: the RandomState(7) phrase tiled
through each prompt), and the decode and verify step costs (best of 2
timed loops of 16 steps; a verify block of k+1 columns rolled back by k).
One JSON line a mode, then the summary line, with the JAX CLI's keys.

--mesh_model M (--mesh_data N) runs each contiguous mode tensor- and
data-parallel, one process a rank under torchrun (cli/common.py): the
weights sharded on 'model', the batch's rows on 'data' when they divide;
tokens_per_s counts the whole batch, and only rank 0 prints. The paged
mode needs the contiguous cache under a mesh (the JAX CLI asserts the
same); --spec_k serves through the sharded engine and times the sharded
steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from spt_proto_tpu_torch.cli.common import (add_mesh_args, add_model_args,
                                            load_or_init, mesh_from_args,
                                            on_card)
from spt_proto_tpu_torch.parallel.mesh import is_main_process

PAGE_SIZE = 64
SPEC_PERIOD = 16
SPEC_STEPS = 16


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_model_args(p)
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--prompt_len', type=int, default=512)
    p.add_argument('--max_len', type=int, default=1024)
    p.add_argument('--steps', type=int, default=32)
    p.add_argument('--mode', nargs='+', default=['dense', 'sparse'],
                   choices=['dense', 'sparse', 'int8', 'paged'])
    add_mesh_args(p)
    p.add_argument('--spec_k', type=int, default=None,
                   help='also benchmark k-token n-gram speculative '
                        'decoding: acceptance measured end to end with the '
                        'batching engine on a repetitive workload, with the '
                        'verify / decode step costs')
    return p


def random_prompts(vocab_size: int, batch: int, prompt_len: int
                   ) -> np.ndarray:
    """The decode modes' prompts: int32 [batch, prompt_len] from numpy
    RandomState(0), tokens in [1, vocab_size)."""
    rng = np.random.RandomState(0)
    return rng.randint(1, vocab_size, size=(batch, prompt_len)
                       ).astype(np.int32)


def spec_prompts(vocab_size: int, batch: int, prompt_len: int
                 ) -> np.ndarray:
    """The speculative workload: a 16-token random phrase (numpy
    RandomState(7)), shifted by the row index, tiled through each prompt
    (mod vocab_size): int64 [batch, prompt_len]."""
    phrase = np.random.RandomState(7).randint(1, vocab_size,
                                              size=SPEC_PERIOD)
    rows = [np.tile(phrase + i, prompt_len // SPEC_PERIOD + 1)[:prompt_len]
            % vocab_size for i in range(batch)]
    return np.stack(rows).astype(np.int64)


def _sparse_params(base_cfg, params):
    """The tree upgraded mha_v1 (seed 0) -> mha_v2 (seed 1) where it has no
    PQ quantizer yet."""
    from spt_proto_tpu_torch.tuning import surgery
    if 'quantizer' in params['blocks']['mha']:
        return params
    sparse = base_cfg.replace(attention='sparse_v2')
    _, mparams = surgery.upgrade(base_cfg, params, 'mha_v1', 0)
    _, mparams = surgery.upgrade(sparse.replace(attention='sparse_v1'),
                                 mparams, 'mha_v2', 1)
    return mparams


class _Clock:
    """Elapsed ms between two marks: CUDA events on the card, the host
    clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == 'cuda'

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3


def _copy_cache(cache):
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).clone()
        for f in dataclasses.fields(cache)
        if isinstance(getattr(cache, f.name), torch.Tensor)})


def _sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def bench_mode(args, mode: str, base_cfg, params, prompts: torch.Tensor,
               mesh=None) -> dict:
    """One mode: a warm-up run (its seconds are compile_s), then a run whose
    decode loop is timed after a sync. Returns the mode's JSON record.
    mesh: the rank's shard of the weights over its rows of the batch."""
    from spt_proto_tpu_torch.inference.engine import (decode_step,
                                                      mesh_weights, new_cache,
                                                      prefill)
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    cfg, quant, mparams = base_cfg, None, params
    if mode == 'sparse':
        cfg = cfg.replace(attention='sparse_v2')
        cfg.validate()
        mparams = _sparse_params(base_cfg, params)
    elif mode == 'int8':
        quant = 'int8'
    iw = InferenceWeights.from_params(cfg, mparams, quant=quant)
    dev = prompts.device
    b = prompts.shape[0]
    clock = _Clock(dev)
    if mesh is not None:
        from spt_proto_tpu_torch.parallel.infer_sharding import data_rows
        if mode == 'paged':
            raise ValueError('--mesh_model needs contiguous cache')
        iw = mesh_weights(iw, mesh)
        prompts = prompts[data_rows(mesh, b)[0]]

    if mode == 'paged':
        from spt_proto_tpu_torch.inference.paged import (PageAllocator,
                                                         PagedKVCache,
                                                         paged_decode_step,
                                                         paged_prefill)
        n_pages = b * (args.max_len // PAGE_SIZE) + 8
        alloc = PageAllocator(n_pages, b)
        for slot in range(b):
            alloc.ensure(slot, args.max_len, PAGE_SIZE)

        def start():
            cache = PagedKVCache.create(cfg, b, n_pages, PAGE_SIZE,
                                        args.max_len, dtype=cfg.dtype,
                                        device=dev)
            pi = np.stack([alloc.table(slot, cache.page_indices.shape[1])
                           for slot in range(b)])
            cache = dataclasses.replace(cache, page_indices=torch.as_tensor(
                pi, dtype=torch.int32, device=dev))
            return paged_prefill(iw, prompts, cache)
        step = paged_decode_step
    else:
        def start():
            cache = new_cache(iw, prompts.shape[0], args.max_len)
            return prefill(iw, prompts, cache)
        step = decode_step

    def run() -> float:
        logits, cache = start()
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        del logits
        _sync(dev)
        t0 = clock.mark()
        for _ in range(args.steps):
            lg, cache = step(iw, tok, cache)
            tok = torch.argmax(lg, -1).to(torch.int32)
        return clock.ms(t0, clock.mark())

    t0 = time.perf_counter()
    run()                               # its clock waits for the device
    compile_s = time.perf_counter() - t0
    dt = run() / 1e3
    return {'tokens_per_s': round(b * args.steps / dt, 1),
            'ms_per_step': round(dt / args.steps * 1e3, 2),
            'compile_s': round(compile_s, 1)}


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    mesh = mesh_from_args(args)
    card = on_card(args)
    base_cfg, params = load_or_init(args, min_length=args.max_len)
    base_cfg = base_cfg.replace(
        dtype=torch.bfloat16 if card else torch.float32,
        attn_impl='pallas' if card else 'ref',
        pq_metric='l2' if card else 'l1')
    dev = params['embedding']['embedding'].device
    prompts = torch.as_tensor(random_prompts(
        base_cfg.vocab_size, args.batch, args.prompt_len), device=dev)

    say = is_main_process()
    results = {}
    for mode in args.mode:
        results[mode] = bench_mode(args, mode, base_cfg, params, prompts,
                                   mesh)
        if say:
            print(json.dumps({mode: results[mode]}), flush=True)

    if args.spec_k:
        results['speculative'] = _bench_speculative(args, base_cfg, params,
                                                    mesh)
        if say:
            print(json.dumps({'speculative': results['speculative']}),
                  flush=True)

    summary = {'decode_throughput': results, 'batch': args.batch,
               'prompt_len': args.prompt_len, 'max_len': args.max_len}
    if say:
        print(json.dumps(summary))
    return summary


def _bench_speculative(args, base_cfg, params, mesh=None) -> dict:
    """Speculative-decoding numbers from one run.

    1. ACCEPTANCE: the ContinuousBatchingEngine runs k-token n-gram
       speculation to completion on the repetitive workload
       (`spec_prompts`), min(64, max_len - prompt_len) new tokens a
       request. Acceptance is a model / workload property.
    2. STEP COSTS: decode_step (+ argmax) and verify_step of a k+1-column
       block (rolled back by k, so +1 token a step), each a loop of 16
       steps from a copy of one prefilled cache, after one warm-up loop,
       best of 2.
    3. tok/s = batch * (1 + acceptance * k) / t_verify_step, beside
       batch / t_decode_step from the same run.
    """
    from spt_proto_tpu_torch.inference.batching import \
        ContinuousBatchingEngine
    from spt_proto_tpu_torch.inference.engine import (decode_step,
                                                      mesh_weights, new_cache,
                                                      prefill, verify_step)
    from spt_proto_tpu_torch.inference.weights import InferenceWeights

    cfg = base_cfg.replace(attention='sparse_v2')
    cfg.validate()
    iw = InferenceWeights.from_params(cfg, _sparse_params(base_cfg, params))
    rows = slice(None)
    if mesh is not None:
        from spt_proto_tpu_torch.parallel.infer_sharding import data_rows
        iw = mesh_weights(iw, mesh)
        rows = data_rows(mesh, args.batch)[0]
    dev = params['embedding']['embedding'].device
    k = args.spec_k
    b, s0 = args.batch, args.prompt_len

    # -- 1. acceptance on a repetitive workload
    prompts = spec_prompts(cfg.vocab_size, b, s0)
    new_tokens = min(64, args.max_len - s0)
    eng = ContinuousBatchingEngine(iw, n_slots=b, max_len=args.max_len,
                                   speculative=k, mesh=mesh)
    for prompt in prompts:
        eng.submit(prompt.tolist(), max_new_tokens=new_tokens)
    eng.run_until_done()
    st = eng.spec_stats
    acc = st['accepted'] / max(1, st['proposed'])

    # -- 2. step costs at the same batch / context
    mine = torch.as_tensor(prompts, device=dev)[rows]
    cache = new_cache(iw, mine.shape[0], args.max_len)
    logits, cache = prefill(iw, mine, cache)
    tok0 = torch.argmax(logits[:, -1], -1).to(torch.int32)
    del logits
    clock = _Clock(dev)

    def dec(tok, c):
        lg, c = decode_step(iw, tok, c)
        return torch.argmax(lg, -1).to(torch.int32), c

    def ver(tok, c):
        block = tok[:, None].expand(-1, k + 1).contiguous()
        lg, c = verify_step(iw, block, c)
        c = dataclasses.replace(c, length=c.length - k)      # +1 a step
        return torch.argmax(lg[:, -1], -1).to(torch.int32), c

    def loop(fn) -> float:
        # the steps write the cache in place: each loop starts from a copy
        tok, c = tok0, _copy_cache(cache)
        _sync(dev)
        t0 = clock.mark()
        for _ in range(SPEC_STEPS):
            tok, c = fn(tok, c)
        return clock.ms(t0, clock.mark())

    def timed(fn) -> float:
        loop(fn)                                    # warm-up
        return min(loop(fn) for _ in range(2)) / 1e3 / SPEC_STEPS

    t_dec = timed(dec)
    t_ver = timed(ver)
    plain_tps = b / t_dec
    spec_tps = b * (1.0 + acc * k) / t_ver
    return {'k': k, 'acceptance': round(acc, 3),
            'plain_tokens_per_s': round(plain_tps, 1),
            'speculative_tokens_per_s': round(spec_tps, 1),
            'speedup': round(spec_tps / plain_tps, 3),
            'verify_vs_decode_step_cost': round(t_ver / t_dec, 3)}


if __name__ == '__main__':
    main()
