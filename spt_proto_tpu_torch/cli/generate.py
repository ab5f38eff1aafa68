"""Text generation CLI (port of spt_proto_tpu/cli/generate.py).

    python -m spt_proto_tpu_torch.cli.generate --ckpt .data/opt-125m \\
        --tokenizer .data/opt-tokenizer --prompt "The meaning of life is" \\
        --max_new_tokens 32
    python -m spt_proto_tpu_torch.cli.generate --config opt-125m \\
        --prompt_ids 2,100,200,300 --max_new_tokens 8 --device cpu

Prompts come as text with --tokenizer DIR, a local tokenizer directory
(transformers' AutoTokenizer with local_files_only, imported only then;
there is no hub default), printing `'prompt' -> 'continuation'` a line; or
as token ids with --prompt_ids (comma-separated, repeatable), printing
each prompt's generated ids as a JSON list a line. `main` returns the
generated ids of every prompt.

Three paths, as in the JAX CLI: engine.generate (greedy without an eos id
decodes through the fused lm_head argmax kernel), --speculative through
generate_speculative (n-gram drafts, or --draft_ckpt's model), and
--continuous through ContinuousBatchingEngine (--prefix_cache,
--prefill_chunk, and --speculative as the engine's k). --int8 serves int8
weights, --quantized_kv keeps an int8 KV cache; --temperature / --top_k /
--top_p sample with a torch.Generator seeded by --seed. On the card
(--device cuda, the default) every attention goes through the kernels
(attn_impl='pallas'); --device cpu runs the plain twins.

--mesh_model M (and --mesh_data N) serve tensor- and data-parallel, one
process a rank (cli/common.py mesh_from_args):

    torchrun --nproc_per_node 2 -m spt_proto_tpu_torch.cli.generate \
        --config opt-125m --prompt_ids 2,100,200 --mesh_model 2

through engine.generate and the --continuous engine, as the JAX CLI does
(--speculative without --continuous takes no mesh there either, and
raises here). Every rank builds the same weights and serves its shard;
only rank 0 prints.
"""
from __future__ import annotations

import argparse
import json
from typing import List

from spt_proto_tpu_torch.cli.common import (add_mesh_args, add_model_args,
                                            apply_dtype, load_or_init,
                                            mesh_from_args, on_card)
from spt_proto_tpu_torch.parallel.mesh import is_main_process


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_model_args(p)
    p.add_argument('--prompt', action='append', default=None,
                   help='prompt text (repeatable for a batch; needs '
                        '--tokenizer)')
    p.add_argument('--prompt_ids', action='append', default=None,
                   help='prompt token ids, comma-separated (repeatable)')
    p.add_argument('--tokenizer', type=str, default=None,
                   help='local tokenizer directory (no download)')
    p.add_argument('--max_new_tokens', type=int, default=32)
    p.add_argument('--temperature', type=float, default=0.0)
    p.add_argument('--top_k', type=int, default=None,
                   help='top-k sampling cutoff (with --temperature > 0)')
    p.add_argument('--top_p', type=float, default=None,
                   help='nucleus sampling cutoff (with --temperature > 0)')
    p.add_argument('--seed', type=int, default=0,
                   help='sampling generator seed')
    p.add_argument('--quantized_kv', action='store_true',
                   help='int8 KV cache (per-token scales)')
    p.add_argument('--int8', action='store_true',
                   help='INT8 weight-only quantized serving')
    p.add_argument('--continuous', action='store_true',
                   help='serve via the continuous batching engine')
    p.add_argument('--prefix_cache', action='store_true',
                   help='continuous engine: reuse KV of shared TILE-'
                        'aligned prompt prefixes across requests')
    p.add_argument('--prefill_chunk', type=int, default=None,
                   help='chunked prefill: split prompts longer than this '
                        'across engine steps (multiple of 128; '
                        '--continuous only)')
    p.add_argument('--speculative', action='store_true',
                   help='speculative decoding (greedy output matches plain '
                        'greedy). Drafts with --draft_ckpt if given, else '
                        'prompt-lookup (n-gram) proposals')
    p.add_argument('--draft_ckpt', type=str, default=None,
                   help='draft model checkpoint dir for --speculative')
    add_mesh_args(p)
    p.add_argument('--spec_k', type=int, default=4,
                   help='draft depth (proposed tokens per verify block)')
    return p


def _serving_cfg(cfg, args):
    cfg = apply_dtype(cfg, args)
    if on_card(args):
        cfg = cfg.replace(attn_impl='pallas')
    cfg.validate()
    return cfg


def main(argv=None) -> List[List[int]]:
    args = _parser().parse_args(argv)
    mesh = mesh_from_args(args)
    if mesh is not None and args.speculative and not args.continuous:
        raise ValueError('--speculative takes no mesh (generate_speculative '
                         'is single-device, as in the JAX CLI): add '
                         '--continuous to verify through the sharded engine')

    import torch

    from spt_proto_tpu_torch.inference.engine import generate
    from spt_proto_tpu_torch.inference.weights import InferenceWeights

    tok = None
    if args.tokenizer:
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(args.tokenizer,
                                            local_files_only=True)
    if args.prompt_ids:
        enc = [[int(t) for t in ids.split(',')] for ids in args.prompt_ids]
        prompts = None
    elif tok is not None:
        prompts = args.prompt or ['Hello world']
        enc = [tok.encode(t) for t in prompts]
    else:
        raise SystemExit('give --prompt_ids, or --tokenizer DIR with '
                         '--prompt')
    eos_id = tok.eos_token_id if tok is not None else None

    width = max(len(e) for e in enc)
    cfg, params = load_or_init(args,
                               min_length=width + args.max_new_tokens)
    cfg = _serving_cfg(cfg, args)
    iw = InferenceWeights.from_params(
        cfg, params, quant='int8' if args.int8 else None)
    dev = iw.params['embedding']['embedding'].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    batch = torch.zeros((len(enc), width), dtype=torch.int32)
    for i, e in enumerate(enc):
        batch[i, :len(e)] = torch.tensor(e)   # right-pad; lengths below
    lengths = torch.tensor([len(e) for e in enc], dtype=torch.int32)
    warps = dict(temperature=args.temperature, top_k=args.top_k,
                 top_p=args.top_p)

    stats = None
    if args.continuous:
        from spt_proto_tpu_torch.inference.batching import \
            ContinuousBatchingEngine
        eng = ContinuousBatchingEngine(
            iw, n_slots=min(8, len(enc)),
            max_len=width + args.max_new_tokens,
            temperature=args.temperature, eos_id=eos_id, seed=args.seed,
            prefill_chunk=args.prefill_chunk,
            quantized_kv=args.quantized_kv,
            speculative=args.spec_k if args.speculative else None,
            prefix_cache=args.prefix_cache, mesh=mesh)
        rids = [eng.submit(e, args.max_new_tokens) for e in enc]
        by_id = {c.request_id: c.tokens for c in eng.run_until_done()}
        outs = [list(map(int, by_id[r])) for r in rids]
    elif args.speculative:
        from spt_proto_tpu_torch.inference.speculative import \
            generate_speculative
        from spt_proto_tpu_torch.utils import checkpoint as ckpt_io
        draft = None
        if args.draft_ckpt:
            dcfg, dparams = ckpt_io.load_checkpoint(args.draft_ckpt, dev)
            draft = InferenceWeights.from_params(_serving_cfg(dcfg, args),
                                                 dparams)
        out, stats = generate_speculative(
            iw, batch, args.max_new_tokens, draft=draft, k=args.spec_k,
            eos_id=eos_id, lengths=lengths, quantized_kv=args.quantized_kv,
            generator=gen, **warps)
        outs = out[:, width:].tolist()
    else:
        out = generate(iw, batch, args.max_new_tokens, generator=gen,
                       eos_id=eos_id, lengths=lengths,
                       quantized_kv=args.quantized_kv, mesh=mesh, **warps)
        outs = out[:, width:].tolist()

    if not is_main_process():
        return outs
    for i, new in enumerate(outs):
        if prompts is None:
            print(json.dumps(new))
        else:
            print(repr(prompts[i]), '->', repr(tok.decode(new)))
    if stats is not None:
        print(f"[speculative] rounds={stats['rounds']} "
              f"acceptance={stats['acceptance']:.2f}")
    return outs


if __name__ == '__main__':
    main()
