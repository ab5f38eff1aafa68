"""HTTP serving CLI: the continuous batching engine behind /v1/completions
(port of spt_proto_tpu/cli/serve.py).

    python -m spt_proto_tpu_torch.cli.serve --config opt-125m \
        --port 8000 --n_slots 8 --max_len 2048 --paged --quantized_kv

--ckpt DIR serves a checkpoint (the JAX package's format, loaded onto
the device by cli/common.py::load_or_init), in --dtype; without it the
weights are --config's, random, made on the device from --seed by the
port's init_params. The server takes and returns token ids; --tokenizer
names a local tokenizer directory (never a hub name: it loads with
local_files_only) to accept text prompts as well. It runs on --device (default cuda, where every kernel of the
serving path runs; cpu runs the plain twins). See inference/server.py for
the threading contract.

--mesh_model M (--mesh_data N) serves tensor- and data-parallel, one
process a rank under torchrun (cli/common.py mesh_from_args):

    torchrun --nproc_per_node 2 -m spt_proto_tpu_torch.cli.serve \
        --config opt-125m --mesh_model 2

Rank 0 owns the HTTP socket and broadcasts each step's admissions; the
other ranks step the same engine (inference/server.py `follow`). The
paged cache shards its heads only; the contiguous one also its slots.
"""
from __future__ import annotations

import argparse

import torch

from spt_proto_tpu_torch.cli.common import (DTYPES, add_mesh_args,
                                            apply_dtype, load_or_init,
                                            mesh_from_args, named_config)
from spt_proto_tpu_torch.parallel.mesh import is_main_process


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--ckpt', type=str, default=None,
                   help='checkpoint directory (config.json + params.npz); '
                        'random --config weights if omitted')
    p.add_argument('--config', type=str, default='opt-125m',
                   help='opt-125m, opt-1.3b, llama-7b, llama-3-8b, ... or '
                        'tiny-opt / tiny-llama')
    p.add_argument('--dtype', type=str, default='bfloat16',
                   choices=sorted(DTYPES))
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', type=str, default='cuda')
    p.add_argument('--host', type=str, default='127.0.0.1')
    p.add_argument('--port', type=int, default=8000)
    p.add_argument('--tokenizer', type=str, default=None,
                   help='local tokenizer directory; omit to serve token ids '
                        'only')
    p.add_argument('--n_slots', type=int, default=8)
    p.add_argument('--max_len', type=int, default=1024)
    p.add_argument('--paged', action='store_true')
    p.add_argument('--page_size', type=int, default=64)
    p.add_argument('--temperature', type=float, default=0.0)
    p.add_argument('--quantized_kv', action='store_true')
    p.add_argument('--int8', action='store_true',
                   help='int8 weight-only quantized serving')
    p.add_argument('--prefix_cache', action='store_true')
    p.add_argument('--prefill_chunk', type=int, default=None)
    p.add_argument('--speculative', type=int, default=None,
                   help='k: n-gram speculative decoding per engine step')
    add_mesh_args(p)
    return p


def build_server(args, mesh=None):
    """(server, frontend) for parsed args: the model, the engine and the
    HTTP server bound to host:port (port 0 picks a free one), not yet
    serving."""
    from spt_proto_tpu_torch.inference.server import make_server
    eng, tok = build_engine(args, mesh)
    return make_server(eng, args.host, args.port, tokenizer=tok)


def build_engine(args, mesh=None):
    """(engine, tokenizer or None) for parsed args (on a mesh: the rank's
    shard)."""
    from spt_proto_tpu_torch.inference.batching import \
        ContinuousBatchingEngine
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights

    dtype = DTYPES[args.dtype]
    if args.ckpt:
        cfg, params = load_or_init(args, min_length=args.max_len)
        cfg = apply_dtype(cfg, args)
    else:
        cfg = named_config(args.config, dtype=dtype, param_dtype=dtype)
        cfg = cfg.replace(max_length=max(cfg.max_length, args.max_len))
        params = init_params(cfg, args.seed, device=args.device)
    if torch.device(args.device).type == 'cuda':
        # on the GPU the port attends only through its kernels
        cfg = cfg.replace(attn_impl='pallas')
    cfg.validate()
    iw = InferenceWeights.from_params(cfg, params,
                                      quant='int8' if args.int8 else None)
    tok = eos_id = None
    if args.tokenizer:
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(args.tokenizer,
                                            local_files_only=True)
        eos_id = tok.eos_token_id
    eng = ContinuousBatchingEngine(
        iw, n_slots=args.n_slots, max_len=args.max_len,
        temperature=args.temperature, eos_id=eos_id, paged=args.paged,
        page_size=args.page_size, seed=args.seed,
        prefill_chunk=args.prefill_chunk, quantized_kv=args.quantized_kv,
        speculative=args.speculative, prefix_cache=args.prefix_cache,
        mesh=mesh)
    return eng, tok


def main(argv=None):
    args = parser().parse_args(argv)
    mesh = mesh_from_args(args)
    if mesh is not None and not is_main_process():
        from spt_proto_tpu_torch.inference.server import follow
        follow(build_engine(args, mesh)[0])
        return
    server, frontend = build_server(args, mesh)
    print(f'serving on http://{server.server_address[0]}:'
          f'{server.server_address[1]} (POST /v1/completions)', flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        frontend.shutdown()


if __name__ == '__main__':
    main()
