"""Model info CLI: trainable / frozen parameter accounting after upgrades
(port of spt_proto_tpu/cli/model_info.py).

    python -m spt_proto_tpu_torch.cli.model_info --config opt-125m \\
        --tuning sparse --serving

--tuning lora applies the LoRA stage, sparse the four stages
(surgery.full_upgrade, seed 0); the counts come from
tuning/partition.py::count_trainable. --serving adds KV-cache planning:
bytes per cached token (bf16 / int8), cache MB a sequence at --ctx, and
the sequences that fit in --hbm_gb after bf16 weights. --hbm_gb defaults
to the card's memory on CUDA (torch.cuda.get_device_properties(0)); the
JAX CLI's 16 (a v5e chip's HBM) stays the default only where no card is
asked for (--device cpu).
"""
from __future__ import annotations

import argparse
import json

from spt_proto_tpu_torch.cli.common import add_model_args, load_or_init

TPU_HBM_GB = 16.0   # the JAX CLI's default (v5e), for --device cpu


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_model_args(p)
    p.add_argument('--tuning', choices=['dense', 'lora', 'sparse'],
                   default='dense')
    p.add_argument('--d_lora', type=int, default=16)
    p.add_argument('--serving', action='store_true',
                   help='also report KV-cache memory planning: bytes per '
                        'cached token (bf16 / int8), cache bytes at '
                        '--ctx, and max concurrent sequences within '
                        '--hbm_gb after weights')
    p.add_argument('--ctx', type=int, default=2048)
    p.add_argument('--hbm_gb', type=float, default=None,
                   help='device memory budget for --serving (default: the '
                        f'card\'s memory on cuda; {TPU_HBM_GB:g}, a v5e '
                        'chip\'s, with --device cpu)')
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    import torch

    from spt_proto_tpu_torch.config import ATTN_SPARSE_V2
    from spt_proto_tpu_torch.inference.bridge import resolve_device
    from spt_proto_tpu_torch.tuning import surgery
    from spt_proto_tpu_torch.tuning.partition import count_trainable

    dev = resolve_device(args.device)
    cfg, params = load_or_init(args)
    if args.tuning == 'lora':
        cfg, params = surgery.upgrade(cfg, params, 'lora', 0,
                                      d_lora=args.d_lora)
    elif args.tuning == 'sparse':
        cfg, params = surgery.full_upgrade(cfg, params, 0,
                                           d_lora=args.d_lora)
    train, frozen = count_trainable(params)
    out = {
        'config': args.config if not args.ckpt else args.ckpt,
        'tuning': args.tuning,
        'trainable_params': train,
        'frozen_params': frozen,
        'total_params': train + frozen,
        'trainable_pct': round(100 * train / max(train + frozen, 1), 3),
    }
    if args.serving:
        hbm_gb = args.hbm_gb
        if hbm_gb is None:
            hbm_gb = (torch.cuda.get_device_properties(0).total_memory
                      / 2**30 if dev.type == 'cuda' else TPU_HBM_GB)
        # per cached token per layer: K + V columns [D] each, + PQ codes
        # (int32 x n_subspaces) when sparse; int8 adds two f32 scales
        kv_cols = 2 * cfg.d_head * cfg.kv_heads
        codes = cfg.n_subspaces * 4 * cfg.kv_heads \
            if cfg.attention == ATTN_SPARSE_V2 else 0
        per_tok_bf16 = cfg.n_layers * (kv_cols * 2 + codes)
        per_tok_int8 = cfg.n_layers * (kv_cols * 1 + codes
                                       + 2 * 4 * cfg.kv_heads)
        weights_b = (train + frozen) * 2          # bf16 serving weights
        free_b = hbm_gb * 2**30 - weights_b
        out.update({
            'kv_bytes_per_token_bf16': per_tok_bf16,
            'kv_bytes_per_token_int8': per_tok_int8,
            'cache_mb_per_seq_at_ctx': round(
                per_tok_bf16 * args.ctx / 2**20, 1),
            'cache_mb_per_seq_at_ctx_int8': round(
                per_tok_int8 * args.ctx / 2**20, 1),
            'max_seqs_at_ctx_bf16': int(free_b //
                                        (per_tok_bf16 * args.ctx)),
            'max_seqs_at_ctx_int8': int(free_b //
                                        (per_tok_int8 * args.ctx)),
            'ctx': args.ctx, 'hbm_gb': hbm_gb,
        })
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
