"""MMLU evaluation CLI (port of spt_proto_tpu/cli/evaluate.py).

    python -m spt_proto_tpu_torch.cli.evaluate --ckpt .data/opt-125m \\
        --spt_ckpt .data/tuned-delta --data_root .data/text \\
        --tokenizer .data/opt-tokenizer --n_shots 5 --max_batches 64

Reference parity: script/3-mmlu-evaluate.py. Loads the base checkpoint
(or a named config's seeded random weights); with --spt_ckpt it upgrades
the base through the four stages (surgery.full_upgrade, seed 0) and
overlays the delta checkpoint, whose config it then takes. ppl and the
MMLU answer-position accuracy come from tuning/evaluate.py::evaluate over
data/datamodule.py::mmlu_batches (the test split, --n_shots dev examples
before each question). The tokenizer is the local directory --tokenizer,
or the `tokenizer` callable handed to main (no `transformers` then). On the
card (--device cuda, the default) a dense model attends through the
flash-attention kernel and a sparse one through the block-sparse kernel.
Prints and returns {'ppl', 'accuracy', 'n_examples'}.
"""
from __future__ import annotations

import argparse
import json

from spt_proto_tpu_torch.cli.common import (add_model_args, apply_dtype,
                                            load_or_init, on_card)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_model_args(p)
    p.add_argument('--spt_ckpt', type=str, default=None,
                   help='delta checkpoint dir to overlay (ref 8-dump-spt)')
    p.add_argument('--data_root', type=str, required=True)
    p.add_argument('--tokenizer', type=str, default=None,
                   help='local tokenizer directory (no download)')
    p.add_argument('--n_shots', type=int, default=5)
    p.add_argument('--seq_length', type=int, default=513)
    p.add_argument('--batch_size', type=int, default=8)
    p.add_argument('--max_batches', type=int, default=64)
    return p


def main(argv=None, tokenizer=None) -> dict:
    """Parse argv and evaluate; `tokenizer` (str -> list of ids) stands in
    for --tokenizer DIR."""
    args = _parser().parse_args(argv)

    from spt_proto_tpu_torch.cli.tune import data_tokenizer
    from spt_proto_tpu_torch.data.datamodule import mmlu_batches
    from spt_proto_tpu_torch.tuning import surgery
    from spt_proto_tpu_torch.tuning.evaluate import evaluate
    from spt_proto_tpu_torch.utils import checkpoint as ckpt_io

    tok = data_tokenizer(args, tokenizer)
    cfg, params = load_or_init(args)
    cfg = apply_dtype(cfg, args)
    if args.spt_ckpt:
        # upgrade the base to the SPT structure, then overlay the tuned
        # delta (ref 3-mmlu-evaluate.py:26-63)
        cfg, params = surgery.full_upgrade(cfg, params, 0)
        dev = params['embedding']['embedding'].device
        cfg_l, params = ckpt_io.load_delta_checkpoint(args.spt_ckpt, params,
                                                      dev)
        cfg = cfg_l.replace(dtype=cfg.dtype)
    if on_card(args):
        cfg = cfg.replace(attn_impl='pallas')
    cfg.validate()

    batches = mmlu_batches(args.data_root, tok, mode='test',
                           n_shots=args.n_shots,
                           seq_length=args.seq_length,
                           batch_size=args.batch_size)
    metrics = evaluate(cfg, params, batches, max_batches=args.max_batches)
    print(json.dumps(metrics))
    return metrics


if __name__ == '__main__':
    main()
