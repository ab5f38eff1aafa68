"""SPT fine-tuning CLI (port of spt_proto_tpu/cli/tune.py, single device).

    python -m spt_proto_tpu_torch.cli.tune --config opt-125m --steps 8 \\
        --out .data/tuned

Builds the named config's seeded random weights (`--config`, through the
port's init_params) or loads a checkpoint (`--ckpt`, the JAX package's
format), applies the upgrade stages (default lora,ffn,mha_v1,mha_v2), and
trains with AdamW (lr 1e-4, weight decay 0.1, clip 1.0) on CE + 1e-2 * the
PQ aux loss, printing a JSON line every 10 steps as the JAX CLI does. It
saves the tuned checkpoint to --out (params.npz + config.json, which the
JAX package loads), the delta against the base to --out-delta, and the
train state to --out-trainstate; the last line is {"saved", "delta_params"}.
On CUDA it attends through the kernels (attn_impl='pallas'): the
flash-attention forward, dq and dk/dv kernels at the dense stages (lora,
ffn and the mha_v1 warm-up, e.g. --stages lora,ffn,mha_v1), the
block-sparse ones once mha_v2 is applied.
--int8_base is the QLoRA shape (surgery.split_int8_base, staged): the base
q/k/v/o and FFN kernels become int8 frozen8 leaves that stay int8 through
both passes (int8_matmul forward, int8_matmul_t backward); the saved
checkpoint and delta are then the params without those kernels, with
cfg.int8_base set, as the JAX CLI saves them. Training runs in place on
the tree the CLI built (the delta's base keeps copies of the leaves it
trains), so the card holds the base weights once.

--data_root DIR trains on the MMLU + FLAN-mini mixture under DIR
(data/datamodule.py::mmlu_flan_mixture: mmlu/auxiliary_train CSVs at
weight 0.1, flan-mini/*.jsonl at 1.0, TruncPadding to --seq_length),
tokenized by the local tokenizer directory --tokenizer DIR, or by the
`tokenizer` callable (str -> list of ids) handed to main, which needs no
`transformers`. Without --data_root the batches are synthetic (numpy
seed 0): rows of --seq_length tokens, so inputs and targets are
seq_length - 1 = 512 long, the length the data path gives (the JAX CLI's
synthetic rows are one token shorter). A device mesh (--mesh_*, --fsdp,
--ep) raises, naming its slice (the training mesh's, expert
parallelism's).
"""
from __future__ import annotations

import argparse
import json

from spt_proto_tpu_torch.cli.common import (add_model_args, apply_dtype,
                                            load_or_init)
from spt_proto_tpu_torch.inference.bridge import resolve_device


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument('--data_root', type=str, default=None,
                   help='dataset tree (mmlu + flan-mini); synthetic LM '
                        'batches if omitted')
    p.add_argument('--tokenizer', type=str, default=None,
                   help='local tokenizer directory for --data_root (no '
                        'download)')
    p.add_argument('--out', type=str, required=True)
    p.add_argument('--d_lora', type=int, default=16)
    p.add_argument('--steps', type=int, default=100)
    p.add_argument('--lr', type=float, default=1e-4)
    p.add_argument('--weight_decay', type=float, default=0.1)
    p.add_argument('--seq_length', type=int, default=513)
    p.add_argument('--batch_size', type=int, default=8)
    p.add_argument('--accumulate', type=int, default=1,
                   help='gradient-accumulation micro-batches per optimizer '
                        'step; --batch_size stays the micro-batch size')
    p.add_argument('--save_every', type=int, default=500)
    p.add_argument('--resume', action='store_true',
                   help='resume from the --out-trainstate train state')
    p.add_argument('--remat', action='store_true')
    for flag in ('--mesh_data', '--mesh_model'):
        p.add_argument(flag, type=int, default=None)
    p.add_argument('--mesh_pipe', type=int, default=1)
    p.add_argument('--mesh_sp', type=int, default=1)
    p.add_argument('--fsdp', action='store_true')
    p.add_argument('--ep', action='store_true')
    p.add_argument('--int8_base', action='store_true',
                   help='QLoRA-shape: freeze the base kernels as int8 '
                        '(surgery.split_int8_base), streamed through the '
                        'fused-dequant matmul in both passes')
    p.add_argument('--stages', type=str, default='lora,ffn,mha_v1,mha_v2',
                   help='comma-separated upgrade stages to apply')
    return p


def _check_ported(args) -> None:
    if (args.mesh_data or args.mesh_model or args.mesh_pipe > 1
            or args.mesh_sp > 1 or args.fsdp or args.ep):
        raise NotImplementedError(
            'a training mesh (--mesh_*, --fsdp) comes with the training-mesh '
            'slice, --ep with the expert-parallelism slice')


def synthetic_batches(vocab_size: int, batch_size: int, seq_length: int):
    """Endless random LM batches (numpy seed 0): inputs / targets of
    seq_length - 1 tokens."""
    import numpy as np
    r = np.random.RandomState(0)
    while True:
        x = r.randint(0, vocab_size, size=(batch_size, seq_length)
                      ).astype(np.int32)
        yield {'inputs': x[:, :-1], 'targets': x[:, 1:]}


def data_tokenizer(args, tokenizer=None):
    """The tokenizer of --data_root: `tokenizer` (a callable str -> ids)
    if given, else the local directory --tokenizer."""
    if tokenizer is not None:
        return tokenizer
    if not args.tokenizer:
        raise SystemExit('--data_root needs --tokenizer DIR (a local '
                         'tokenizer directory)')
    from spt_proto_tpu_torch.data.datamodule import default_tokenizer
    return default_tokenizer(args.tokenizer)


def main(argv=None, tokenizer=None):
    """Parse argv and train; `tokenizer` (str -> list of ids) tokenizes
    --data_root in place of --tokenizer DIR."""
    args = _parser().parse_args(argv)
    _check_ported(args)

    import numpy as np

    from spt_proto_tpu_torch.tuning import surgery
    from spt_proto_tpu_torch.tuning.partition import is_trainable_path
    from spt_proto_tpu_torch.tuning.trainer import train_loop
    from spt_proto_tpu_torch.utils import checkpoint as ckpt_io
    from spt_proto_tpu_torch.utils.tree import flatten, unflatten

    dev = resolve_device(args.device)
    cfg, params = load_or_init(args)
    cfg = apply_dtype(cfg, args)
    base_params = params
    for i, stage in enumerate(s for s in args.stages.split(',') if s):
        kw = {'d_lora': args.d_lora} if stage == 'lora' else {}
        cfg, params = surgery.upgrade(cfg, params, stage, i + 1, **kw)
    if args.remat:
        cfg = cfg.replace(remat=True)
    if dev.type == 'cuda':
        cfg = cfg.replace(attn_impl='pallas')
    frozen8 = None
    if args.int8_base:
        cfg, params, frozen8 = surgery.split_int8_base(cfg, params,
                                                       staged=True)
    cfg.validate()
    # the loop trains `params` in place: keep the base's own copy of every
    # leaf it can move
    base_params = unflatten({
        k: v.detach().clone() if is_trainable_path(k) else v
        for k, v in flatten(base_params).items()})

    if args.data_root:
        from spt_proto_tpu_torch.data.datamodule import mmlu_flan_mixture
        batches = mmlu_flan_mixture(args.data_root,
                                    data_tokenizer(args, tokenizer),
                                    seq_length=args.seq_length,
                                    batch_size=args.batch_size)
    else:
        batches = synthetic_batches(cfg.vocab_size, args.batch_size,
                                    args.seq_length)
    if args.accumulate > 1:
        def accumulated(src, a):
            it = iter(src)
            while True:
                group = [next(it) for _ in range(a)]
                yield {k: np.concatenate([g[k] for g in group])
                       for k in group[0]}
        batches = accumulated(batches, args.accumulate)

    def log(i, m):
        print(json.dumps({'step': i, **{k: round(v, 5)
                                        for k, v in m.items()}}), flush=True)

    params, history = train_loop(
        cfg, params, batches, lr=args.lr, weight_decay=args.weight_decay,
        max_steps=args.steps, log_every=10, log_fn=log,
        accumulate=args.accumulate, checkpoint_dir=args.out + '-trainstate',
        checkpoint_every=args.save_every, resume=args.resume,
        frozen8=frozen8)

    ckpt_io.save_checkpoint(args.out, cfg, params)
    n = ckpt_io.save_delta_checkpoint(args.out + '-delta', cfg, base_params,
                                      params)
    print(json.dumps({'saved': args.out, 'delta_params': int(n)}))
    return params, history


if __name__ == '__main__':
    main()
