"""Delta-checkpoint CLI: keep only the tensors that changed against the
base (port of spt_proto_tpu/cli/dump_delta.py).

    python -m spt_proto_tpu_torch.cli.dump_delta --base .data/opt-125m \\
        --tuned .data/tuned --out .data/spt-delta

Reference parity: script/8-dump-spt.py (allclose atol 1e-3 filter, fewer
than 50M parameters). Both checkpoints load onto --device (default cuda);
the delta is written in the JAX package's format.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--base', required=True)
    p.add_argument('--tuned', required=True)
    p.add_argument('--out', required=True)
    p.add_argument('--atol', type=float, default=1e-3)
    p.add_argument('--device', type=str, default='cuda')
    args = p.parse_args(argv)

    from spt_proto_tpu_torch.utils import checkpoint as ckpt_io

    _, base_params = ckpt_io.load_checkpoint(args.base, args.device)
    cfg, tuned_params = ckpt_io.load_checkpoint(args.tuned, args.device)
    n = ckpt_io.save_delta_checkpoint(args.out, cfg, base_params,
                                      tuned_params, atol=args.atol)
    out = {'out': args.out, 'delta_params': int(n)}
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
