#!/usr/bin/env python3
"""Time the port's fp decode kernels from several checkouts, in turns, on
one CUDA card.

    python3 kernel_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository; each runs in a
process of its own, which builds that checkout's kernels and times, with
chip_smoke.py's Timer (cold L2, device time, bf16, OPT-125M serving
shapes): decode_front (stacked fp QKV, int8 KV), ffn_tail and
lm_head_argmax. One JSON line per checkout. Two versions are compared only
within one call, on one card, in turns.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    timer, bf = cs.Timer(), torch.bfloat16
    return dict(tree=root,
                decode_front_us=cs.check_front(bf, timer)[0]['ms'] * 1e3,
                ffn_tail_us=cs.check_ffn(bf, cs.D, cs.FF, timer)['ms'] * 1e3,
                lm_head_argmax_us=cs.check_lm_head(bf, timer)['ms'] * 1e3)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == '--one':
        print('AB ' + json.dumps(one(sys.argv[2])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--one', root], capture_output=True, text=True,
                             timeout=600)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith('AB ')]
        if out.returncode != 0 or not lines:
            print(out.stdout[-2000:], out.stderr[-2000:], file=sys.stderr)
            return 1
        print(lines[-1][3:], flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
