"""HF -> native checkpoint conversion CLI (port of
spt_proto_tpu/cli/convert.py).

    python -m spt_proto_tpu_torch.cli.convert --name .data/hf/opt-125m \\
        --out .data/opt-125m

--name is a local directory holding a saved HF OPT or LLaMA model (read
with local_files_only: nothing is downloaded). The weights are remapped
(utils/convert_hf.py), and --check (the default) holds the port's
DecoderLM logits on random tokens against the HF model's: max error below
--atol, or a mean error below 0.1 (the relaxation the reference makes for
Sheared-LLaMA). On the card (--device cuda, the default) the port's model
attends through the flash-attention kernel, at 128 tokens a row; on the
CPU through the plain twins at 16. The checkpoint is written in the JAX
package's format (params.npz + config.json), which both packages load.
"""
from __future__ import annotations

import argparse

import numpy as np

from spt_proto_tpu_torch.inference.bridge import resolve_device


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--name', required=True,
                   help='local directory of an HF model (OPT or LLaMA)')
    p.add_argument('--out', required=True, help='output checkpoint dir')
    p.add_argument('--check', action='store_true', default=True)
    p.add_argument('--no-check', dest='check', action='store_false')
    p.add_argument('--atol', type=float, default=1e-3)
    p.add_argument('--device', type=str, default='cuda',
                   help='cuda (the kernels) or cpu (the plain twins)')
    return p


def main(argv=None):
    args = _parser().parse_args(argv)

    import torch
    import transformers

    from spt_proto_tpu_torch.models.decoder import DecoderLM
    from spt_proto_tpu_torch.utils import checkpoint as ckpt_io
    from spt_proto_tpu_torch.utils import convert_hf

    dev = resolve_device(args.device)
    hf = transformers.AutoModelForCausalLM.from_pretrained(
        args.name, torch_dtype=torch.float32, local_files_only=True).eval()
    cfg, params = convert_hf.convert(hf, dev)

    if args.check:
        # logits parity on random tokens (ref 1-convert.py:169-181)
        s = 128 if dev.type == 'cuda' and cfg.max_length >= 128 else 16
        tokens = np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(2, s))
        mcfg = cfg.replace(attn_impl='pallas') if dev.type == 'cuda' else cfg
        model = DecoderLM(mcfg, params, deterministic=True)
        with torch.no_grad():
            ours = model(torch.from_numpy(tokens).to(dev))['logits']
            theirs = hf(torch.from_numpy(tokens)).logits
        diff = (ours.float().cpu() - theirs).abs()
        err, mean = diff.max().item(), diff.mean().item()
        ok = err < args.atol or mean < 0.1   # Sheared-LLaMA relaxation
        print(f'[convert] parity max={err:.2e} mean={mean:.2e} '
              f'{"OK" if ok else "FAIL"}')
        if not ok:
            raise SystemExit(1)

    ckpt_io.save_checkpoint(args.out, cfg, params)
    print(f'[convert] wrote {args.out}')
    return cfg, params


if __name__ == '__main__':
    main()
