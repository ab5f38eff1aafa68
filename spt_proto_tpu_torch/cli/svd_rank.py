"""SVD rank analysis CLI: the singular-value mass of FFN weights and of
the logits on random tokens, the low-rank evidence behind the LoRA design
(port of spt_proto_tpu/cli/svd_rank.py).

    python -m spt_proto_tpu_torch.cli.svd_rank --ckpt .data/opt-125m \\
        --activations

Reference parity: script/9-svd-rank.py (the rank needed to capture 50-95%
of the singular-value mass). The weights' SVD runs in numpy on the host;
--activations runs the port's DecoderLM on --device (on the card through
the flash-attention kernel, at 2 x 128 tokens; 2 x 64 on the CPU) over
tokens drawn from a torch.Generator seeded with 0 (the JAX CLI draws them
from its own generator, so the two CLIs' activation ranks differ).
"""
from __future__ import annotations

import argparse
import json

from spt_proto_tpu_torch.cli.common import add_model_args, load_or_init

MASS_LEVELS = (0.5, 0.6, 0.7, 0.8, 0.9, 0.95)


def rank_for_mass(s, level):
    import numpy as np
    c = np.cumsum(s) / np.sum(s)
    return int(np.searchsorted(c, level) + 1)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_model_args(p)
    p.add_argument('--layers', type=int, default=2,
                   help='number of layers to analyze')
    p.add_argument('--activations', action='store_true',
                   help='also analyze hidden activations on random tokens')
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from spt_proto_tpu_torch.models.decoder import DecoderLM
    from spt_proto_tpu_torch.utils.tree import to_numpy

    cfg, params = load_or_init(args)
    results = {}
    ffn_names = ('gate', 'side', 'down') if cfg.ffn_gated else ('fc1', 'fc2')
    for name in ffn_names:
        w = to_numpy(params['blocks']['ffn'][name]['kernel']).astype(
            np.float32)
        for layer in range(min(args.layers, w.shape[0])):
            s = np.linalg.svd(w[layer], compute_uv=False)
            results[f'ffn.{name}.layer{layer}'] = {
                f'rank@{int(level*100)}%': rank_for_mass(s, level)
                for level in MASS_LEVELS}

    if args.activations:
        dev = params['embedding']['embedding'].device
        mcfg = cfg.replace(attn_impl='pallas') if dev.type == 'cuda' else cfg
        model = DecoderLM(mcfg, params, deterministic=True)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        n_tok = 128 if dev.type == 'cuda' else 64
        tokens = torch.randint(0, cfg.vocab_size, (2, n_tok), generator=g,
                               device=dev)
        with torch.no_grad():
            h = model(tokens)['logits']
        acts = h.float().reshape(-1, h.shape[-1]).cpu().numpy()
        s = np.linalg.svd(acts[:, :512], compute_uv=False)
        results['activations.logits'] = {
            f'rank@{int(level*100)}%': rank_for_mass(s, level)
            for level in MASS_LEVELS}

    print(json.dumps(results, indent=1))
    return results


if __name__ == '__main__':
    main()
