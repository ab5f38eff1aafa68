"""Weights carried across from the JAX package, or made on the card.

`params_from_numpy` turns the JAX param tree (as numpy arrays, e.g. from
jax.device_get) into the port's tree of tensors, keeping the paths and the
stacked `blocks` layer axis; the parity tests always go through it.

`init_params` builds a seeded tree with the same paths, shapes and init
scales as the JAX package's surgery.init_params (OPT or LLaMA) followed by
the mha_v1 and mha_v2 upgrades (for a sparse config). Its numbers differ
from JAX's (a torch.Generator, not jax.random), so it serves runs where JAX
is absent, such as chip_smoke.py on a GPU host without JAX.
"""
from __future__ import annotations

import math
from typing import Any, Union

import numpy as np
import torch

from spt_proto_tpu_torch.config import ATTN_DENSE, FFN_ROUTED, ModelConfig

PE_OFFSET = 2   # OPT's learned-position index offset


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point works on. A CUDA device must exist: the
    port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the '
            'plain PyTorch twins on the CPU')
    return dev


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def params_from_numpy(tree: Any, device='cuda') -> Any:
    """Nested dict of numpy arrays (the flax param tree) -> the same tree of
    tensors on `device`."""
    dev = resolve_device(device)
    if isinstance(tree, dict) or hasattr(tree, 'items'):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _to_tensor(tree, dev)


def _normal(g, shape, std, dtype, device):
    return torch.randn(shape, generator=g, dtype=torch.float32,
                       device=device).mul_(std).to(dtype)


def _lecun_normal(g, shape, dtype, device):
    """flax lecun_normal: truncated normal on [-2, 2], variance 1/fan_in,
    fan_in = shape[-2] (per stacked layer)."""
    std = math.sqrt(1.0 / shape[-2]) / 0.87962566103423978
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + (hi - lo) * u) - 1)
    return z.clamp_(-2, 2).mul_(std).to(dtype)


def init_params(cfg: ModelConfig, seed: int, device='cuda') -> dict:
    """Seeded param tree for `cfg` (OPT or LLaMA, MHA or GQA, dense FFN, no
    LoRA), made on `device`. LLaMA has no learned positions and no biases,
    RMSNorm scales only, and a gated FFN (gate, side, down); k and v are
    kv_heads x d_head wide. A sparse_v1/v2 config gets the PQ codebook,
    normal(1.0) of shape [L, n_sub, n_code, d_code]."""
    if cfg.ffn == FFN_ROUTED or cfg.d_lora:
        raise NotImplementedError(
            'init_params covers a dense FFN and no LoRA; routed FFN and LoRA '
            'come with the training slice')
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = cfg.param_dtype
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_feedforward, cfg.vocab_size
    opt = cfg.arch == 'opt'

    def dense(fan_in, fan_out):
        out = {'kernel': _lecun_normal(g, (L, fan_in, fan_out), dt, dev)}
        if opt:
            out['bias'] = torch.zeros((L, fan_out), dtype=dt, device=dev)
        return out

    def norm(*lead):
        out = {'scale': torch.ones((*lead, D), dtype=dt, device=dev)}
        if opt:
            out['bias'] = torch.zeros((*lead, D), dtype=dt, device=dev)
        return out

    kv = cfg.kv_heads * cfg.d_head
    mha = {'q': dense(D, D), 'k': dense(D, kv), 'v': dense(D, kv),
           'o': dense(D, D)}
    if cfg.attention != ATTN_DENSE:
        mha['quantizer'] = {'codebook': _normal(
            g, (L, cfg.n_subspaces, cfg.n_codewords, cfg.d_codeword), 1.0,
            dt, dev)}
    # draw order: q, k, v, o, codebook, embeddings, FFN, lm_head
    tree = {'embedding': {'embedding': _normal(g, (V, D), 0.02, dt, dev)}}
    if opt:
        tree['learned_pe'] = {'embedding': _normal(
            g, (cfg.max_length + PE_OFFSET, D), 0.02, dt, dev)}
    ffn = ({'gate': dense(D, F), 'side': dense(D, F), 'down': dense(F, D)}
           if cfg.ffn_gated else {'fc1': dense(D, F), 'fc2': dense(F, D)})
    tree.update({
        'blocks': {'mha': mha, 'ffn': ffn, 'norm1': norm(L), 'norm2': norm(L)},
        'final_norm': norm(),
        'lm_head': {'kernel': _lecun_normal(g, (D, V), dt, dev)},
    })
    return tree
