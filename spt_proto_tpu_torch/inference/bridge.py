"""Weights carried across from the JAX package, or made on the card.

`params_from_numpy` turns the JAX param tree (as numpy arrays, e.g. from
jax.device_get) into the port's tree of tensors, keeping the paths and the
stacked `blocks` layer axis; the parity tests always go through it.

`params_to_numpy` is its inverse: a port tree back to numpy arrays that the
JAX package takes.

`init_params` builds a seeded tree with the same paths, shapes and init
scales as the JAX package's surgery.init_params (OPT or LLaMA; LoRA factors,
the routed FFN's router and the PQ codebook where the config has them).
Its numbers differ from JAX's (a torch.Generator, not jax.random), so it
serves runs where JAX is absent, such as chip_smoke.py and the tune CLI on
a GPU host without JAX.
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


def params_to_numpy(tree: Any) -> Any:
    """The port's tree of tensors -> the same tree of numpy arrays."""
    from spt_proto_tpu_torch.utils.tree import to_numpy
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return to_numpy(tree)


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
    """Seeded param tree for `cfg` (OPT or LLaMA, MHA or GQA), made on
    `device`. LLaMA has no learned positions and no biases, RMSNorm scales
    only, and a gated FFN (gate, side, down); k and v are kv_heads x d_head
    wide. A sparse_v1/v2 config gets the PQ codebook, normal(1.0) of shape
    [L, n_sub, n_code, d_code]. With d_lora every q/k/v/o, FFN and
    embedding leaf gets LoRA factors (left normal(1.0) [in, r], right zeros
    [out, r]); a routed FFN gets its router, a Dense(n_blocks) with a
    lecun-normal kernel and a zero bias, beside the dense-layout FFN."""
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
    # draw order: q, k, v, o, codebook, embeddings, FFN, lm_head, then the
    # LoRA left factors (q, k, v, o, FFN, embeddings) and the router, so
    # that a dense no-LoRA config draws what it always drew
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
    if cfg.d_lora:
        r = cfg.d_lora

        def lora(leaf, key):
            rows = leaf[key].shape[:-1]             # [L, in] or [V]
            leaf['lora_left'] = _normal(g, (*rows, r), 1.0, dt, dev)
            out = leaf[key].shape[-1]
            lead = rows[:-1] if key == 'kernel' else ()
            leaf['lora_right'] = torch.zeros((*lead, out, r), dtype=dt,
                                             device=dev)
        for name in ('q', 'k', 'v', 'o'):
            lora(mha[name], 'kernel')
        for leaf in ffn.values():
            lora(leaf, 'kernel')
        lora(tree['embedding'], 'embedding')
        if opt:
            lora(tree['learned_pe'], 'embedding')
    if cfg.ffn == FFN_ROUTED:
        n = cfg.n_ffn_blocks
        ffn['router'] = {
            'kernel': _lecun_normal(g, (L, D, n), dt, dev),
            'bias': torch.zeros((L, n), dtype=dt, device=dev)}
    return tree
