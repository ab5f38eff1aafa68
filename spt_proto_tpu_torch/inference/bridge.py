"""Weights carried across from the JAX package, or made on the card.

`params_from_numpy` turns the JAX param tree (as numpy arrays, e.g. from
jax.device_get) into the port's tree of tensors, keeping the paths and the
stacked `blocks` layer axis; the parity tests always go through it.

`params_to_numpy` is its inverse: a port tree back to numpy arrays that the
JAX package takes.

`int8_base_from_numpy` carries an int8_base split across (JAX's
split_int8_base gives (cfg8, p_small, frozen8); the int8 leaves stay int8),
`int8_base_to_numpy` is its inverse, and `config_from` makes the port's
ModelConfig from a config of the same fields.

`init_params` builds a seeded tree with the same paths, shapes and init
scales as the JAX package's surgery.init_params (OPT or LLaMA; LoRA factors,
the routed FFN's router and the PQ codebook where the config has them).
Its numbers differ from JAX's (a torch.Generator, not jax.random), so it
serves runs where JAX is absent, such as chip_smoke.py and the tune CLI on
a GPU host without JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple, Union

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
    if not a.flags.writeable:      # torch.from_numpy wants a writable array
        a = a.copy()
    if a.dtype.name == 'bfloat16':
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    # a copy in torch's own (resizable) memory
    return t.to(device, copy=True)


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


def config_from(cfg: Any) -> ModelConfig:
    """The port's ModelConfig from a config with its fields (the JAX
    package's), dtypes mapped by name."""
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    for key in ('dtype', 'param_dtype'):
        if not isinstance(kw[key], torch.dtype):
            kw[key] = getattr(torch, np.dtype(kw[key]).name)
    return ModelConfig(**kw)


def int8_base_from_numpy(cfg: Any, params: Any, frozen8: Any,
                         device='cuda') -> Tuple[ModelConfig, Any, Any]:
    """An int8_base split as numpy trees -> (port config, params, frozen8)
    on `device`; frozen8's {'q' int8, 'scale' f32} leaves keep their
    dtypes."""
    return (config_from(cfg), params_from_numpy(params, device),
            params_from_numpy(frozen8, device))


def int8_base_to_numpy(params: Any, frozen8: Any) -> Tuple[Any, Any]:
    """The port's (params, frozen8) -> numpy trees the JAX package takes."""
    return params_to_numpy(params), params_to_numpy(frozen8)


def _normal(g, shape, std, dtype, device):
    return torch.randn(shape, generator=g, dtype=torch.float32,
                       device=device).mul_(std).to(dtype)


def _lecun_normal(g, shape, dtype, device):
    """flax lecun_normal: truncated normal on [-2, 2], variance 1/fan_in,
    fan_in = shape[-2] (per stacked layer)."""
    std = math.sqrt(1.0 / shape[-2]) / 0.87962566103423978
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    # in place: one buffer of the leaf's size
    u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
    z = u.mul_(hi - lo).add_(lo).mul_(2).sub_(1).erfinv_().mul_(math.sqrt(2))
    return z.clamp_(-2, 2).mul_(std).to(dtype)


def init_params(cfg: ModelConfig, seed: int, device='cuda',
                skip: Optional[Callable[[str], bool]] = None) -> dict:
    """Seeded param tree for `cfg` (OPT or LLaMA, MHA or GQA), made on
    `device`. LLaMA has no learned positions and no biases, RMSNorm scales
    only, and a gated FFN (gate, side, down); k and v are kv_heads x d_head
    wide. A sparse_v1/v2 config gets the PQ codebook, normal(1.0) of shape
    [L, n_sub, n_code, d_code]. With d_lora every q/k/v/o, FFN and
    embedding leaf gets LoRA factors (left normal(1.0) [in, r], right zeros
    [out, r]); a routed FFN gets its router, a Dense(n_blocks) with a
    lecun-normal kernel and a zero bias, beside the dense-layout FFN.

    skip(path) True for a kernel, embedding or lm_head leaf: it is drawn
    (the later leaves keep their values) and dropped at once, a meta tensor
    of its shape in its place (surgery.upgrade overlays those)."""
    dev = resolve_device(device)
    skip = skip or (lambda path: False)

    def kept(path, t):
        return torch.empty(t.shape, dtype=t.dtype, device='meta') \
            if skip(path) else t
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = cfg.param_dtype
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_feedforward, cfg.vocab_size
    opt = cfg.arch == 'opt'

    def dense(path, fan_in, fan_out):
        out = {'kernel': kept(f'{path}/kernel', _lecun_normal(
            g, (L, fan_in, fan_out), dt, dev))}
        if opt:
            out['bias'] = torch.zeros((L, fan_out), dtype=dt, device=dev)
        return out

    def norm(*lead):
        out = {'scale': torch.ones((*lead, D), dtype=dt, device=dev)}
        if opt:
            out['bias'] = torch.zeros((*lead, D), dtype=dt, device=dev)
        return out

    kv = cfg.kv_heads * cfg.d_head
    mha = {n: dense(f'blocks/mha/{n}', D, w)
           for n, w in (('q', D), ('k', kv), ('v', kv), ('o', D))}
    if cfg.attention != ATTN_DENSE:
        mha['quantizer'] = {'codebook': _normal(
            g, (L, cfg.n_subspaces, cfg.n_codewords, cfg.d_codeword), 1.0,
            dt, dev)}
    # draw order: q, k, v, o, codebook, embeddings, FFN, lm_head, then the
    # LoRA left factors (q, k, v, o, FFN, embeddings) and the router, so
    # that a dense no-LoRA config draws what it always drew
    tree = {'embedding': {'embedding': kept(
        'embedding/embedding', _normal(g, (V, D), 0.02, dt, dev))}}
    if opt:
        tree['learned_pe'] = {'embedding': kept(
            'learned_pe/embedding',
            _normal(g, (cfg.max_length + PE_OFFSET, D), 0.02, dt, dev))}
    ffn = {n: dense(f'blocks/ffn/{n}', i, o) for n, i, o in (
        (('gate', D, F), ('side', D, F), ('down', F, D)) if cfg.ffn_gated
        else (('fc1', D, F), ('fc2', F, D)))}
    tree.update({
        'blocks': {'mha': mha, 'ffn': ffn, 'norm1': norm(L), 'norm2': norm(L)},
        'final_norm': norm(),
        'lm_head': {'kernel': kept('lm_head/kernel',
                                   _lecun_normal(g, (D, V), dt, dev))},
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
