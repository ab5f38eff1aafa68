"""Staged model upgrades: dense -> LoRA -> routed FFN -> sparse MHA (port of
spt_proto_tpu/tuning/surgery.py).

Each stage is a ModelConfig delta plus a param-tree transform: build the
upgraded config's tree, then overlay every existing leaf onto it, so that
only the new leaves (LoRA factors, router, PQ codebook) take fresh values
and every existing one is kept bit-exact (the same tensor). The port's
`init_params` is torch-only (`inference.bridge.init_params`): the card host
has no JAX.

`split_int8_base` is the QLoRA-shape split of cfg.int8_base: the big
frozen base kernels leave the param tree for a frozen8 tree of int8 +
per-column scales.
"""
from __future__ import annotations

from typing import Any, Optional

from spt_proto_tpu_torch.config import (ATTN_DENSE, ATTN_SPARSE_V1,
                                        ATTN_SPARSE_V2, FFN_ROUTED,
                                        ModelConfig)
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference.weights import quantize_int8
from spt_proto_tpu_torch.utils.tree import flatten, overlay, unflatten

STAGES = ('lora', 'ffn', 'mha_v1', 'mha_v2')


def stage_config(cfg: ModelConfig, stage: str, *, d_lora: int = 16,
                 ffn_block_size: Optional[int] = None, d_codeword: int = 8,
                 n_codewords: int = 16) -> ModelConfig:
    """Config delta of one stage (d_codeword 8, 16 codewords, block size
    d_ff / 4 by default)."""
    if stage == 'lora':
        return cfg.replace(d_lora=d_lora)
    if stage == 'ffn':
        bs = ffn_block_size or cfg.d_feedforward // 4
        return cfg.replace(ffn=FFN_ROUTED, ffn_block_size=bs)
    if stage == 'mha_v1':
        return cfg.replace(attention=ATTN_SPARSE_V1, d_codeword=d_codeword,
                           n_codewords=n_codewords)
    if stage == 'mha_v2':
        if cfg.attention != ATTN_SPARSE_V1:
            raise ValueError('mha_v2 upgrades from mha_v1')
        return cfg.replace(attention=ATTN_SPARSE_V2)
    raise ValueError(f'unknown stage {stage!r}')


def init_params(cfg: ModelConfig, seed: int, device='cuda',
                skip=None) -> Any:
    """A seeded param tree for `cfg` on `device` (skip: see
    bridge.init_params)."""
    return bridge.init_params(cfg, seed, device, skip)


def _tree_kind(cfg: ModelConfig) -> tuple:
    """What decides the set of param paths: the arch, LoRA on or off, a
    routed FFN, and a PQ codebook (any sparse attention)."""
    return (cfg.arch, bool(cfg.d_lora), cfg.ffn == FFN_ROUTED,
            cfg.attention != ATTN_DENSE)


def flatten_paths_equal(cfg_a: ModelConfig, cfg_b: ModelConfig) -> bool:
    """True if the two configs have the same param paths (e.g. the
    mha_v1 -> mha_v2 flip adds nothing: the quantizer already exists)."""
    return _tree_kind(cfg_a) == _tree_kind(cfg_b)


def upgrade(cfg: ModelConfig, params: Any, stage: str, seed: int,
            **stage_kw) -> tuple[ModelConfig, Any]:
    """Apply one stage: (new_cfg, new_params) on the params' device."""
    new_cfg = stage_config(cfg, stage, **stage_kw)
    new_cfg.validate()
    if flatten_paths_equal(cfg, new_cfg):
        return new_cfg, params
    flat = flatten(params)
    device = next(iter(flat.values())).device
    # the existing big leaves are drawn but not kept: one tree on the device
    fresh = init_params(new_cfg, seed, device, skip=flat.__contains__)
    missing = set(flatten(params)) - set(flatten(fresh))
    if missing:
        raise KeyError(f'upgrade {stage!r} would drop params: '
                       f'{sorted(missing)[:5]}...')
    return new_cfg, overlay(fresh, params)


def full_upgrade(cfg: ModelConfig, params: Any, seed: int,
                 d_lora: int = 16, ffn_block_size: Optional[int] = None
                 ) -> tuple[ModelConfig, Any]:
    """The four stages in order; stage i draws from seed + i."""
    for i, stage in enumerate(STAGES):
        kw = {}
        if stage == 'lora':
            kw['d_lora'] = d_lora
        if stage == 'ffn':
            kw['ffn_block_size'] = ffn_block_size
        cfg, params = upgrade(cfg, params, stage, seed + i, **kw)
    return cfg, params


INT8_BASE_KERNELS = ('mha/q/kernel', 'mha/k/kernel', 'mha/v/kernel',
                     'mha/o/kernel', 'ffn/fc1/kernel', 'ffn/fc2/kernel',
                     'ffn/gate/kernel', 'ffn/side/kernel',
                     'ffn/down/kernel')


def split_int8_base(cfg: ModelConfig, params: Any,
                    staged: bool = False) -> tuple[ModelConfig, Any, Any]:
    """Move the frozen base kernels (attention q/k/v/o, the FFN matrices)
    out of the param tree into a frozen8 tree of {'q' [L, K, N_pad] int8,
    'scale' [L, 1, N] f32} at the same paths, each quantize_int8 of the
    kernel in cfg.dtype (the scale as JAX's jitted split makes it).
    Returns (cfg with int8_base=True, params without those kernels,
    frozen8). Embeddings, lm_head, norms, biases, LoRA factors, router and
    codebook stay in params.

    Each kernel is quantized on its own device, one at a time. staged=True
    also releases the fp kernel's storage right after, as the JAX
    package's donated buffers are released, so a 7B tree is never whole on
    the card beside its int8 copy. The caller's references to those
    kernels are then empty: only the returned trees stay usable."""
    keep, frozen = {}, {}
    for path, leaf in flatten(params).items():
        if not path.endswith(INT8_BASE_KERNELS):
            keep[path] = leaf
            continue
        w = leaf.to(cfg.dtype)
        frozen[path] = quantize_int8(w, jitted=True)
        if staged:
            del w
            leaf.untyped_storage().resize_(0)
    return cfg.replace(int8_base=True), unflatten(keep), unflatten(frozen)
