"""Staged model upgrades: dense -> LoRA -> routed FFN -> sparse MHA (port of
spt_proto_tpu/tuning/surgery.py).

Each stage is a ModelConfig delta plus a param-tree transform: build the
upgraded config's tree, then overlay every existing leaf onto it, so that
only the new leaves (LoRA factors, router, PQ codebook) take fresh values
and every existing one is kept bit-exact (the same tensor). The port's
`init_params` is torch-only (`inference.bridge.init_params`): the card host
has no JAX.
"""
from __future__ import annotations

from typing import Any, Optional

from spt_proto_tpu_torch.config import (ATTN_DENSE, ATTN_SPARSE_V1,
                                        ATTN_SPARSE_V2, FFN_ROUTED,
                                        ModelConfig)
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.utils.tree import flatten, overlay

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


def init_params(cfg: ModelConfig, seed: int, device='cuda') -> Any:
    """A seeded param tree for `cfg` on `device`."""
    return bridge.init_params(cfg, seed, device)


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
    device = next(iter(flatten(params).values())).device
    fresh = init_params(new_cfg, seed, device)
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
