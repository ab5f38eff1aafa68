"""Pre-norm transformer decoder block (port of
spt_proto_tpu/layers/transformer.py; OPT and LLaMA use the pre-norm form
only)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from spt_proto_tpu_torch.config import FFN_ROUTED, ModelConfig
from spt_proto_tpu_torch.layers.attention import MultiheadAttention
from spt_proto_tpu_torch.layers.common import LayerNorm, RMSNorm
from spt_proto_tpu_torch.layers.feedforward import (Feedforward,
                                                    GatedFeedforward,
                                                    RoutedFeedforward,
                                                    RoutedGatedFeedforward)


def make_norm(cfg: ModelConfig) -> nn.Module:
    """RMSNorm (LLaMA) or LayerNorm with eps 1e-5 (OPT)."""
    if cfg.arch == 'llama':
        return RMSNorm()
    return LayerNorm(cfg.dtype, eps=1e-5)


def make_ffn(cfg: ModelConfig, deterministic: bool) -> nn.Module:
    if cfg.ffn == FFN_ROUTED:
        cls = RoutedGatedFeedforward if cfg.ffn_gated else RoutedFeedforward
    else:
        cls = GatedFeedforward if cfg.ffn_gated else Feedforward
    return cls(cfg, deterministic)


class TransformerBlock(nn.Module):
    """x + mha(norm1(x)), then + ffn(norm2(.)); params {'mha', 'ffn',
    'norm1', 'norm2'} of one layer. Returns (x, the layer's aux loss)."""

    def __init__(self, cfg: ModelConfig, deterministic: bool = True,
                 train_quantizer: bool = False):
        super().__init__()
        self.mha = MultiheadAttention(cfg, deterministic, train_quantizer)
        self.ffn = make_ffn(cfg, deterministic)
        self.norm = make_norm(cfg)

    def forward(self, p: dict, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        h, aux = self.mha(p['mha'], self.norm(p['norm1'], x), generator)
        x = x + h
        return x + self.ffn(p['ffn'], self.norm(p['norm2'], x),
                            generator), aux
