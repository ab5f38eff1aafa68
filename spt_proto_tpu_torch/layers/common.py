"""Norms, rotary position embedding and LoRA-capable dense / embed layers
(port of spt_proto_tpu/layers/common.py).

The layers are `nn.Module`s that hold their configuration only; their
parameters arrive as the flax subtree at call time (`forward(p, x)`, as
flax's `apply` hands them in), so one layer definition serves each slice
`blocks/...[i]` of the stacked tree that `models.decoder.DecoderLM` owns.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from spt_proto_tpu_torch.ops.int8_matmul import int8_frozen_matmul


def rope_cos_sin(positions: torch.Tensor, d_head: int, *,
                 base: float = 10000.0, dtype=torch.float32):
    """NeoX-style rotary tables for integer positions [S]: cos/sin
    [S, d_head] with the half-dim frequencies concatenated twice (the HF
    LLaMA convention). The frequencies and angles are computed in f32."""
    dev = positions.device
    inv_freq = 1.0 / (base ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                            device=dev) / d_head))
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """concat([-x2, x1]) over the last axis (x1, x2 its two halves)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x [B, S, H, E] with cos/sin [S, E]:
    cos * x + sin * rotate_half(x)."""
    return cos[None, :, None, :] * x + sin[None, :, None, :] * rotate_half(x)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (flax nn.Dropout): keep with probability 1 - rate,
    scale the kept entries by 1 / (1 - rate). Draws from `generator`."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class RMSNorm(nn.Module):
    """LLaMA RMSNorm: f32 variance, eps 1e-6; params {'scale'}."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (p['scale'] * y.to(x.dtype)).to(x.dtype)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm (OPT's norm, eps 1e-5): f32 statistics with the
    fast variance E[x^2] - E[x]^2 clipped at 0, the affine in f32, the
    result in `dtype`; params {'scale', 'bias'}."""

    def __init__(self, dtype: torch.dtype, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.eps = dtype, eps

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * p['scale'].float()
        return ((xf - mu) * mul + p['bias'].float()).to(self.dtype)


class LoRADense(nn.Module):
    """Dense layer with an optional additive LoRA adapter: params
    {'kernel' [in, out], 'bias' [out], 'lora_left' [in, r], 'lora_right'
    [out, r]}; y = x W + b + (x left) right^T in `dtype`. At init `right`
    is zeros and `left` normal(1.0) (`tuning.surgery.init_params`).

    int8_base: the frozen kernel is the layer's frozen8 leaf {'q' [in,
    out_pad] int8, 'scale' [1, out] f32} (DecoderLM puts it at
    p['kernel']), applied by int8_frozen_matmul(x in `dtype`): int8 in both
    passes, no gradient for it."""

    def __init__(self, dtype: torch.dtype, int8_base: bool = False):
        super().__init__()
        self.dtype, self.int8_base = dtype, int8_base

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        if self.int8_base:
            q8 = p.get('kernel')
            if not isinstance(q8, dict):
                raise ValueError('int8_base model applied without the frozen8 '
                                 'tree (tuning.surgery.split_int8_base)')
            y = int8_frozen_matmul(x.to(self.dtype), q8['q'], q8['scale'])
        else:
            y = x @ p['kernel'].to(self.dtype)
        if 'bias' in p:
            y = y + p['bias'].to(self.dtype)
        if 'lora_left' in p:
            y = y + (x @ p['lora_left'].to(self.dtype)) @ \
                p['lora_right'].to(self.dtype).T
        return y


class LoRAEmbed(nn.Module):
    """Token embedding with an optional LoRA adapter: params {'embedding'
    [V, D], 'lora_left' [V, r], 'lora_right' [D, r]};
    y = E[ids] + left[ids] right^T."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def forward(self, p: dict, ids: torch.Tensor) -> torch.Tensor:
        y = p['embedding'][ids].to(self.dtype)
        if 'lora_left' in p:
            y = y + p['lora_left'][ids].to(self.dtype) @ \
                p['lora_right'].to(self.dtype).T
        return y
