"""Rotary position tables (port of rope_cos_sin in
spt_proto_tpu/layers/common.py)."""
from __future__ import annotations

import torch


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
