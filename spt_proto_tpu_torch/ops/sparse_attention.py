"""Fixed-top-k sparse attention: gather-SDDMM + masked softmax + SpMM
(port of spt_proto_tpu/ops/sparse_attention.py, the per-row oracle).

Conventions
  q, k, v  [B, S, D]    (B = batch * heads, per-head dim D)
  idx      [B, S, K]    int32; slot valid iff idx <= row
  out      [B, S, D]

Scores are scaled, clamped to +-clamp, then soft-maxed with the row max
subtracted and the denominator clamped to >= 1e-9.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, S, D], idx [B, S, K] -> x[b, idx[b, s, j], :] as [B, S, K, D]."""
    s = x.shape[-2]
    safe = idx.long().clamp(max=s - 1)
    bi = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[bi, safe]


def sparse_sddmm(q, k, idx):
    """scores[b,s,j] = q[b,s] . k[b,idx[b,s,j]] (invalid slots unmasked)."""
    return torch.einsum('bsd,bskd->bsk', q, _gather_rows(k, idx))


def sparse_masked_softmax(scores, idx):
    """Row softmax over the K slots with causal/pad masking."""
    s = scores.shape[-2]
    row = torch.arange(s, device=scores.device)[None, :, None]
    valid = idx <= row
    masked = torch.where(valid, scores, NEG_INF)
    # the row max is a constant to autograd (JAX's stop_gradient)
    masked = masked - masked.amax(-1, keepdim=True).detach()
    e = torch.where(valid, torch.exp(masked), 0.0)
    denom = e.sum(-1, keepdim=True).clamp(min=1e-9)
    return e / denom


def sparse_spmm(probs, v, idx):
    """out[b,s] = sum_j probs[b,s,j] * v[b, idx[b,s,j]]."""
    return torch.einsum('bsk,bskd->bsd', probs, _gather_rows(v, idx))


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     idx: torch.Tensor, *, scale: float,
                     clamp: float = 10.0) -> torch.Tensor:
    """Full sparse attention pipeline (plain oracle)."""
    scores = sparse_sddmm(q, k, idx)
    scores = (scale * scores).clamp(-clamp, clamp)
    probs = sparse_masked_softmax(scores, idx)
    return sparse_spmm(probs, v, idx)
