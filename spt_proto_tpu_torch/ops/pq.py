"""Product-quantization core math (port of spt_proto_tpu/ops/pq.py).

Shapes
  z         [..., n_subspaces * d_codeword]   vectors to be coded
  codebook  [n_subspaces, n_codewords, d_codeword]
  codes     [..., n_subspaces] int32

torch.argmin returns the first minimum, the same lowest-index tie rule as
jnp.argmin.
"""
from __future__ import annotations

import torch


def pq_distances(z: torch.Tensor, codebook: torch.Tensor,
                 metric: str = 'l1') -> torch.Tensor:
    """Per-subspace distances to every codeword: [..., n_sub, n_code] f32.

    'l1' is the reference's cdist p=1; 'l2' returns SQUARED Euclidean
    distances as ||z||^2 - 2 z.c + ||c||^2."""
    n_sub, n_code, d_code = codebook.shape
    if metric == 'l2':
        zs = z.reshape(*z.shape[:-1], n_sub, d_code).float()
        cb = codebook.float()
        dots = torch.einsum('...sd,scd->...sc', zs, cb)
        z_norm = (zs * zs).sum(-1, keepdim=True)
        cb_norm = (cb * cb).sum(-1)
        return z_norm - 2.0 * dots + cb_norm
    assert metric == 'l1', metric
    zs = z.reshape(*z.shape[:-1], n_sub, 1, d_code)
    return (zs - codebook).abs().sum(-1)


def pq_encode(z: torch.Tensor, codebook: torch.Tensor,
              metric: str = 'l1') -> torch.Tensor:
    """Vectors -> int32 codes [..., n_subspaces]."""
    if metric == 'l2':
        # ||z||^2 is constant per row: only the dot and codeword norms matter
        n_sub, n_code, d_code = codebook.shape
        zs = z.reshape(*z.shape[:-1], n_sub, d_code).float()
        cb = codebook.float()
        dots = torch.einsum('...sd,scd->...sc', zs, cb)
        cb_norm = (cb * cb).sum(-1)
        return torch.argmin(cb_norm - 2.0 * dots, dim=-1).to(torch.int32)
    d = pq_distances(z, codebook, metric)
    return torch.argmin(d, dim=-1).to(torch.int32)


def pq_decode(codes: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Codes -> centroid vectors [..., n_subspaces * d_codeword]."""
    n_sub, n_code, d_code = codebook.shape
    sub = torch.arange(n_sub, device=codes.device)
    z_q = codebook[sub, codes.long()]                  # [..., n_sub, d_code]
    return z_q.reshape(*codes.shape[:-1], n_sub * d_code)


def pq_quantize(z: torch.Tensor, codebook: torch.Tensor,
                metric: str = 'l1') -> torch.Tensor:
    """Round-trip z -> nearest centroids."""
    return pq_decode(pq_encode(z, codebook, metric), codebook)


def pq_train(z: torch.Tensor, codebook: torch.Tensor,
             metric: str = 'l1') -> tuple[torch.Tensor, torch.Tensor]:
    """Training mode: (z_q, loss), loss = MSE(z_w, z_q) + MSE(z, z_q) with
    z_w the inverse-distance mix softmax(-log d) @ codebook. Distances are
    clamped at 1e-5 (and at 0 first for 'l2'); no stop-gradient: the
    gradient reaches z and the codebook. Hard centroids are a one-hot
    product (the argmin's lowest-index tie rule picks the row)."""
    n_sub, n_code, d_code = codebook.shape
    d = pq_distances(z, codebook, metric)              # [..., n_sub, n_code]
    if metric == 'l2':
        d = d.clamp(min=0.0)
    idx = torch.argmin(d, dim=-1)
    hard = torch.nn.functional.one_hot(idx, n_code).to(codebook.dtype)
    z_q_flat = torch.einsum('...sc,scd->...sd', hard, codebook)
    attn = torch.softmax(-torch.log(d.clamp(min=1e-5)), dim=-1)
    z_w = torch.einsum('...sc,scd->...sd', attn, codebook)
    zs = z.reshape(*z.shape[:-1], n_sub, d_code)
    loss = ((z_w - z_q_flat) ** 2).mean() + ((zs - z_q_flat) ** 2).mean()
    return z_q_flat.reshape(z.shape), loss
