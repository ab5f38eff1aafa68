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
