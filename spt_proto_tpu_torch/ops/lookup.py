"""PQ-code candidate selection (port of spt_proto_tpu/ops/lookup.py).

Conventions
  codes           [..., S, n_subspaces] int32 in [0, n_codewords)
  returned idx    [..., S, top_k] int32, causally valid entries in [0, S);
                  padding slots hold the sentinel value S.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pq_match_scores(q_codes: torch.Tensor, k_codes: torch.Tensor,
                    n_codewords: int) -> torch.Tensor:
    """Matching subspace codes for every (row, col) pair: [..., S_q, S_k]
    f32 counts in [0, n_subspaces] (a one-hot inner product; exact)."""
    q_oh = F.one_hot(q_codes.long(), n_codewords).float()
    k_oh = F.one_hot(k_codes.long(), n_codewords).float()
    sq = q_oh.reshape(*q_oh.shape[:-2], -1)
    sk = k_oh.reshape(*k_oh.shape[:-2], -1)
    return torch.einsum('...ic,...jc->...ij', sq, sk)


def pq_topk_indices(q_codes: torch.Tensor, k_codes: torch.Tensor, *,
                    top_k: int, n_codewords: int) -> torch.Tensor:
    """Causal approximate-top-k candidate columns per query row.

    Non-causal columns score -1; ties break toward the lower column index
    (lax.top_k's order, kept here by a stable descending sort)."""
    s_q = q_codes.shape[-2]
    s_k = k_codes.shape[-2]
    dev = q_codes.device
    scores = pq_match_scores(q_codes, k_codes, n_codewords)
    row = torch.arange(s_q, device=dev)[:, None]
    col = torch.arange(s_k, device=dev)[None, :]
    scores = torch.where(col <= row, scores, -1.0)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :top_k], idx[..., :top_k]
    idx = torch.where(vals >= 0.0, idx, s_k)
    return idx.to(torch.int32)
