"""PQ-driven block-sparse attention: tile selection + plain reference
(port of spt_proto_tpu/ops/block_sparse.py).

Scores are pooled PQ match counts at (query-tile, key-tile) resolution; each
query tile keeps its top `n_sel` causal key tiles, diagonal tiles forced in.
`block_sparse_attention_ref` is the plain twin of the block-sparse forward
kernel (ops/block_sparse_attention.py).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def pq_tile_scores(q_codes: torch.Tensor, k_codes: torch.Tensor, *,
                   n_codewords: int, block_q: int, block_k: int
                   ) -> torch.Tensor:
    """q_codes/k_codes [B, S, n_sub] int32 -> scores [B, n_q_tiles,
    n_k_tiles] f32: mean over the q tile of the per-row match count
    against the k tile's code histogram."""
    b, s, n_sub = q_codes.shape
    n_qt = s // block_q
    n_kt = k_codes.shape[1] // block_k
    feat = n_sub * n_codewords
    k_oh = F.one_hot(k_codes.long(), n_codewords).float()
    hist = k_oh.reshape(b, n_kt, block_k, feat).sum(2)        # [B, nk, F]
    q_oh = F.one_hot(q_codes.long(), n_codewords).float().reshape(b, s, feat)
    row_scores = torch.einsum('bsf,bkf->bsk', q_oh, hist)
    return row_scores.reshape(b, n_qt, block_q, n_kt).mean(2)


def select_tiles(scores: torch.Tensor, n_sel: int,
                 block_ratio: int = 1) -> torch.Tensor:
    """Top-n_sel causal key tiles per query tile, diagonal tiles forced in.

    scores [B, nq, nk] -> sel [B, nq, n_sel] int32, ascending per row,
    invalid slots = -1. Ties go to the lowest tile index (lax.top_k's
    order): a stable descending sort keeps equal scores in index order,
    which torch.topk does not promise."""
    b, n_qt, n_kt = scores.shape
    r = block_ratio
    assert n_kt == n_qt * r, (n_qt, n_kt, r)
    assert n_sel >= r, (n_sel, r)
    dev = scores.device
    qt = torch.arange(n_qt, device=dev)[:, None]
    kt = torch.arange(n_kt, device=dev)[None, :]
    causal = kt <= qt * r + (r - 1)
    s = torch.where(causal, scores, -torch.inf)
    diag = (kt >= qt * r) & (kt <= qt * r + (r - 1))
    s = torch.where(diag, torch.inf, s)
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :n_sel], idx[..., :n_sel]
    idx = torch.where(vals > -torch.inf, idx, -1)
    sort_key = torch.where(idx < 0, n_kt + 1, idx)
    sorted_key = torch.sort(sort_key, dim=-1).values
    return torch.where(sorted_key <= n_kt, sorted_key, -1).to(torch.int32)


def n_selected_tiles(seq_len: int, block_k: int, sparse_coeff: int) -> int:
    """Fixed tile budget: keep ~seq/sparse_coeff keys per query row."""
    n_kt = seq_len // block_k
    return max(1, n_kt // sparse_coeff)


def block_sparse_attention_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, sel: torch.Tensor, *,
                               block_q: int, block_k: int, scale: float,
                               clamp: Optional[float] = 10.0) -> torch.Tensor:
    """Plain attention restricted to selected key tiles.

    q/k/v [B, S, D]; sel [B, nq, n_sel] int32 (from select_tiles).
    Returns [B, S, D]."""
    b, s, d = q.shape
    n_qt = s // block_q
    n_kt = k.shape[1] // block_k
    n_sel = sel.shape[-1]
    dev = q.device
    qt = q.reshape(b, n_qt, block_q, d)
    kt = k.reshape(b, n_kt, block_k, d)
    vt = v.reshape(b, n_kt, block_k, d)
    safe = sel.long().clamp(min=0)
    bi = torch.arange(b, device=dev)[:, None, None]
    k_sel = kt[bi, safe]                                  # [B,nq,n_sel,Bk,D]
    v_sel = vt[bi, safe]
    scores = torch.einsum('bqid,bqsjd->bqisj', qt.float(),
                          k_sel.float()) * scale
    if clamp is not None:
        scores = scores.clamp(-clamp, clamp)
    rows = (torch.arange(n_qt, device=dev)[:, None] * block_q
            + torch.arange(block_q, device=dev)[None, :])  # [nq, Bq]
    cols = safe[..., None] * block_k + torch.arange(block_k, device=dev)
    valid = (cols[:, :, None, :, :] <= rows[None, :, :, None, None]) & \
        (sel[:, :, None, :, None] >= 0)
    scores = torch.where(valid, scores, NEG_INF)
    flat = scores.reshape(b, n_qt, block_q, n_sel * block_k)
    flat = flat - flat.amax(-1, keepdim=True)
    e = torch.exp(flat).reshape(scores.shape)
    e = torch.where(valid, e, 0.0)
    denom = e.sum(dim=(3, 4))[..., None, None].clamp(min=1e-9)
    p = e / denom
    out = torch.einsum('bqisj,bqsjd->bqid', p.to(q.dtype), v_sel)
    return out.reshape(b, s, d)
