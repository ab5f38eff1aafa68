"""Multi-head attention: dense, PQ warm-up (v1) and PQ-sparse (v2) paths
(port of spt_proto_tpu/layers/attention.py, without context parallelism).

`forward(p, x)` returns (y, pq_aux_loss). The aux loss is the PQ codebook
loss of q and k (after RoPE, flattened to [B*H, S, d_head]) when the model
trains its quantizer, else 0. The sparse path has three implementations of
one density contract (keep ~1/sparse_coeff of the causal context a query):
'ref' per-row top-k (ops.lookup + ops.sparse_attention), 'block' the plain
block-sparse attention over PQ-selected tiles, and 'pallas' the
differentiable block-sparse kernels (ops.block_sparse_attention, their
plain twins on CPU tensors). Dense and v1 attention follow JAX's rule:
under attn_impl='pallas' with S a multiple of 128 and no active dropout
they run the flash-attention kernels (ops.flash_attention: [B, H, S, d],
K/V repeated to n_heads first under GQA; the plain twins on CPU tensors),
else the plain einsum path.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn

from spt_proto_tpu_torch.config import (ATTN_SPARSE_V1, ATTN_SPARSE_V2,
                                        ModelConfig)
from spt_proto_tpu_torch.layers.common import (LoRADense, apply_rope,
                                               dropout, rope_cos_sin)
from spt_proto_tpu_torch.layers.quantizer import PQQuantizer
from spt_proto_tpu_torch.ops.block_sparse import (block_sparse_attention_ref,
                                                  pq_tile_scores,
                                                  select_tiles)
from spt_proto_tpu_torch.ops.block_sparse_attention import \
    block_sparse_attention
from spt_proto_tpu_torch.ops.flash_attention import flash_attention
from spt_proto_tpu_torch.ops.lookup import pq_topk_indices
from spt_proto_tpu_torch.ops.sparse_attention import sparse_attention


class MultiheadAttention(nn.Module):
    """params {'q', 'k', 'v', 'o'} (LoRADense subtrees) and, for sparse_v1
    and sparse_v2, {'quantizer': {'codebook'}}."""

    def __init__(self, cfg: ModelConfig, deterministic: bool = True,
                 train_quantizer: bool = False):
        super().__init__()
        if cfg.context_parallel:
            raise NotImplementedError(
                'context parallelism (ring attention) comes with the '
                'context-parallelism slice')
        self.cfg = cfg
        self.deterministic = deterministic
        self.train_quantizer = train_quantizer
        self.dense = LoRADense(cfg.dtype, cfg.int8_base)
        self.quantizer = PQQuantizer(cfg.pq_metric)

    def _dense_attn(self, q, k, v, generator):
        """[B, S, H, E] causal softmax attention: the flash kernels under
        attn_impl='pallas' at S a multiple of 128 without active dropout,
        else the plain path."""
        cfg = self.cfg
        s = q.shape[1]
        scale = cfg.d_head ** -0.5
        use_dropout = cfg.p_dropout > 0.0 and not self.deterministic
        if cfg.attn_impl == 'pallas' and s % 128 == 0 and not use_dropout:
            o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                sm_scale=scale)
            return o.transpose(1, 2)
        scores = torch.einsum('bihe,bjhe->bhij', q, k)
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=q.device).tril()
        scores = torch.where(causal, scale * scores, -torch.inf)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        if use_dropout:
            probs = dropout(probs, cfg.p_dropout, generator)
        return torch.einsum('bhij,bjhe->bihe', probs, v)

    def _aux(self, p, q, k):
        """PQ codebook loss of q and k flattened to [B*H, S, E]."""
        b, s, h, e = q.shape
        flat = lambda t: t.transpose(1, 2).reshape(b * h, s, e)
        _, lq = self.quantizer.train_loss(p['quantizer'], flat(q))
        _, lk = self.quantizer.train_loss(p['quantizer'], flat(k))
        return (lq + lk).float()

    def _sparse_attn(self, p, q, k, v):
        cfg = self.cfg
        b, s, h, e = q.shape
        scale = cfg.d_head ** -0.5
        to_flat = lambda t: t.transpose(1, 2).reshape(b * h, s, e)
        qf, kf, vf = to_flat(q), to_flat(k), to_flat(v)
        cb = p['quantizer']
        q_codes = self.quantizer.encode(cb, qf)
        k_codes = self.quantizer.encode(cb, kf)
        blk_k = 128
        blk_q = 256 if s % 256 == 0 else 128
        if cfg.attn_impl in ('block', 'pallas') and s % blk_q == 0:
            ratio = blk_q // blk_k
            n_sel = max(ratio, (s // blk_k) // cfg.sparse_coeff)
            ts = pq_tile_scores(q_codes, k_codes,
                                n_codewords=cfg.n_codewords, block_q=blk_q,
                                block_k=blk_k)
            sel = select_tiles(ts, n_sel, block_ratio=ratio)
            fn = (block_sparse_attention if cfg.attn_impl == 'pallas'
                  else block_sparse_attention_ref)
            if fn is block_sparse_attention:
                qf, kf, vf = qf.contiguous(), kf.contiguous(), vf.contiguous()
            yf = fn(qf, kf, vf, sel, block_q=blk_q, block_k=blk_k,
                    scale=scale, clamp=cfg.score_clamp)
        else:
            if cfg.attn_impl in ('block', 'pallas') and s > 1024:
                warnings.warn(
                    f'sparse attention at S={s} (not a multiple of {blk_q}) '
                    f'falls back to the per-row oracle, which materializes '
                    f'the full [S, S] PQ match matrix', stacklevel=2)
            top_k = max(1, s // cfg.sparse_coeff)
            idx = pq_topk_indices(q_codes, k_codes, top_k=top_k,
                                  n_codewords=cfg.n_codewords)
            yf = sparse_attention(qf, kf, vf, idx, scale=scale,
                                  clamp=cfg.score_clamp)
        return yf.reshape(b, h, s, e).transpose(1, 2)

    def forward(self, p: dict, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x [B, S, D] -> (y [B, S, D], pq_aux_loss scalar f32)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.dense(p['q'], x).reshape(b, s, cfg.n_heads, cfg.d_head)
        # GQA: project k / v at kv_heads, repeat per query group
        kv = lambda t: t.reshape(b, s, cfg.kv_heads, cfg.d_head) \
            .repeat_interleave(cfg.kv_groups, dim=2)
        k = kv(self.dense(p['k'], x))
        v = kv(self.dense(p['v'], x))
        if cfg.arch == 'llama':
            cos, sin = rope_cos_sin(torch.arange(s, device=x.device),
                                    cfg.d_head, base=cfg.rope_base)
            q = apply_rope(q.float(), cos, sin).to(cfg.dtype)
            k = apply_rope(k.float(), cos, sin).to(cfg.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.attention in (ATTN_SPARSE_V1, ATTN_SPARSE_V2) \
                and self.train_quantizer:
            aux = self._aux(p, q, k)
        if cfg.attention == ATTN_SPARSE_V2:
            y = self._sparse_attn(p, q, k, v)
        else:
            y = self._dense_attn(q, k, v, generator)
        return self.dense(p['o'], y.reshape(b, s, cfg.d_model)), aux
