"""Routed block-FFN: a sigmoid router picks the top-k contiguous FFN blocks
per token (port of spt_proto_tpu/ops/routed_ffn.py).

- the `masked` forms: every block runs for every token and the result is
  gated; the LoRA forms scale the frozen path by the differentiable coeff =
  2 * prob (the gradient reaches the router). Plain einsums, as in JAX;
- the `_int8` forms (cfg.int8_base): the same math with the frozen base
  matrices int8 through int8_frozen_matmul in both passes, in the flat
  form (x @ W1_flat).reshape(t, n, bs) of the dense-layout kernels;
- the `_gmm` forms (ffn_impl='gmm'): each token's rows replicated per
  chosen block, sorted by block, through grouped matmuls (ops/gmm.py), so
  the FFN's products scale with top_k / n_blocks;
- `routed_ffn_gather`: capacity dispatch into [n, capacity] buckets, plain
  PyTorch as in JAX.

Weight layout
  w1  [n_blocks, d_model, block_size]   b1 [n_blocks, block_size]
  w2  [n_blocks, block_size, d_model]   b2 [d_model] (added once)
  gated: w_gate / w_side [n_blocks, d_model, block_size],
         w_down [n_blocks, block_size, d_model], no biases
"""
from __future__ import annotations

from typing import Callable

import warnings

import torch

from spt_proto_tpu_torch.ops.gmm import grouped_matmul
from spt_proto_tpu_torch.ops.int8_matmul import int8_frozen_matmul

Act = Callable[[torch.Tensor], torch.Tensor]


def router_gates(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """probs [T, n_blocks] -> bool gate [T, n_blocks] of the top-k blocks.
    Ties go to the lower block index (lax.top_k's order): a stable
    descending sort keeps equal probabilities in index order, which
    torch.topk does not promise."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    gates = torch.zeros(probs.shape, dtype=torch.bool, device=probs.device)
    return gates.scatter_(-1, idx[..., :top_k], True)


def routed_ffn_masked(x, probs, top_k: int, w1, b1, w2, b2,
                      activation: Act) -> torch.Tensor:
    """Exact routed FFN (OPT fc1 / act / fc2). x [T, d_model]."""
    gates = router_gates(probs, top_k).to(x.dtype)
    h = activation(torch.einsum('td,ndh->tnh', x, w1) + b1)
    return torch.einsum('tnh,nhd->td', h * gates[..., None], w2) + b2


def routed_ffn_gated_masked(x, probs, top_k: int, w_gate, w_side, w_down,
                            activation: Act) -> torch.Tensor:
    """Exact routed SwiGLU FFN (LLaMA), no biases."""
    gates = router_gates(probs, top_k).to(x.dtype)
    h = activation(torch.einsum('td,ndh->tnh', x, w_gate)) * \
        torch.einsum('td,ndh->tnh', x, w_side)
    return torch.einsum('tnh,nhd->td', h * gates[..., None], w_down)


def routed_ffn_lora(x, probs, top_k: int, w1, b1, w2, b2, lora_left1,
                    lora_right1, lora_left2, lora_right2,
                    activation: Act) -> torch.Tensor:
    """LoRA routed FFN: for each active block i, coeff = 2 prob[t, i],
    h = act(coeff (x w1_i + b1_i) + x L1 R1_i), y += coeff h w2_i +
    (h L2_i) R2, plus b2 once. The LoRA path is not coeff-scaled.
    lora_left1 [d, r], lora_right1 [n, bs, r], lora_left2 [n, bs, r],
    lora_right2 [d, r]."""
    gates = router_gates(probs, top_k).to(x.dtype)
    coeff = 2.0 * probs * gates
    base_h = torch.einsum('td,ndh->tnh', x, w1) + b1
    lora_h = torch.einsum('tr,nhr->tnh', x @ lora_left1, lora_right1)
    h = activation(coeff[..., None] * base_h + lora_h) * gates[..., None]
    y = torch.einsum('tnh,nhd->td', h * coeff[..., None], w2)
    y = y + torch.einsum('tnh,nhr->tr', h, lora_left2) @ lora_right2.T
    return y + b2


def routed_ffn_gated_lora(x, probs, top_k: int, w_gate, w_side, w_down,
                          lora_left_g, lora_right_g, lora_left_s,
                          lora_right_s, lora_left_d, lora_right_d,
                          activation: Act) -> torch.Tensor:
    """LoRA routed SwiGLU FFN: h = act(coeff x gate_i + x Lg Rg_i) *
    (coeff x side_i + x Ls Rs_i), y += coeff h down_i + (h Ld_i) Rd."""
    gates = router_gates(probs, top_k).to(x.dtype)
    coeff = 2.0 * probs * gates
    hg = coeff[..., None] * torch.einsum('td,ndh->tnh', x, w_gate) + \
        torch.einsum('tr,nhr->tnh', x @ lora_left_g, lora_right_g)
    hs = coeff[..., None] * torch.einsum('td,ndh->tnh', x, w_side) + \
        torch.einsum('tr,nhr->tnh', x @ lora_left_s, lora_right_s)
    h = activation(hg) * hs * gates[..., None]
    y = torch.einsum('tnh,nhd->td', h * coeff[..., None], w_down)
    return y + torch.einsum('tnh,nhr->tr', h, lora_left_d) @ lora_right_d.T


# ---------------------------------------------------------------------------
# grouped-matmul dispatch (ffn_impl='gmm')
# ---------------------------------------------------------------------------

def _sorted_dispatch(probs: torch.Tensor, top_k: int):
    """JAX's dispatch order: the top-k block ids a token (ties to the lower
    index), flattened, stably sorted by block. Returns (tok [m] source
    token a sorted row, e_sorted [m] its block, group_sizes [n] int32),
    all on the device (no host read)."""
    n = probs.shape[-1]
    ids = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :top_k]
    e = ids.reshape(-1)
    order = torch.argsort(e, stable=True)
    blocks = torch.arange(n, device=probs.device)
    sizes = (e[:, None] == blocks).sum(0, dtype=torch.int32)
    return order // top_k, e[order], sizes


def _combine(ys: torch.Tensor, tok: torch.Tensor, t: int) -> torch.Tensor:
    """Scatter-add the sorted rows back to their tokens."""
    return torch.zeros((t, ys.shape[-1]), dtype=ys.dtype,
                       device=ys.device).index_add_(0, tok, ys)


def routed_ffn_gmm(x, probs, top_k: int, w1, b1, w2, b2,
                   activation: Act) -> torch.Tensor:
    """Exact routed FFN on grouped matmuls (JAX's routed_ffn_gmm): rows
    replicated per chosen block, sorted by block, act(gmm(x, w1) + b1)
    then gmm(., w2), scattered back, plus b2. JAX pads the rows to its
    128-row tile (pads join the last group and land on a dummy token); the
    kernels here mask ragged tiles, so no pad rows are made: the pads only
    ever produced that dummy token's output."""
    t = x.shape[0]
    tok, e, sizes = _sorted_dispatch(probs, top_k)
    h = grouped_matmul(x[tok], w1, sizes, out_dtype=x.dtype)
    h = activation(h + b1[e])
    ys = grouped_matmul(h, w2, sizes, out_dtype=x.dtype)
    return _combine(ys, tok, t) + b2


def routed_ffn_lora_gmm(x, probs, top_k: int, w1, b1, w2, b2, lora_left1,
                        lora_right1, lora_left2, lora_right2,
                        activation: Act) -> torch.Tensor:
    """routed_ffn_lora on grouped matmuls (JAX's routed_ffn_lora_gmm): the
    per-block LoRA slices run as grouped matmuls over the same order,
    lora_right1 [n, bs, r] taken transposed in place."""
    t = x.shape[0]
    tok, e, sizes = _sorted_dispatch(probs, top_k)
    coeff = 2.0 * probs[tok, e][:, None]
    xs = x[tok]
    h = grouped_matmul(xs, w1, sizes, out_dtype=x.dtype) + b1[e]
    lora_h = grouped_matmul(xs @ lora_left1, lora_right1, sizes,
                            transpose_rhs=True, out_dtype=x.dtype)
    h = activation(coeff * h + lora_h)
    ys = coeff * grouped_matmul(h, w2, sizes, out_dtype=x.dtype)
    hl = grouped_matmul(h, lora_left2, sizes, out_dtype=x.dtype)
    ys = ys + hl @ lora_right2.T
    return _combine(ys, tok, t) + b2


# ---------------------------------------------------------------------------
# capacity-bucketed gather dispatch (ffn_impl='gather')
# ---------------------------------------------------------------------------

def capacity_dispatch(probs: torch.Tensor, top_k: int, capacity: int):
    """Gather plan: (token_idx [n, capacity] int64 into T, T = empty slot;
    slot_valid [n, capacity] bool; n_dropped, a 0-d tensor of the
    assignments past capacity)."""
    t, n = probs.shape
    dev = probs.device
    gates = router_gates(probs, top_k)
    pos = torch.cumsum(gates.long(), dim=0) - 1              # [T, n]
    keep = gates & (pos < capacity)
    n_dropped = gates.sum() - keep.sum()
    token_idx = torch.full((n, capacity + 1), t, dtype=torch.long,
                           device=dev)
    bb = torch.arange(n, device=dev)[None, :].expand(t, n)
    tt = torch.arange(t, device=dev)[:, None].expand(t, n)
    slot = torch.where(keep, pos, capacity)                  # overflow -> bin
    token_idx[bb.reshape(-1), slot.reshape(-1)] = torch.where(
        keep, tt, t).reshape(-1)
    token_idx = token_idx[:, :capacity].contiguous()
    return token_idx, token_idx < t, n_dropped


def routed_ffn_gather(x, probs, top_k: int, w1, b1, w2, b2,
                      activation: Act, *,
                      capacity_factor: float = 2.0) -> torch.Tensor:
    """Capacity-dispatch routed FFN: equal to routed_ffn_masked when no
    token overflows capacity = ceil(T top_k / n_blocks capacity_factor)
    (at least 8, at most T). An overflow drops those assignments and warns
    (the check reads one count back to the host)."""
    t, d = x.shape
    n = w1.shape[0]
    capacity = max(8, min(t, int(-(-t * top_k * capacity_factor // n))))
    token_idx, valid, n_dropped = capacity_dispatch(probs, top_k, capacity)
    dropped = int(n_dropped)
    if dropped > 0:
        warnings.warn(f'routed_ffn_gather: {dropped} token-block assignments '
                      'dropped (capacity overflow: raise capacity_factor)')
    xpad = torch.cat([x, torch.zeros((1, d), dtype=x.dtype,
                                     device=x.device)])
    xg = xpad[token_idx]                                     # [n, cap, d]
    h = activation(torch.einsum('ncd,ndh->nch', xg, w1) + b1[:, None, :])
    yg = torch.einsum('nch,nhd->ncd', h, w2)
    yg = torch.where(valid[..., None], yg, torch.zeros((), dtype=yg.dtype,
                                                        device=yg.device))
    y = torch.zeros((t + 1, d), dtype=x.dtype, device=x.device)
    y = y.index_add(0, token_idx.reshape(-1), yg.reshape(-1, d))
    return y[:t] + b2


# ---------------------------------------------------------------------------
# int8-frozen-base forms (cfg.int8_base)
# ---------------------------------------------------------------------------
# The dense-layout kernels' contiguous d_ff slices are the blocks, so
# einsum('td,ndh->tnh', x, w1) == (x @ W1_flat).reshape(t, n, bs): the
# frozen8 leaves are quantize_int8 of the original kernels, like the
# attention ones. q8 = {'q' [K, N_pad] int8, 'scale' [1, N] f32}.

def _ifm(x: torch.Tensor, q8: dict) -> torch.Tensor:
    return int8_frozen_matmul(x, q8['q'], q8['scale']).to(x.dtype)


def routed_ffn_masked_int8(x, probs, top_k: int, w1q8, b1, w2q8, b2,
                           activation: Act) -> torch.Tensor:
    """routed_ffn_masked with int8 frozen fc1 [d, d_ff] / fc2 [d_ff, d];
    b1 [n, bs]."""
    t = x.shape[0]
    n, bs = b1.shape
    gates = router_gates(probs, top_k).to(x.dtype)
    h = activation(_ifm(x, w1q8).reshape(t, n, bs) + b1)
    return _ifm((h * gates[..., None]).reshape(t, n * bs), w2q8) + b2


def routed_ffn_lora_int8(x, probs, top_k: int, w1q8, b1, w2q8, b2,
                         lora_left1, lora_right1, lora_left2, lora_right2,
                         activation: Act) -> torch.Tensor:
    """routed_ffn_lora (2 prob coeff on the frozen path) with an int8
    base."""
    t = x.shape[0]
    n, bs = b1.shape
    gates = router_gates(probs, top_k).to(x.dtype)
    coeff = 2.0 * probs * gates
    base_h = _ifm(x, w1q8).reshape(t, n, bs) + b1
    lora_h = torch.einsum('tr,nhr->tnh', x @ lora_left1, lora_right1)
    h = activation(coeff[..., None] * base_h + lora_h) * gates[..., None]
    y = _ifm((h * coeff[..., None]).reshape(t, n * bs), w2q8)
    hl = torch.einsum('tnh,nhr->tr', h, lora_left2)
    return y + hl @ lora_right2.T + b2


def routed_ffn_gated_masked_int8(x, probs, top_k: int, wgq8, wsq8, wdq8,
                                 activation: Act,
                                 n_blocks: int) -> torch.Tensor:
    """routed_ffn_gated_masked with int8 frozen gate / side / down."""
    t = x.shape[0]
    gates = router_gates(probs, top_k).to(x.dtype)
    hg = _ifm(x, wgq8).reshape(t, n_blocks, -1)
    hs = _ifm(x, wsq8).reshape(t, n_blocks, -1)
    h = activation(hg) * hs * gates[..., None]
    return _ifm(h.reshape(t, -1), wdq8)


def routed_ffn_gated_lora_int8(x, probs, top_k: int, wgq8, wsq8, wdq8,
                               lora_left_g, lora_right_g, lora_left_s,
                               lora_right_s, lora_left_d, lora_right_d,
                               activation: Act) -> torch.Tensor:
    """routed_ffn_gated_lora with int8 frozen gate / side / down."""
    t = x.shape[0]
    n = lora_right_g.shape[0]
    gates = router_gates(probs, top_k).to(x.dtype)
    coeff = 2.0 * probs * gates
    hg = coeff[..., None] * _ifm(x, wgq8).reshape(t, n, -1) + \
        torch.einsum('tr,nhr->tnh', x @ lora_left_g, lora_right_g)
    hs = coeff[..., None] * _ifm(x, wsq8).reshape(t, n, -1) + \
        torch.einsum('tr,nhr->tnh', x @ lora_left_s, lora_right_s)
    h = activation(hg) * hs * gates[..., None]
    y = _ifm((h * coeff[..., None]).reshape(t, -1), wdq8)
    return y + torch.einsum('tnh,nhr->tr', h, lora_left_d) @ lora_right_d.T
