"""Routed block-FFN: a sigmoid router picks the top-k contiguous FFN blocks
per token (port of spt_proto_tpu/ops/routed_ffn.py, its exact mask-dispatch
forms).

Every block runs for every token and the result is gated, as the JAX
package's `masked` forms do; the LoRA forms scale the frozen path by the
differentiable coeff = 2 * prob (the gradient reaches the router). They are
plain einsums in JAX too.

Weight layout
  w1  [n_blocks, d_model, block_size]   b1 [n_blocks, block_size]
  w2  [n_blocks, block_size, d_model]   b2 [d_model] (added once)
  gated: w_gate / w_side [n_blocks, d_model, block_size],
         w_down [n_blocks, block_size, d_model], no biases
"""
from __future__ import annotations

from typing import Callable

import torch

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
