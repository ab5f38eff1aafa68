"""Feedforward layers: dense (OPT ReLU / LLaMA SwiGLU) and routed (port of
spt_proto_tpu/layers/feedforward.py, its single-device mask-dispatch forms).

Storage keeps the dense layout ([d_model, d_ff] etc.) for dense and routed
FFNs alike; the routed layers take block views at call time (contiguous
d_ff slices are blocks). `ffn_impl` 'gmm' (stock megablox gmm), 'gather'
and 'ep' (expert parallelism), `tp_overlap` and `int8_base` raise, each
naming the slice that brings it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from spt_proto_tpu_torch.config import ModelConfig
from spt_proto_tpu_torch.layers.common import (LoRADense, dropout,
                                               int8_base_unported)
from spt_proto_tpu_torch.ops import routed_ffn as rops

_UNPORTED_IMPLS = {
    'gmm': 'the grouped-matmul (megablox gmm) slice',
    'gather': 'the grouped-matmul (megablox gmm) slice',
    'ep': 'the parallelism slice (expert parallelism)',
}


def _activation(cfg: ModelConfig):
    return torch.relu if cfg.arch == 'opt' else F.silu


def _check_supported(cfg: ModelConfig, routed: bool) -> None:
    if cfg.int8_base:
        raise int8_base_unported()
    if cfg.tp_overlap:
        raise NotImplementedError(
            'tp_overlap (ring collective matmuls) comes with the parallelism '
            'slice')
    if routed and cfg.ffn_impl in _UNPORTED_IMPLS:
        raise NotImplementedError(
            f"ffn_impl={cfg.ffn_impl!r} comes with "
            f'{_UNPORTED_IMPLS[cfg.ffn_impl]}')


class Feedforward(nn.Module):
    """OPT fc1 -> dropout -> act -> fc2; params {'fc1', 'fc2'}."""

    def __init__(self, cfg: ModelConfig, deterministic: bool = True):
        super().__init__()
        _check_supported(cfg, routed=False)
        self.cfg, self.deterministic = cfg, deterministic
        self.dense = LoRADense(cfg.dtype)

    def forward(self, p: dict, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        h = self.dense(p['fc1'], x)
        if cfg.p_dropout > 0.0 and not self.deterministic:
            h = dropout(h, cfg.p_dropout, generator)
        return self.dense(p['fc2'], _activation(cfg)(h))


class GatedFeedforward(nn.Module):
    """LLaMA SwiGLU down(act(gate x) * side x), no biases."""

    def __init__(self, cfg: ModelConfig, deterministic: bool = True):
        super().__init__()
        _check_supported(cfg, routed=False)
        self.cfg = cfg
        self.dense = LoRADense(cfg.dtype)

    def forward(self, p: dict, x: torch.Tensor, generator=None):
        act = _activation(self.cfg)
        return self.dense(p['down'], act(self.dense(p['gate'], x))
                          * self.dense(p['side'], x))


def _block_views(cfg: ModelConfig, p_in: dict, p_out: dict) -> dict:
    """Dense-layout params -> routed block layout (JAX's _block_views):
    fc1 kernel [d, d_ff] -> w1 [n, d, bs]; fc2 kernel [d_ff, d] -> w2
    [n, bs, d]; fc1's LoRA right factor and fc2's left factor split along
    d_ff per block."""
    n, bs, d = cfg.n_ffn_blocks, cfg.ffn_block_size, cfg.d_model
    views = {'w1': p_in['kernel'].reshape(d, n, bs).permute(1, 0, 2),
             'w2': p_out['kernel'].reshape(n, bs, d)}
    if 'bias' in p_in:
        views['b1'] = p_in['bias'].reshape(n, bs)
    if 'lora_right' in p_in:
        r = p_in['lora_right'].shape[-1]
        views['lora_right1'] = p_in['lora_right'].reshape(n, bs, r)
        views['lora_left1'] = p_in['lora_left']
        views['lora_left2'] = p_out['lora_left'].reshape(n, bs, r)
        views['lora_right2'] = p_out['lora_right']
    return views


def _router_probs(cfg: ModelConfig, p: dict, xf: torch.Tensor):
    """sigmoid(Dense(n_blocks)) in the compute dtype; params {'router':
    {'kernel' [d, n], 'bias' [n]}}."""
    r = p['router']
    return torch.sigmoid(xf @ r['kernel'].to(cfg.dtype)
                         + r['bias'].to(cfg.dtype))


class RoutedFeedforward(nn.Module):
    """Routed block FFN (OPT fc1 / fc2) over cfg.ffn_active_blocks blocks a
    token; with LoRA the differentiable 2 * prob coeff form."""

    def __init__(self, cfg: ModelConfig, deterministic: bool = True):
        super().__init__()
        _check_supported(cfg, routed=True)
        self.cfg = cfg

    def forward(self, p: dict, x: torch.Tensor, generator=None):
        cfg = self.cfg
        lead = x.shape[:-1]
        xf = x.reshape(-1, cfg.d_model)
        probs = _router_probs(cfg, p, xf)
        v = {k: t.to(cfg.dtype) for k, t in
             _block_views(cfg, p['fc1'], p['fc2']).items()}
        b2 = p['fc2']['bias'].to(cfg.dtype)
        act = _activation(cfg)
        top_k = cfg.ffn_active_blocks
        if cfg.d_lora:
            y = rops.routed_ffn_lora(
                xf, probs, top_k, v['w1'], v['b1'], v['w2'], b2,
                v['lora_left1'], v['lora_right1'], v['lora_left2'],
                v['lora_right2'], act)
        else:
            y = rops.routed_ffn_masked(xf, probs, top_k, v['w1'], v['b1'],
                                       v['w2'], b2, act)
        return y.reshape(*lead, cfg.d_model)


class RoutedGatedFeedforward(nn.Module):
    """Routed SwiGLU FFN (LLaMA): top n_blocks // 4 blocks without LoRA,
    n_blocks // 2 with it (and the 2 * prob coeff) unless cfg.ffn_top_k,
    the reference's own split, kept."""

    def __init__(self, cfg: ModelConfig, deterministic: bool = True):
        super().__init__()
        _check_supported(cfg, routed=True)
        self.cfg = cfg

    def forward(self, p: dict, x: torch.Tensor, generator=None):
        cfg = self.cfg
        n, bs, d = cfg.n_ffn_blocks, cfg.ffn_block_size, cfg.d_model
        lead = x.shape[:-1]
        xf = x.reshape(-1, d)
        probs = _router_probs(cfg, p, xf)
        cast = lambda t: t.to(cfg.dtype)
        pg, ps, pd = p['gate'], p['side'], p['down']
        w_gate = cast(pg['kernel'].reshape(d, n, bs).permute(1, 0, 2))
        w_side = cast(ps['kernel'].reshape(d, n, bs).permute(1, 0, 2))
        w_down = cast(pd['kernel'].reshape(n, bs, d))
        act = _activation(cfg)
        if cfg.d_lora:
            r = cfg.d_lora
            y = rops.routed_ffn_gated_lora(
                xf, probs, cfg.ffn_top_k or max(1, n // 2), w_gate, w_side,
                w_down, cast(pg['lora_left']),
                cast(pg['lora_right'].reshape(n, bs, r)),
                cast(ps['lora_left']),
                cast(ps['lora_right'].reshape(n, bs, r)),
                cast(pd['lora_left'].reshape(n, bs, r)),
                cast(pd['lora_right']), act)
        else:
            y = rops.routed_ffn_gated_masked(
                xf, probs, cfg.ffn_top_k or max(1, n // 4), w_gate, w_side,
                w_down, act)
        return y.reshape(*lead, d)
