"""Feedforward layers: dense (OPT ReLU / LLaMA SwiGLU) and routed (port of
spt_proto_tpu/layers/feedforward.py, its single-device forms).

Storage keeps the dense layout ([d_model, d_ff] etc.) for dense and routed
FFNs alike; the routed layers take block views at call time (contiguous
d_ff slices are blocks). The routed OPT FFN dispatches on `ffn_impl` as
JAX does: 'gmm' runs the grouped-matmul forms once there are at least
GMM_MIN_ROWS rows (else the masked ones), 'gather' the capacity dispatch
(without LoRA), 'masked' the mask dispatch; the gated (LLaMA) FFN has the
masked forms only. Under cfg.int8_base the frozen kernels arrive as frozen8
leaves ({'q', 'scale'} at p[name]['kernel']) and every form is the masked
one on int8_frozen_matmul ('masked' or 'gmm' only, as JAX asserts).
`ffn_impl='ep'` (expert parallelism) and `tp_overlap` raise, naming their
slices.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from spt_proto_tpu_torch.config import ModelConfig
from spt_proto_tpu_torch.layers.common import LoRADense, dropout
from spt_proto_tpu_torch.ops import routed_ffn as rops

GMM_MIN_ROWS = 128      # JAX's gmm row tile: fewer rows run the masked form


def _activation(cfg: ModelConfig):
    return torch.relu if cfg.arch == 'opt' else F.silu


def _check_supported(cfg: ModelConfig, routed: bool) -> None:
    if cfg.tp_overlap:
        raise NotImplementedError(
            'tp_overlap (ring collective matmuls, parallel/overlap.py) comes '
            'with the overlap slice')
    if routed and cfg.ffn_impl == 'ep':
        raise NotImplementedError(
            "ffn_impl='ep' (ops/routed_ffn_ep.py) comes with the "
            'expert-parallelism slice')
    if routed and cfg.int8_base and cfg.ffn_impl not in ('masked', 'gmm'):
        raise ValueError('int8_base routed FFN uses the masked-dispatch form '
                         f"(ffn_impl 'masked' or 'gmm', got {cfg.ffn_impl!r})")


class Feedforward(nn.Module):
    """OPT fc1 -> dropout -> act -> fc2; params {'fc1', 'fc2'}."""

    def __init__(self, cfg: ModelConfig, deterministic: bool = True):
        super().__init__()
        _check_supported(cfg, routed=False)
        self.cfg, self.deterministic = cfg, deterministic
        self.dense = LoRADense(cfg.dtype, cfg.int8_base)

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
        self.dense = LoRADense(cfg.dtype, cfg.int8_base)

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
        cast = lambda t: t.to(cfg.dtype)
        b2 = cast(p['fc2']['bias'])
        act = _activation(cfg)
        top_k = cfg.ffn_active_blocks
        if cfg.int8_base:
            # the flat int8 matmuls are the block einsums (ops/routed_ffn.py)
            n, bs = cfg.n_ffn_blocks, cfg.ffn_block_size
            q1, q2 = p['fc1']['kernel'], p['fc2']['kernel']
            b1 = cast(p['fc1']['bias'].reshape(n, bs))
            if cfg.d_lora:
                r = cfg.d_lora
                y = rops.routed_ffn_lora_int8(
                    xf, probs, top_k, q1, b1, q2, b2,
                    cast(p['fc1']['lora_left']),
                    cast(p['fc1']['lora_right'].reshape(n, bs, r)),
                    cast(p['fc2']['lora_left'].reshape(n, bs, r)),
                    cast(p['fc2']['lora_right']), act)
            else:
                y = rops.routed_ffn_masked_int8(xf, probs, top_k, q1, b1, q2,
                                                b2, act)
            return y.reshape(*lead, cfg.d_model)
        v = {k: cast(t) for k, t in
             _block_views(cfg, p['fc1'], p['fc2']).items()}
        use_gmm = cfg.ffn_impl == 'gmm' and xf.shape[0] >= GMM_MIN_ROWS
        if cfg.d_lora:
            fn = rops.routed_ffn_lora_gmm if use_gmm else rops.routed_ffn_lora
            y = fn(xf, probs, top_k, v['w1'], v['b1'], v['w2'], b2,
                   v['lora_left1'], v['lora_right1'], v['lora_left2'],
                   v['lora_right2'], act)
        else:
            fn = (rops.routed_ffn_gmm if use_gmm else
                  rops.routed_ffn_gather if cfg.ffn_impl == 'gather' else
                  rops.routed_ffn_masked)
            y = fn(xf, probs, top_k, v['w1'], v['b1'], v['w2'], b2, act)
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
        act = _activation(cfg)
        top_k = cfg.ffn_top_k or max(1, n // (2 if cfg.d_lora else 4))
        r = cfg.d_lora
        lora = (lambda: (
            cast(pg['lora_left']), cast(pg['lora_right'].reshape(n, bs, r)),
            cast(ps['lora_left']), cast(ps['lora_right'].reshape(n, bs, r)),
            cast(pd['lora_left'].reshape(n, bs, r)),
            cast(pd['lora_right'])))
        if cfg.int8_base:
            kernels = (pg['kernel'], ps['kernel'], pd['kernel'])
            if cfg.d_lora:
                y = rops.routed_ffn_gated_lora_int8(xf, probs, top_k,
                                                    *kernels, *lora(), act)
            else:
                y = rops.routed_ffn_gated_masked_int8(xf, probs, top_k,
                                                      *kernels, act, n)
            return y.reshape(*lead, d)
        w_gate = cast(pg['kernel'].reshape(d, n, bs).permute(1, 0, 2))
        w_side = cast(ps['kernel'].reshape(d, n, bs).permute(1, 0, 2))
        w_down = cast(pd['kernel'].reshape(n, bs, d))
        if cfg.d_lora:
            y = rops.routed_ffn_gated_lora(xf, probs, top_k, w_gate, w_side,
                                           w_down, *lora(), act)
        else:
            y = rops.routed_ffn_gated_masked(xf, probs, top_k, w_gate,
                                             w_side, w_down, act)
        return y.reshape(*lead, d)
