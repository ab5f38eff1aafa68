"""Inference weight preprocessing (port of spt_proto_tpu/inference/weights.py).

LoRA factors fold into their base weights (W' = W + left @ right.T),
floating leaves cast to the serving dtype, q/k/v fuse into one [L, 3, D, O]
stack for MHA, and the PQ codebook gains the block-diagonal encode matrices
the decode-front kernel uses. This slice ports the non-staged fp path; int8
weight-only serving comes with the int8-weight slice.

Param trees are nested dicts of tensors with the flax tree's paths, the
per-layer leaves stacked on a leading [n_layers] axis under 'blocks'.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from spt_proto_tpu_torch.config import ModelConfig
from spt_proto_tpu_torch.ops.decode_front import build_pq_bd


def fold_lora(p: dict) -> dict:
    """{'kernel', 'bias'?, 'lora_left'?, 'lora_right'?} -> folded dense."""
    out = {'kernel': p['kernel']}
    if 'bias' in p:
        out['bias'] = p['bias']
    if 'lora_left' in p:
        # stacked [L, in, r] and unstacked [in, r] factors alike
        out['kernel'] = out['kernel'] + torch.einsum(
            '...ir,...or->...io', p['lora_left'], p['lora_right'])
    return out


def fold_lora_embed(p: dict) -> dict:
    out = {'embedding': p['embedding']}
    if 'lora_left' in p:
        out['embedding'] = out['embedding'] + torch.einsum(
            '...ir,...or->...io', p['lora_left'], p['lora_right'])
    return out


def _attach_pq_bd(out: dict) -> None:
    """Derive quantizer_bd [L, d_head, n_sub*n_code] and quantizer_cbn
    [L, 1, n_sub*n_code] (f32) from the already dtype-cast codebook, so the
    kernel's encode matches the plain path bit for bit."""
    mha = out.get('blocks', {}).get('mha', {})
    if 'quantizer' not in mha:
        return
    cb = mha['quantizer']['codebook']          # [L, n_sub, n_code, d_code]
    pairs = [build_pq_bd(cb[i]) for i in range(cb.shape[0])]
    mha['quantizer_bd'] = torch.stack([p[0] for p in pairs])
    mha['quantizer_cbn'] = torch.stack([p[1] for p in pairs])


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass
class InferenceWeights:
    cfg: ModelConfig
    params: Any = None   # folded param tree (blocks stacked [L, ...])
    quant: Optional[str] = None

    @staticmethod
    def from_params(cfg: ModelConfig, params: Any,
                    quant: Optional[str] = None,
                    dtype=None) -> 'InferenceWeights':
        """Build serving weights from a param tree of tensors (on the device
        they are to serve from)."""
        if quant is not None:
            raise NotImplementedError(
                'int8 weight-only serving comes with the int8-weight slice')
        dtype = dtype or cfg.dtype
        p = params
        out: dict = {}
        out['embedding'] = fold_lora_embed(p['embedding'])
        if cfg.arch == 'opt':
            out['learned_pe'] = fold_lora_embed(p['learned_pe'])
        blocks = p['blocks']
        b_out: dict = {'mha': {}, 'ffn': {}, 'norm1': dict(blocks['norm1']),
                       'norm2': dict(blocks['norm2'])}
        for name in ('q', 'k', 'v', 'o'):
            b_out['mha'][name] = fold_lora(blocks['mha'][name])
        if cfg.kv_heads == cfg.n_heads:
            # one fused [L, 3, D, O] projection (GQA keeps separate ones)
            qkv = {'kernel': torch.stack(
                [b_out['mha'][n]['kernel'] for n in ('q', 'k', 'v')], dim=-3)}
            if 'bias' in b_out['mha']['q']:
                qkv['bias'] = torch.stack(
                    [b_out['mha'][n]['bias'] for n in ('q', 'k', 'v')], dim=-2)
            for n in ('q', 'k', 'v'):
                del b_out['mha'][n]
            b_out['mha']['qkv'] = qkv
        if 'quantizer' in blocks['mha']:
            b_out['mha']['quantizer'] = dict(blocks['mha']['quantizer'])
        ffn_names = ('gate', 'side', 'down') if cfg.ffn_gated \
            else ('fc1', 'fc2')
        routed = 'router' in blocks['ffn']
        for name in ffn_names:
            if routed and cfg.d_lora:
                # routed + LoRA must not fold: training scales the base path
                # by 2 * router_prob but not the adapter
                b_out['ffn'][name] = dict(blocks['ffn'][name])
            else:
                b_out['ffn'][name] = fold_lora(blocks['ffn'][name])
        if routed:
            b_out['ffn']['router'] = dict(blocks['ffn']['router'])
        out['blocks'] = b_out
        out['final_norm'] = dict(p['final_norm'])
        out['lm_head'] = {'kernel': p['lm_head']['kernel']}
        out = _map(lambda t: t.to(dtype) if t.is_floating_point() else t, out)
        # the kernels read the stacked weights one layer at a time
        out = _map(lambda t: t.contiguous(), out)
        _attach_pq_bd(out)
        return InferenceWeights(cfg=cfg, params=out, quant=quant)
