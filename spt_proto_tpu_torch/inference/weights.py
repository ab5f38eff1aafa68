"""Inference weight preprocessing (port of spt_proto_tpu/inference/weights.py).

LoRA factors fold into their base weights (W' = W + left @ right.T),
floating leaves cast to the serving dtype, q/k/v fuse into one [L, 3, D, O]
stack for MHA, and the PQ codebook gains the block-diagonal encode matrices
the decode-front kernel uses. With quant='int8' the big GEMM weights become
int8 weight-only ({'q': N-padded int8, 'scale': true-width f32}), q/k/v
fused into one column-packed [L, D, 3D] kernel; the staged build makes the
same tree one leaf at a time on the target device.

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


def quantize_int8(w: torch.Tensor, pad_to: int = 256) -> dict:
    """Per-output-channel (last axis) symmetric int8: w [..., K, N] ->
    {'q': [..., K, N_pad] int8 (N zero-padded to a multiple of pad_to),
    'scale': [..., 1, N] f32 at the TRUE width}.

    The scale and the division run in w's dtype, as the JAX package's eager
    build does (in bf16 the scale is a bf16 value stored as f32; computed
    in f32 instead, q would land one step away)."""
    scale = w.abs().amax(dim=-2, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    pad = (-q.shape[-1]) % pad_to
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    return {'q': q.contiguous(), 'scale': scale.float()}


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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _cast_to(dtype, device):
    """Leaf -> on `device`, floating leaves in `dtype`, contiguous (the
    kernels read the stacked weights one layer at a time)."""
    def fn(t):
        t = t.to(device=device, dtype=dtype if t.is_floating_point()
                 else t.dtype)
        return t.contiguous()
    return fn


def _require_int8_form(cfg: ModelConfig, params: Any) -> None:
    if cfg.kv_heads != cfg.n_heads:
        raise NotImplementedError(
            'int8 weights for GQA (the triple_int8 front form) come with the '
            'LLaMA slice')
    if 'router' in params['blocks']['ffn']:
        raise NotImplementedError(
            'int8 weights with a routed FFN come with the training slice')


@dataclasses.dataclass
class InferenceWeights:
    cfg: ModelConfig
    params: Any = None   # folded param tree (blocks stacked [L, ...])
    quant: Optional[str] = None

    @staticmethod
    def from_params(cfg: ModelConfig, params: Any,
                    quant: Optional[str] = None, dtype=None,
                    staged: Optional[bool] = None,
                    device=None) -> 'InferenceWeights':
        """Build serving weights from a param tree of tensors.

        device: where the weights serve from (default: the tensors' own
        device). staged (int8 only): fold, cast and quantize one big kernel
        at a time on `device`, freeing its fp copy before the next, so the
        whole fp tree is never there at once; None means staged when the
        leaves sit on the CPU and `device` is a CUDA device."""
        if quant not in (None, 'int8'):
            raise ValueError(f'quant must be None or "int8", got {quant!r}')
        dtype = dtype or cfg.dtype
        src = next(_leaves(params)).device
        device = torch.device(device) if device is not None else src
        if quant == 'int8':
            _require_int8_form(cfg, params)
            if staged is None:
                staged = src.type == 'cpu' and device.type == 'cuda'
            if staged:
                return InferenceWeights._from_params_staged_int8(
                    cfg, params, dtype, device)
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
        if cfg.kv_heads == cfg.n_heads and quant != 'int8':
            # one fused [L, 3, D, O] projection (GQA keeps separate ones;
            # int8 fuses below as a column-packed [L, D, 3D] kernel)
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
        out = _map(_cast_to(dtype, device), out)
        _attach_pq_bd(out)
        if quant == 'int8':
            # the big per-layer GEMMs become int8 weight-only; biases,
            # norms, embeddings and the codebook stay fp. q/k/v are
            # quantized as ONE [L, D, 3D] kernel, columns [q|k|v]
            mha = out['blocks']['mha']
            qkv = {'kernel': quantize_int8(torch.cat(
                [mha[n]['kernel'] for n in ('q', 'k', 'v')], dim=-1))}
            if 'bias' in mha['q']:
                qkv['bias'] = torch.stack(
                    [mha[n]['bias'] for n in ('q', 'k', 'v')], dim=-2)
            for n in ('q', 'k', 'v'):
                del mha[n]
            mha['qkv'] = qkv
            mha['o']['kernel'] = quantize_int8(mha['o']['kernel'])
            for name in ffn_names:
                out['blocks']['ffn'][name]['kernel'] = quantize_int8(
                    out['blocks']['ffn'][name]['kernel'])
            out['lm_head']['kernel'] = quantize_int8(out['lm_head']['kernel'])
        return InferenceWeights(cfg=cfg, params=out, quant=quant)

    @staticmethod
    def _from_params_staged_int8(cfg: ModelConfig, params: Any, dtype,
                                 device) -> 'InferenceWeights':
        """The int8 build one leaf at a time: each big kernel moves to
        `device`, is folded, cast and quantized there, and its fp copy is
        dropped before the next, so the device holds the int8 tree plus one
        fp kernel. Gives the unstaged build's tree exactly."""
        small = _cast_to(dtype, device)

        def quant_dense(leaf: dict) -> dict:
            parts = {k: v.to(device) for k, v in leaf.items()
                     if k in ('kernel', 'lora_left', 'lora_right')}
            w = fold_lora(parts)['kernel'].to(dtype)     # fold, then cast
            del parts
            out = {'kernel': quantize_int8(w)}
            del w
            if 'bias' in leaf:
                out['bias'] = small(leaf['bias'])
            return out

        out: dict = {}
        out['embedding'] = _map(small, fold_lora_embed(params['embedding']))
        if cfg.arch == 'opt':
            out['learned_pe'] = _map(small,
                                     fold_lora_embed(params['learned_pe']))
        blocks = params['blocks']
        b_out: dict = {'mha': {}, 'ffn': {},
                       'norm1': _map(small, dict(blocks['norm1'])),
                       'norm2': _map(small, dict(blocks['norm2']))}
        parts = [quant_dense(blocks['mha'][n]) for n in ('q', 'k', 'v')]
        # per-column scales make the concat of separately quantized parts
        # exact: strip each part's tail padding so the [q|k|v] boundaries
        # land at D and 2D, then pad the whole to 256 again
        d = cfg.d_model
        qcat = torch.cat([p_['kernel']['q'][..., :d] for p_ in parts], dim=-1)
        qcat = torch.nn.functional.pad(qcat, (0, (-qcat.shape[-1]) % 256))
        qkv = {'kernel': {'q': qcat.contiguous(), 'scale': torch.cat(
            [p_['kernel']['scale'] for p_ in parts], dim=-1)}}
        if 'bias' in parts[0]:
            qkv['bias'] = torch.stack([p_['bias'] for p_ in parts], dim=-2)
        del parts
        b_out['mha']['o'] = quant_dense(blocks['mha']['o'])
        b_out['mha']['qkv'] = qkv
        if 'quantizer' in blocks['mha']:
            b_out['mha']['quantizer'] = _map(
                small, dict(blocks['mha']['quantizer']))
        ffn_names = ('gate', 'side', 'down') if cfg.ffn_gated \
            else ('fc1', 'fc2')
        for name in ffn_names:
            b_out['ffn'][name] = quant_dense(blocks['ffn'][name])
        out['blocks'] = b_out
        out['final_norm'] = _map(small, dict(params['final_norm']))
        out['lm_head'] = quant_dense({'kernel': params['lm_head']['kernel']})
        _attach_pq_bd(out)
        return InferenceWeights(cfg=cfg, params=out, quant='int8')
