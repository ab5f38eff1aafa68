"""HuggingFace -> native checkpoint conversion for OPT and LLaMA (port of
spt_proto_tpu/utils/convert_hf.py).

Reference parity: script/1-convert.py (name-by-name state-dict remap with a
strict fully-consumed check and an output-parity test at atol 1e-3). The
native layout stacks per-layer weights along a leading [n_layers] axis, as
the port's DecoderLM and the JAX package's scanned blocks take them; the
paths are the flax paths, so the tree saves in the JAX package's checkpoint
format. Leaves are f32 tensors on the chosen device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from spt_proto_tpu_torch.config import ModelConfig
from spt_proto_tpu_torch.inference.bridge import resolve_device
from spt_proto_tpu_torch.utils.tree import unflatten


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to('cpu', torch.float32)


def _t(t: torch.Tensor) -> torch.Tensor:
    """HF Linear weight [out, in] -> the native kernel [in, out]."""
    return _f32(t).t().contiguous()


def _stack(sd: Dict[str, Any], n_layers: int, fmt: str, *,
           transpose: bool = False) -> torch.Tensor:
    take = _t if transpose else _f32
    return torch.stack([take(sd.pop(fmt.format(i=i)))
                        for i in range(n_layers)])


def convert_opt(hf_model, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """OPTForCausalLM -> flat native params (ref script/1-convert.py:9-77)."""
    sd = dict(hf_model.state_dict())
    n = cfg.n_layers
    flat: Dict[str, torch.Tensor] = {}
    flat['embedding/embedding'] = _f32(sd.pop(
        'model.decoder.embed_tokens.weight'))
    flat['learned_pe/embedding'] = _f32(sd.pop(
        'model.decoder.embed_positions.weight'))
    pre = 'model.decoder.layers.{i}.'
    for ours, theirs in (('q', 'self_attn.q_proj'), ('k', 'self_attn.k_proj'),
                         ('v', 'self_attn.v_proj'),
                         ('o', 'self_attn.out_proj')):
        flat[f'blocks/mha/{ours}/kernel'] = _stack(
            sd, n, pre + theirs + '.weight', transpose=True)
        flat[f'blocks/mha/{ours}/bias'] = _stack(
            sd, n, pre + theirs + '.bias')
    for ours, theirs in (('norm1', 'self_attn_layer_norm'),
                         ('norm2', 'final_layer_norm')):
        flat[f'blocks/{ours}/scale'] = _stack(sd, n, pre + theirs + '.weight')
        flat[f'blocks/{ours}/bias'] = _stack(sd, n, pre + theirs + '.bias')
    for fc in ('fc1', 'fc2'):
        flat[f'blocks/ffn/{fc}/kernel'] = _stack(
            sd, n, pre + fc + '.weight', transpose=True)
        flat[f'blocks/ffn/{fc}/bias'] = _stack(sd, n, pre + fc + '.bias')
    flat['final_norm/scale'] = _f32(sd.pop(
        'model.decoder.final_layer_norm.weight'))
    flat['final_norm/bias'] = _f32(sd.pop(
        'model.decoder.final_layer_norm.bias'))
    flat['lm_head/kernel'] = _t(sd.pop('lm_head.weight'))
    _check_consumed(sd)
    return flat


def convert_llama(hf_model, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """LlamaForCausalLM -> flat native params (ref
    script/1-convert.py:81-133). HF LLaMA uses the same rotate-half RoPE
    convention as the port's layers, so projections copy over without
    permutation."""
    sd = dict(hf_model.state_dict())
    n = cfg.n_layers
    flat: Dict[str, torch.Tensor] = {}
    flat['embedding/embedding'] = _f32(sd.pop('model.embed_tokens.weight'))
    pre = 'model.layers.{i}.'
    for ours, theirs in (('q', 'self_attn.q_proj'), ('k', 'self_attn.k_proj'),
                         ('v', 'self_attn.v_proj'),
                         ('o', 'self_attn.o_proj')):
        flat[f'blocks/mha/{ours}/kernel'] = _stack(
            sd, n, pre + theirs + '.weight', transpose=True)
    flat['blocks/norm1/scale'] = _stack(
        sd, n, pre + 'input_layernorm.weight')
    flat['blocks/norm2/scale'] = _stack(
        sd, n, pre + 'post_attention_layernorm.weight')
    for ours, theirs in (('gate', 'gate_proj'), ('side', 'up_proj'),
                         ('down', 'down_proj')):
        flat[f'blocks/ffn/{ours}/kernel'] = _stack(
            sd, n, pre + 'mlp.' + theirs + '.weight', transpose=True)
    flat['final_norm/scale'] = _f32(sd.pop('model.norm.weight'))
    # tied-embedding checkpoints (tie_word_embeddings=True) may list
    # lm_head as the embedding itself; the projection is its transpose
    head = sd.pop('lm_head.weight', None)
    flat['lm_head/kernel'] = _t(head) if head is not None else \
        flat['embedding/embedding'].t().contiguous()
    _check_consumed(sd)
    return flat


def _check_consumed(sd: Dict[str, Any]) -> None:
    """Strict fully-consumed check (ref 1-convert.py:77). Rotary inv_freq
    buffers are permitted leftovers."""
    leftovers = [k for k in sd
                 if 'rotary_emb' not in k and 'inv_freq' not in k]
    if leftovers:
        raise KeyError(f'unconsumed HF weights: {leftovers}')


def config_from_hf(hf_config) -> ModelConfig:
    """A ModelConfig from an HF config object (ref 1-convert.py:155-164).
    p_dropout is 0.0 whatever the checkpoint says, as in the JAX package:
    dropout inside attention would force the S x S path, and the kernels
    have no in-kernel RNG; cfg.replace(p_dropout=...) opts back in."""
    mt = hf_config.model_type
    if mt == 'opt':
        return ModelConfig(
            arch='opt', d_model=hf_config.hidden_size,
            n_heads=hf_config.num_attention_heads,
            n_layers=hf_config.num_hidden_layers,
            max_length=hf_config.max_position_embeddings,
            vocab_size=hf_config.vocab_size,
            d_feedforward=hf_config.ffn_dim, p_dropout=0.0)
    if mt == 'llama':
        n_kv = getattr(hf_config, 'num_key_value_heads',
                       hf_config.num_attention_heads)
        return ModelConfig(
            arch='llama', d_model=hf_config.hidden_size,
            n_heads=hf_config.num_attention_heads,
            n_layers=hf_config.num_hidden_layers,
            n_kv_heads=None if n_kv == hf_config.num_attention_heads
            else n_kv,
            max_length=hf_config.max_position_embeddings,
            vocab_size=hf_config.vocab_size,
            d_feedforward=hf_config.intermediate_size, p_dropout=0.0,
            rope_base=float(getattr(hf_config, 'rope_theta', 10000.0)))
    raise ValueError(f'unsupported model type {mt!r}')


def convert(hf_model, device='cuda') -> tuple[ModelConfig, Any]:
    """(cfg, the port's param tree of f32 tensors on `device`)."""
    dev = resolve_device(device)
    cfg = config_from_hf(hf_model.config)
    fn = convert_opt if cfg.arch == 'opt' else convert_llama
    flat = fn(hf_model, cfg)
    return cfg, unflatten({k: v.to(dev) for k, v in flat.items()})
