"""Decoder-only LM covering OPT and LLaMA (port of
spt_proto_tpu/models/decoder.py).

`DecoderLM` owns the parameter tree as `nn.Parameter`s whose module paths
are the flax paths (`blocks.mha.q.kernel` is `blocks/mha/q/kernel`), in the
stacked `[n_layers, ...]` layout of `blocks/*` that flax's nn.scan gives:
layer i reads slice [i] of each stacked leaf, and its gradient flows back
into the one stacked tensor. `bridge.params_from_numpy` maps a JAX tree one
to one; `tree()` hands the parameters back as the nested dict.

Under cfg.int8_base the frozen base kernels are not parameters: `frozen8`
(tuning.surgery.split_int8_base: {'q' [L, K, N_pad] int8, 'scale' [L, 1,
N] f32} at the kernels' paths) is held as buffers that never require grad
and stay out of `tree()`, the optimizer and the checkpoints; each forward
puts layer i's slice at its kernel's path, where LoRADense reads it.

OPT adds learned positions at offset 2 and ends in LayerNorm; LLaMA has no
learned positions (RoPE inside attention) and RMSNorm; both have an untied
lm_head. cfg.remat recomputes each block in the backward
(torch.utils.checkpoint, non-reentrant): remat_policy 'full' all of it,
'dots' all but the matmul outputs, which it saves (JAX's
checkpoint_policies.checkpoint_dots, through selective checkpointing; the
flash-attention launch is no matmul the dispatcher sees, so it is
recomputed, as JAX recomputes its pallas_call). Dropout (p_dropout > 0 and
deterministic=False) draws from the generator handed to forward.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from spt_proto_tpu_torch.config import ModelConfig
from spt_proto_tpu_torch.layers.common import LoRAEmbed
from spt_proto_tpu_torch.layers.transformer import TransformerBlock, make_norm

PE_OFFSET = 2   # OPT's learned-position index offset
REMAT_POLICIES = ('full', 'dots')

# the matmuls LoRADense, the einsums and the lm_head lower to
_aten = torch.ops.aten
_DOTS = frozenset((_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                   _aten.baddbmm.default))


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """remat_policy='dots': keep every matmul output, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree: a dict becomes a child
    module, a tensor an nn.Parameter (sharing its storage) that requires
    grad where `trainable(path)` says so."""

    def __init__(self, tree: dict, trainable: Callable[[str], bool],
                 prefix: str = ''):
        super().__init__()
        for key, val in tree.items():
            path = f'{prefix}/{key}' if prefix else key
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val, trainable, path))
            else:
                self.register_parameter(key, nn.Parameter(
                    val, requires_grad=trainable(path)))

    def tree(self) -> dict:
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class FrozenTree(nn.Module):
    """A nested dict of tensors as buffers (not in the state dict): the
    int8 base kernels of cfg.int8_base."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, FrozenTree(val))
            else:
                self.register_buffer(key, val, persistent=False)

    def tree(self) -> dict:
        out = {k: b for k, b in self._buffers.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def _merge(tree: dict, patch: dict) -> dict:
    """`tree` with patch's leaves (dict leaves such as {'q', 'scale'}
    included) set at their paths."""
    out = dict(tree)
    for key, val in patch.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], val)
        else:
            out[key] = val
    return out


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class DecoderLM(nn.Module):
    """forward(tokens [B, S]) -> {'logits': [B, S, V], 'pq_loss': the sum
    of the layers' aux losses}. `trainable(path)` picks the leaves that
    require grad (none by default); `frozen8` holds the int8 base kernels
    of an int8_base config."""

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 frozen8: Optional[dict] = None,
                 deterministic: bool = True, train_quantizer: bool = False,
                 trainable: Callable[[str], bool] = lambda path: False):
        super().__init__()
        if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f'remat_policy {cfg.remat_policy!r} is not one '
                             f'of {REMAT_POLICIES}')
        self.cfg = cfg
        self.deterministic = deterministic
        self.params = ParamTree(params, trainable)
        self.frozen8 = FrozenTree(frozen8 or {})
        self.embed = LoRAEmbed(cfg.dtype)
        self.block = TransformerBlock(cfg, deterministic, train_quantizer)
        self.final = make_norm(cfg)

    @property
    def train_quantizer(self) -> bool:
        return self.block.mha.train_quantizer

    @train_quantizer.setter
    def train_quantizer(self, on: bool) -> None:
        self.block.mha.train_quantizer = on

    def tree(self) -> dict:
        """The parameters as the nested flax-path dict."""
        return self.params.tree()

    def _run_block(self, blocks, i, h, generator):
        if not self.cfg.remat:
            return self.block(_layer(blocks, i), h, generator)
        # the recompute must draw the same dropout masks: restore the
        # generator's state at the block's start on each run
        state = None if generator is None else generator.get_state()

        def run(h_):
            if state is not None:
                generator.set_state(state)
            return self.block(_layer(blocks, i), h_, generator)
        kw = {}
        if self.cfg.remat_policy == 'dots':
            kw['context_fn'] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)
        return checkpoint(run, h, use_reentrant=False, **kw)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        cfg = self.cfg
        p = _merge(self.tree(), self.frozen8.tree())
        b, s = tokens.shape
        tokens = tokens.long()
        h = self.embed(p['embedding'], tokens)
        if cfg.arch == 'opt':
            if positions is None:
                positions = torch.arange(s, device=tokens.device)[None] \
                    .expand(b, s)
            h = h + self.embed(p['learned_pe'], positions.long() + PE_OFFSET)
        aux = []
        for i in range(cfg.n_layers):
            h, a = self._run_block(p['blocks'], i, h, generator)
            aux.append(a)
        h = self.final(p['final_norm'], h)
        logits = h @ p['lm_head']['kernel'].to(cfg.dtype)
        return {'logits': logits, 'pq_loss': torch.stack(aux).sum()}
