"""Parameter sharding rules (port of spt_proto_tpu/parallel/sharding.py,
the serving half).

The same path-pattern rules as the JAX package, with a spec written as a
tuple of axis names (None = not sharded) where JAX writes a PartitionSpec:
tensor parallelism on 'model' (q/k/v and fc1 / gate / side shard their
output dim, o and fc2 / down their input dim, the embedding its vocabulary
rows and the lm_head its vocabulary columns); codebooks, routers, norms
and learned positions replicate. The stacked [n_layers] axis of a block
leaf is the leading entry of its spec (None unless fsdp / pp).

`shard_params` takes the full tree and returns this rank's local shard of
each leaf: the slice of every dim an axis shards, at the rank's coordinate
on that axis. As `_fit_spec` says, a dim that the axis does not divide is
replicated (JAX strips the axis the same way); JAX's `_reassign_axis`,
which moves a stripped 'data' axis onto another dim under fsdp, is not
ported: placement is a performance choice there, never a correctness one.
fsdp (ZeRO-3 on 'data') and pp (stages on 'pipe') are the training mesh's
and raise here.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import torch

from spt_proto_tpu_torch.utils.tree import flatten, unflatten

M, D = 'model', 'data'

# (regex over '/'-joined path, spec without the layer axis)
_BLOCK_RULES = [
    # attention projections: q/k/v shard the head (output) dim, o the input
    # (the serving-side fused form [3, D, O] shards the same output dim)
    (r'mha/qkv/kernel$', (None, None, M)),
    (r'mha/qkv/bias$', (None, M)),
    (r'mha/(q|k|v)/kernel$', (None, M)),
    (r'mha/(q|k|v)/bias$', (M,)),
    (r'mha/(q|k|v)/lora_right$', (M, None)),
    (r'mha/(q|k|v)/lora_left$', (None, None)),
    (r'mha/o/kernel$', (M, None)),
    (r'mha/o/bias$', (None,)),
    (r'mha/o/lora_left$', (M, None)),
    (r'mha/o/lora_right$', (None, None)),
    # PQ codebooks replicate (tiny; every shard needs all subspaces)
    (r'quantizer/codebook$', (None, None, None)),
    # FFN: fc1/gate/side shard d_ff, fc2/down shard the input d_ff dim
    (r'ffn/(fc1|gate|side)/kernel$', (None, M)),
    (r'ffn/fc1/bias$', (M,)),
    (r'ffn/(fc1|gate|side)/lora_right$', (M, None)),
    (r'ffn/(fc1|gate|side)/lora_left$', (None, None)),
    (r'ffn/(fc2|down)/kernel$', (M, None)),
    (r'ffn/fc2/bias$', (None,)),
    (r'ffn/(fc2|down)/lora_left$', (M, None)),
    (r'ffn/(fc2|down)/lora_right$', (None, None)),
    (r'ffn/router/kernel$', (None, None)),
    (r'ffn/router/bias$', (None,)),
    # norms replicate
    (r'norm\d/(scale|bias)$', (None,)),
]

_TOP_RULES = [
    (r'^embedding/embedding$', (M, None)),
    (r'^embedding/lora_left$', (M, None)),
    (r'^embedding/lora_right$', (None, None)),
    (r'^learned_pe/', (None, None)),
    (r'^final_norm/', (None,)),
    (r'^lm_head/kernel$', (None, M)),
]

# ZeRO-3-equivalent overrides (the training mesh's): the big top-level
# matrices also shard on 'data' along a dim 'model' does not occupy
_TOP_RULES_FSDP = [
    (r'^embedding/embedding$', (M, D)),
    (r'^embedding/lora_left$', (M, None)),
    (r'^embedding/lora_right$', (None, None)),
    (r'^learned_pe/embedding$', (None, D)),
    (r'^final_norm/', (None,)),
    (r'^lm_head/kernel$', (D, M)),
]


def spec_for_path(path: str, fsdp: bool = False, pp: bool = False):
    """The spec of the leaf at `path`, or None (replicate)."""
    for pat, spec in (_TOP_RULES_FSDP if fsdp else _TOP_RULES):
        if re.search(pat, path):
            return spec
    if path.startswith('blocks/'):
        for pat, spec in _BLOCK_RULES:
            if re.search(pat, path):
                lead = 'pipe' if pp else (D if fsdp else None)
                return (lead, *spec)
    return None


def param_specs(params: Any, fsdp: bool = False, pp: bool = False) -> Any:
    """The spec tree matching the param tree (() = replicated), a spec cut
    to its leaf's rank."""
    if fsdp and pp:
        raise ValueError('fsdp and pp both shard the stacked-layer axis — '
                         'pick one')
    specs = {}
    for path, leaf in flatten(params).items():
        spec = spec_for_path(path, fsdp=fsdp, pp=pp) or ()
        specs[path] = tuple(spec[:len(leaf.shape)])
    return unflatten(specs)


def _fit_spec(mesh_shape: Dict[str, int], spec: tuple, shape
              ) -> Tuple[tuple, List[str]]:
    """Strip mesh axes from dims they do not divide evenly. Returns (fitted
    spec, stripped axis names). mesh_shape: axis -> size (Mesh.shape)."""
    out, stripped = [], []
    for dim, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept: List[str] = []
        for ax in axes:
            size = mesh_shape[ax]
            prod = 1
            for a in kept:
                prod *= mesh_shape[a]
            if size > 1 and shape[dim] % (prod * size) != 0:
                stripped.append(ax)
                continue
            kept.append(ax)
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return tuple(out), stripped


def local_slice(t: torch.Tensor, spec: tuple, mesh_shape: Dict[str, int],
                coords: Dict[str, int]) -> torch.Tensor:
    """This rank's shard of t under a fitted spec: each sharded dim cut
    into mesh_shape[axis] equal parts, the part at the rank's coordinate
    (a copy of its own, so the full tensor can be freed)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        if isinstance(entry, tuple):
            raise NotImplementedError('a dim sharded over two axes (fsdp) '
                                      'comes with the training-mesh slice')
        n = mesh_shape[entry]
        if n == 1:
            continue
        step = t.shape[dim] // n
        t = t.narrow(dim, coords[entry] * step, step)
    return t.clone(memory_format=torch.contiguous_format)


def shard_params(mesh, params: Any, fsdp: bool = False,
                 pp: bool = False) -> Any:
    """This rank's local shard of every leaf of the full tree (mesh:
    parallel.mesh.Mesh, or anything with `.shape` and `.coords`)."""
    if fsdp:
        raise NotImplementedError('fsdp=True (ZeRO-3 on the data axis) comes '
                                  'with the training-mesh slice')
    if pp:
        raise NotImplementedError('pp=True (pipeline stages) comes with the '
                                  'pipeline slice')
    flat_specs = flatten(param_specs(params))
    out = {}
    for path, leaf in flatten(params).items():
        fitted, _ = _fit_spec(mesh.shape, flat_specs[path], leaf.shape)
        out[path] = local_slice(leaf, fitted, mesh.shape, mesh.coords)
    return unflatten(out)
