"""Param-tree path utilities (port of spt_proto_tpu/utils/tree.py, for
trees of tensors or numpy arrays): flatten to '/'-joined paths, rebuild,
overlay one tree onto another, diff against a base, count parameters."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def flatten(tree: Any, sep: str = '/') -> Dict[str, Any]:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f'{prefix}{sep}{k}' if prefix else str(k), v)
        else:
            flat[prefix] = node
    rec('', tree)
    return flat


def unflatten(flat: Dict[str, Any], sep: str = '/') -> Any:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, 'shape') else tuple(np.shape(x))


def overlay(base: Any, patch: Any, *, require_all_used: bool = True) -> Any:
    """Copy every leaf of `patch` into a copy of `base` at the same path.
    Shapes must match; a path of `patch` missing from `base` raises."""
    fb = flatten(base)
    fp = flatten(patch)
    out = dict(fb)
    for path, leaf in fp.items():
        if path not in fb:
            if require_all_used:
                raise KeyError(f'patch path {path!r} not present in base tree')
            continue
        if _shape(fb[path]) != _shape(leaf):
            raise ValueError(f'shape mismatch at {path!r}: '
                             f'{_shape(fb[path])} vs {_shape(leaf)}')
        out[path] = leaf
    return unflatten(out)


def to_numpy(x) -> np.ndarray:
    """A leaf as numpy (tensors leave their device; bf16 stays bf16 only
    where numpy has it: ml_dtypes' bfloat16, else f32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            try:
                from ml_dtypes import bfloat16
            except ImportError:
                return x.float().numpy()
            return x.view(torch.uint16).numpy().view(bfloat16)
        return x.numpy()
    return np.asarray(x)


def tree_diff(base: Any, tuned: Any, atol: float = 1e-3) -> Dict[str, Any]:
    """Leaves of `tuned` that differ from `base` (not allclose at atol), or
    are new: the delta checkpoint's content."""
    fb = flatten(base)
    ft = flatten(tuned)
    delta = {}
    for path, leaf in ft.items():
        if path not in fb:
            delta[path] = leaf
            continue
        a = to_numpy(fb[path]).astype(np.float32)
        b = to_numpy(leaf).astype(np.float32)
        if a.shape != b.shape or not np.allclose(a, b, atol=atol):
            delta[path] = leaf
    return delta


def param_count(tree: Any) -> int:
    return sum(int(np.prod(_shape(x))) for x in flatten(tree).values())
