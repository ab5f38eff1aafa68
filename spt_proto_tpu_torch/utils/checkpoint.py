"""Checkpoint IO in the JAX package's format (port of
spt_proto_tpu/utils/checkpoint.py): a directory with `params.npz` (flat
'/'-joined param paths; bf16 leaves as ml_dtypes' bfloat16) and
`config.json` (the ModelConfig fields, dtypes by name), so that each
package loads the other's checkpoints; delta
checkpoints hold only the tensors that changed against a base (`delta.npz`,
allclose at atol 1e-3, fewer than 50M parameters)."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from spt_proto_tpu_torch.config import ModelConfig
from spt_proto_tpu_torch.inference.bridge import params_from_numpy
from spt_proto_tpu_torch.utils.tree import (flatten, overlay, to_numpy,
                                            tree_diff, unflatten)

MAX_DELTA_PARAMS = 50_000_000

_DTYPE_NAMES = {torch.float32: 'float32', torch.bfloat16: 'bfloat16',
                torch.float16: 'float16'}


def _config_to_json(cfg: ModelConfig) -> str:
    d = dataclasses.asdict(cfg)
    for key in ('dtype', 'param_dtype'):
        d[key] = _DTYPE_NAMES[d[key]]
    return json.dumps(d, indent=2)


def _config_from_json(s: str) -> ModelConfig:
    d = json.loads(s)
    for key in ('dtype', 'param_dtype'):
        d[key] = getattr(torch, d[key])
    return ModelConfig(**d)


def _write_config(path: str, cfg: ModelConfig) -> None:
    with open(os.path.join(path, 'config.json'), 'w') as f:
        f.write(_config_to_json(cfg))


def _read_config(path: str) -> ModelConfig:
    with open(os.path.join(path, 'config.json')) as f:
        return _config_from_json(f.read())


def _load_npz(file: str, device) -> Any:
    with np.load(file) as data:
        flat = {k: data[k] for k in data.files}
    # a bf16 leaf (ml_dtypes' bfloat16, as both packages save one) comes
    # back from the npz as 2-byte void records: its bits, viewed as bf16
    bf16 = {k for k, v in flat.items()
            if v.dtype.kind == 'V' and v.dtype.itemsize == 2}
    tree = params_from_numpy(unflatten(
        {k: v.view(np.uint16) if k in bf16 else v for k, v in flat.items()}),
        device)
    return unflatten({k: v.view(torch.bfloat16) if k in bf16 else v
                      for k, v in flatten(tree).items()})


def save_checkpoint(path: str, cfg: ModelConfig, params: Any) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, 'params.npz'),
             **{k: to_numpy(v) for k, v in flatten(params).items()})
    _write_config(path, cfg)


def load_checkpoint(path: str, device='cuda') -> Tuple[ModelConfig, Any]:
    """(cfg, params as tensors on `device`)."""
    return _read_config(path), _load_npz(os.path.join(path, 'params.npz'),
                                         device)


def save_delta_checkpoint(path: str, cfg: ModelConfig, base_params: Any,
                          tuned_params: Any, *, atol: float = 1e-3,
                          max_params: int = MAX_DELTA_PARAMS) -> int:
    """Save only the tensors that differ from base; returns their count of
    parameters, which must stay under `max_params`."""
    delta = tree_diff(base_params, tuned_params, atol=atol)
    n = sum(int(np.prod(tuple(v.shape))) for v in delta.values())
    if n >= max_params:
        raise ValueError(f'delta too large: {n} params')
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, 'delta.npz'),
             **{k: to_numpy(v) for k, v in delta.items()})
    _write_config(path, cfg)
    return n


def load_delta_checkpoint(path: str, base_params: Any, device='cuda'
                          ) -> Tuple[ModelConfig, Any]:
    """Overlay a delta onto base params that already have the upgraded
    structure (LoRA / router / codebook leaves present)."""
    delta = _load_npz(os.path.join(path, 'delta.npz'), device)
    return _read_config(path), overlay(base_params, delta)
