"""Trainable / frozen parameter partition (port of
spt_proto_tpu/tuning/partition.py): only LoRA factors, routers and PQ
codebooks train."""
from __future__ import annotations

from typing import Any

from spt_proto_tpu_torch.utils.tree import flatten, param_count, unflatten

TRAINABLE_MARKERS = ('lora_left', 'lora_right', 'router', 'codebook')


def is_trainable_path(path: str) -> bool:
    parts = path.split('/')
    return any(m in parts for m in TRAINABLE_MARKERS)


def trainable_mask(params: Any) -> Any:
    """Tree of bools: True = trainable (LoRA / router / PQ codebook)."""
    return unflatten({p: is_trainable_path(p) for p in flatten(params)})


def count_trainable(params: Any) -> tuple[int, int]:
    """(trainable, frozen) parameter counts."""
    flat = flatten(params)
    train = param_count({p: v for p, v in flat.items()
                         if is_trainable_path(p)})
    return train, param_count(params) - train
