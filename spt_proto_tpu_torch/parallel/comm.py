"""The collectives the sharded engine calls (explicit, Megatron style).

JAX's pjit inserts these from the shardings; here the engine calls them
where they belong: `sum_` over 'model' after the row-parallel products (o,
fc2 / down) and the vocab-parallel embedding, `gather` over 'model' for the
heads' (value, index) pairs and the vocabulary shards of the logits, and
over 'data' for the slot-sharded tokens, `broadcast` over 'data' of a
slot's prefill logits from the rank that holds the slot, and
`broadcast_object` of host objects (the server's admissions) from rank 0.

Every call goes over the axis's process group and works the same on gloo
and NCCL. The transport is a rule of the backend, never a fallback after a
failure: NCCL moves CUDA tensors itself, and so does gloo (through host
memory, inside the library) for the collectives in GLOO_CUDA_NATIVE, the
three this module calls (`transport`, which chip_smoke.py prints); a
collective outside that set on CUDA tensors over gloo would have to be
staged through a CPU copy by rule, and none is called. Sums
run in f32 whatever the tensor's dtype, and the result is cast back.
`CALLS` counts the calls of each collective (chip_smoke.py reads it).
"""
from __future__ import annotations

import collections
from typing import Any, List

import torch
import torch.distributed as dist

from spt_proto_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

# what gloo runs on CUDA tensors itself (ProcessGroupGloo's CUDA work
# classes); chip_smoke.py's phase 13 runs each on the card and prints the
# transport of every collective it calls
GLOO_CUDA_NATIVE = frozenset({'all_reduce', 'broadcast', 'all_gather'})

CALLS: collections.Counter = collections.Counter()


def transport(backend: str, device_type: str, op: str) -> str:
    """'native' when the backend moves `op`'s tensors itself, 'host' when
    they would need staging through a CPU copy (by rule, per backend)."""
    if backend == 'gloo' and device_type == 'cuda' \
            and op not in GLOO_CUDA_NATIVE:
        return 'host'
    return 'native'


def sum_(mesh: Mesh, t: torch.Tensor, axis: str = MODEL_AXIS
         ) -> torch.Tensor:
    """The sum of every member's t over the axis, in f32, cast back to t's
    dtype (t itself when the axis has one member)."""
    if mesh.shape[axis] == 1:
        return t
    CALLS['all_reduce'] += 1
    buf = t.float().contiguous()
    if buf is t:
        buf = buf.clone()
    dist.all_reduce(buf, group=mesh.groups[axis])
    return buf.to(t.dtype)


def gather(mesh: Mesh, t: torch.Tensor, axis: str, dim: int = 0
           ) -> torch.Tensor:
    """Every member's t (equal shapes) concatenated along `dim` in the
    axis's coordinate order."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    CALLS['all_gather'] += 1
    buf = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=mesh.groups[axis])
    return torch.cat(parts, dim=dim)


def broadcast(mesh: Mesh, t: torch.Tensor, src: int, axis: str
              ) -> torch.Tensor:
    """t of the member at coordinate `src` on the axis, on every member
    (the others pass a tensor of the same shape and dtype)."""
    if mesh.shape[axis] == 1:
        return t
    CALLS['broadcast'] += 1
    coords = dict(mesh.coords)
    coords[axis] = src
    root = mesh.global_rank(coords['data'], coords['model'])
    buf = t.contiguous()
    dist.broadcast(buf, src=root, group=mesh.groups[axis])
    return buf


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """A picklable host object from world rank `src` to every rank."""
    CALLS['broadcast_object'] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
