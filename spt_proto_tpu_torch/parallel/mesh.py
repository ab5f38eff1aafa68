"""The device mesh over torch.distributed ranks (port of
spt_proto_tpu/parallel/mesh.py).

JAX runs one controller over its device Mesh and pjit inserts the
collectives. Here every rank is a process of its own (SPMD): it holds its
own shard of the weights and the cache as plain local tensors and calls
the collectives of parallel/comm.py explicitly. `make_mesh` lays the world
out as ('data', 'model'): 'data' shards the batch (cache slots), 'model'
the heads, the FFN's d_ff and the vocabulary (tensor parallelism).

Ranks are numbered data-major, as JAX's mesh reshapes its devices: rank =
data_index * n_model + model_index. `initialize_multihost` starts the
process group, from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) or from explicit arguments: NCCL where each rank
has a GPU of its own, gloo for CPU tensors. A rank whose LOCAL_RANK names no
GPU raises; two ranks share one GPU only when the caller passes the device
and the backend (gloo) explicitly.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
SP_AXIS = 'sp'      # context/sequence parallelism (ring attention)
PIPE_AXIS = 'pipe'  # pipeline stages


@dataclasses.dataclass
class Mesh:
    """This rank's view of the ('data', 'model') mesh: the DeviceMesh, the
    device its tensors live on, the axis sizes (`shape`, JAX's mesh.shape
    with 'sp' and 'pipe' at 1), this rank's coordinate on each axis and
    the process group of each axis (the ranks that share every other
    coordinate)."""
    device_mesh: object
    device: torch.device
    backend: str
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]

    def global_rank(self, data: int, model: int) -> int:
        """The world rank at mesh coordinate (data, model)."""
        return data * self.shape[MODEL_AXIS] + model


def default_device(device=None) -> torch.device:
    """The device a rank serves from: `device` when given, else the GPU
    named by LOCAL_RANK (0 outside a launcher). Raises when that GPU does
    not exist: a rank never shares another's GPU or drops to the CPU
    unless the caller says so."""
    if device is not None:
        return torch.device(device)
    local = int(os.environ.get('LOCAL_RANK', 0))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= n:
        raise RuntimeError(
            f'LOCAL_RANK {local} has no GPU ({n} visible): pass the device '
            f'(and backend="gloo" to share one) explicitly, or device="cpu"')
    return torch.device('cuda', local)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None, device=None,
                         timeout_s: float = 1800.0) -> torch.device:
    """Start the default process group and return this rank's device.

    With no coordinator_address the launcher's environment is read
    (torchrun: env://); else 'host:port' with num_processes and
    process_id. backend defaults to NCCL for a CUDA device and gloo for the
    CPU; NCCL over a CPU device raises."""
    dev = default_device(device)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    if backend == 'nccl' and dev.type != 'cuda':
        raise ValueError('NCCL takes CUDA tensors: use gloo on the CPU')
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {}
        if coordinator_address is not None:
            kw = dict(init_method=f'tcp://{coordinator_address}',
                      world_size=num_processes, rank=process_id)
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def is_main_process() -> bool:
    """True on the rank that owns logging and output (rank 0), and when
    no process group runs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None,
              n_sp: int = 1, n_pipe: int = 1, device=None) -> Mesh:
    """The ('data', 'model') mesh over every rank of the process group.

    Defaults as JAX's: all ranks on 'model' when neither width is given,
    else the other axis takes the remainder. n_sp > 1 (context
    parallelism) and n_pipe > 1 (pipeline stages) raise, naming their
    slices. device: this rank's device (default_device's rule)."""
    if n_sp != 1:
        raise NotImplementedError(
            'n_sp > 1: context parallelism (ops/ring_attention.py) comes '
            'with the context-parallelism slice')
    if n_pipe != 1:
        raise NotImplementedError(
            'n_pipe > 1: pipeline stages (parallel/pipeline.py) come with '
            'the pipeline slice')
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs a process group: call '
                           'initialize_multihost (or run under torchrun)')
    n = dist.get_world_size()
    if n_model is None and n_data is None:
        n_data, n_model = 1, n
    elif n_model is None:
        n_model = n // n_data
    elif n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f'mesh {n_data} x {n_model} != {n} ranks')
    dev = default_device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(dev.type, (n_data, n_model),
                          mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    rank = dist.get_rank()
    coords = {DATA_AXIS: rank // n_model, MODEL_AXIS: rank % n_model,
              SP_AXIS: 0, PIPE_AXIS: 0}
    return Mesh(device_mesh=dm, device=dev, backend=dist.get_backend(),
                shape={DATA_AXIS: n_data, MODEL_AXIS: n_model, SP_AXIS: 1,
                       PIPE_AXIS: 1},
                coords=coords,
                groups={DATA_AXIS: dm.get_group(DATA_AXIS),
                        MODEL_AXIS: dm.get_group(MODEL_AXIS)})
