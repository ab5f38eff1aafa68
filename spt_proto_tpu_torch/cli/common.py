"""Shared CLI helpers (port of spt_proto_tpu/cli/common.py).

`add_model_args` adds --ckpt, --config, --dtype and --device (default cuda:
every entry point runs on the card unless the caller asks for the CPU,
where the plain twins run); `load_or_init` loads a checkpoint (the JAX
package's format) or builds a named config's seeded random weights
(the port's init_params, seed 0) on that device; `apply_dtype` sets the
compute dtype; `add_mesh_args` adds the serving CLIs' --mesh_model /
--mesh_data and `mesh_from_args` makes their mesh (parallel/mesh.py): one
process a rank, launched by torchrun (`torchrun --nproc_per_node N -m
spt_proto_tpu_torch.cli.generate ... --mesh_model N`), each rank on
cuda:LOCAL_RANK over NCCL, or on the CPU over gloo with --device cpu; a
caller that started the process group itself (gloo, several ranks on one
GPU) passes the device explicitly (--device cuda:0). Only rank 0 prints
(parallel/mesh.py `is_main_process`).
"""
from __future__ import annotations

import argparse
from typing import Any, Tuple

import torch

from spt_proto_tpu_torch.config import (ModelConfig, llama_config,
                                        opt_config, tiny_config)
from spt_proto_tpu_torch.inference.bridge import resolve_device

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def named_config(name: str, **kw) -> ModelConfig:
    """A named config: opt-<size>, llama-<size> (the menus of config.py) or
    tiny-opt / tiny-llama (test sizes); kw sets fields."""
    fam, size = name.split('-', 1)
    if fam == 'tiny':
        return tiny_config(size, **kw)
    return (opt_config if fam == 'opt' else llama_config)(size, **kw)


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument('--ckpt', type=str, default=None,
                   help='checkpoint directory (config.json + params.npz)')
    p.add_argument('--config', type=str, default='opt-125m',
                   help='named config when no --ckpt (opt-125m, opt-1.3b, '
                        'llama-7b, llama-3-8b, ..., tiny-opt): seeded random '
                        'weights')
    p.add_argument('--dtype', type=str, default='float32',
                   choices=sorted(DTYPES))
    p.add_argument('--device', type=str, default='cuda',
                   help='cuda (the kernels) or cpu (the plain twins)')


def load_or_init(args, min_length: int = 0) -> Tuple[ModelConfig, Any]:
    """(cfg, params) on args.device: a checkpoint directory, or a named
    config's seeded random weights, its max_length raised to min_length
    (OPT's learned positions then cover it) where it is shorter."""
    from spt_proto_tpu_torch.tuning import surgery
    from spt_proto_tpu_torch.utils import checkpoint as ckpt_io
    dev = resolve_device(args.device)
    if getattr(args, 'ckpt', None):
        cfg, params = ckpt_io.load_checkpoint(args.ckpt, dev)
        if cfg.max_length < min_length:
            raise ValueError(f'{args.ckpt}: max_length {cfg.max_length} < '
                             f'the {min_length} positions asked for')
        return cfg, params
    cfg = named_config(getattr(args, 'config', 'opt-125m'))
    cfg = cfg.replace(max_length=max(cfg.max_length, min_length))
    return cfg, surgery.init_params(cfg, 0, dev)


def apply_dtype(cfg: ModelConfig, args) -> ModelConfig:
    return cfg.replace(dtype=DTYPES[args.dtype])


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    p.add_argument('--mesh_model', type=int, default=None,
                   help='tensor-parallel width for serving: weights '
                        'sharded on the model axis, KV cache heads sharded '
                        '(parallel/infer_sharding.py); one process a rank '
                        '(torchrun)')
    p.add_argument('--mesh_data', type=int, default=1,
                   help='data axis width for serving (cache slots sharded '
                        'across it)')


def mesh_from_args(args):
    """None when no --mesh_model: single-device serving. Otherwise the
    ('data', 'model') mesh over the process group (started here from
    torchrun's environment when it is not running yet), on the rank's
    device: --device cuda means cuda:LOCAL_RANK (which must exist), cpu
    the CPU over gloo, cuda:N that GPU. args.device is set to the mesh's
    device, where the weights then load."""
    if getattr(args, 'mesh_model', None) is None:
        if getattr(args, 'mesh_data', 1) != 1:
            raise ValueError('--mesh_data needs --mesh_model')
        return None
    from spt_proto_tpu_torch.parallel.mesh import (initialize_multihost,
                                                   make_mesh)
    dev = None if args.device == 'cuda' else args.device
    dev = initialize_multihost(device=dev)
    mesh = make_mesh(args.mesh_data, args.mesh_model, device=dev)
    args.device = str(mesh.device)
    return mesh


def on_card(args) -> bool:
    """True where args.device is a CUDA device (checked to exist): there
    every attention goes through the kernels (attn_impl='pallas')."""
    return resolve_device(args.device).type == 'cuda'
