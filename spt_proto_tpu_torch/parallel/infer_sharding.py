"""Sharded serving: tensor-parallel weights and a head-sharded KV cache (port
of spt_proto_tpu/parallel/infer_sharding.py).

The folded serving tree (inference/weights.py) keeps the training paths, so
the rules of parallel/sharding.py say which dim of each leaf 'model'
splits; `shard_inference_weights` cuts this rank's part out of the full
tree: q / k / v (the fused [3, D, O] stack on its last dim, the packed
int8 [D, 3D] kernel head-aligned within each of its three parts) and
fc1 / gate / side by columns, o and fc2 / down by rows (an int8 kernel's
per-column scales whole), the embedding by vocabulary rows and the lm_head
by vocabulary columns; an int8 kernel cut by columns is padded to 256
columns again, as inference/weights.py pads it. Codebooks, norms, biases of
the row-parallel products and OPT's learned positions are whole on every
rank.

A width the model axis does not divide stays whole on every rank (JAX's
_fit_spec strips the axis the same way): the attention when the kv heads
(and, with sparse_select_heads > 1, the selection groups) do not divide,
the FFN when d_ff does not, the vocabulary when it does not. Attention is
split head-aligned or not at all, so that a rank's heads and its cache's
heads are the same ones.

The contiguous cache holds a rank's slots (its 'data' rows when the slots
divide over 'data', else all of them: `data_rows`) and its kv heads; the
paged pools hold its kv heads, with page tables and lengths whole on every
rank (host-kept scheduler state).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from spt_proto_tpu_torch.inference.engine import KVCache
from spt_proto_tpu_torch.inference.weights import InferenceWeights, Shard
from spt_proto_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from spt_proto_tpu_torch.parallel.sharding import local_slice, spec_for_path
from spt_proto_tpu_torch.utils.tree import flatten, unflatten

INT8_PAD = 256   # inference/weights.py quantize_int8's column padding


def data_rows(mesh, b: int) -> Tuple[slice, bool]:
    """(this rank's rows of a batch of b, whether 'data' splits it): B
    splits over 'data' when it divides, else every rank holds all rows."""
    n = mesh.shape[DATA_AXIS]
    if n == 1 or b % n:
        return slice(None), False
    per = b // n
    lo = mesh.coords[DATA_AXIS] * per
    return slice(lo, lo + per), True


def _pad_cols(q: torch.Tensor) -> torch.Tensor:
    pad = (-q.shape[-1]) % INT8_PAD
    return torch.nn.functional.pad(q, (0, pad)) if pad else q


def _group(path: str) -> str:
    if path.startswith('blocks/mha/'):
        return 'attn'
    if path.startswith('blocks/ffn/'):
        return 'ffn'
    if path.startswith(('embedding/', 'lm_head/')):
        return 'head'
    return ''


def _cut(path: str, t: torch.Tensor, flat: dict, m: int, r: int
         ) -> torch.Tensor:
    """Rank r of m's part of the leaf at `path` (its group split)."""
    int8 = path.endswith(('/kernel/q', '/kernel/scale'))
    base = path.rsplit('/', 1)[0] if int8 else path
    spec = spec_for_path(base)
    if spec is None or MODEL_AXIS not in spec:
        return t.clone()
    if not int8:
        return local_slice(t, spec, {MODEL_AXIS: m}, {MODEL_AXIS: r})
    scale = flat[base + '/scale']
    n = scale.shape[-1]                        # the true width
    is_q = path.endswith('/q')
    if spec.index(MODEL_AXIS) - len(spec) == -2:      # rows (o, fc2, down)
        if not is_q:
            return t.clone()
        step = t.shape[-2] // m
        return t.narrow(-2, r * step, step).clone()
    if base == 'blocks/mha/qkv/kernel':
        # the packed [q | k | v]: each part's columns, head-aligned
        o = n // 3
        step = o // m
        cols = torch.cat([torch.arange(i * o + r * step, i * o + (r + 1)
                                       * step) for i in range(3)])
    else:
        step = n // m
        cols = torch.arange(r * step, (r + 1) * step)
    part = t.index_select(-1, cols.to(t.device))
    return _pad_cols(part).contiguous() if is_q else part.contiguous()


def shard_inference_weights(mesh, iw: InferenceWeights) -> InferenceWeights:
    """This rank's shard of the full serving weights, on mesh.device, with
    its Shard (the widths it holds)."""
    cfg = iw.cfg
    p = iw.params
    if 'router' in p['blocks']['ffn']:
        raise NotImplementedError(
            'a routed FFN under a mesh: expert parallelism '
            '(ops/routed_ffn_ep.py) comes with the expert-parallelism slice')
    m, r = mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS]
    kv, h, d_ff = cfg.kv_heads, cfg.n_heads, cfg.d_feedforward
    vocab = p['embedding']['embedding'].shape[0]
    head_w = p['lm_head']['kernel']
    head_cols = (head_w['scale'].shape[-1] if isinstance(head_w, dict)
                 else head_w.shape[-1])
    split = dict(
        attn=m > 1 and kv % m == 0
        and (kv // m) % cfg.sparse_select_heads == 0,
        ffn=m > 1 and d_ff % m == 0,
        head=m > 1 and vocab % m == 0 and head_cols == vocab)
    flat = flatten(p)
    out = {}
    for path, t in flat.items():
        g = _group(path)
        leaf = _cut(path, t, flat, m, r) if split.get(g) else t
        out[path] = leaf.to(mesh.device)
    shard = Shard(
        mesh=mesh,
        n_heads=h // m if split['attn'] else h,
        kv_heads=kv // m if split['attn'] else kv,
        d_ff=d_ff // m if split['ffn'] else d_ff,
        vocab=vocab // m if split['head'] else vocab,
        vocab_lo=r * (vocab // m) if split['head'] else 0,
        **split)
    return InferenceWeights(cfg=cfg, params=unflatten(out), quant=iw.quant,
                            shard=shard)


def _heads_of(mesh, n_kv: int, iw=None) -> slice:
    """This rank's kv heads: the weights' split when given, else JAX's
    rule (split when the heads divide)."""
    m = mesh.shape[MODEL_AXIS]
    if iw is not None:
        if not iw.shard.attn:
            return slice(None)
        per = iw.shard.kv_heads
    else:
        if m == 1 or n_kv % m:
            return slice(None)
        per = n_kv // m
    lo = mesh.coords[MODEL_AXIS] * per
    return slice(lo, lo + per)


def shard_cache(mesh, cache: KVCache, batch_axis: str = DATA_AXIS,
                iw: InferenceWeights = None) -> KVCache:
    """This rank's part of a full contiguous cache: slots on 'data' (when
    they divide and batch_axis is 'data'), kv heads on 'model' (as the
    sharded weights `iw` hold them, or when they divide); the int8 scales'
    head lanes follow the heads, padded to a multiple of 8 again."""
    rows = slice(None)
    if batch_axis == DATA_AXIS:
        rows, _ = data_rows(mesh, cache.k.shape[0])
    hs = _heads_of(mesh, cache.k.shape[1], iw)

    def cut(t):
        return t[rows, hs].clone()

    scales = {}
    if cache.quantized:
        n_kv = cache.k[:, hs].shape[1]
        hp = -(-n_kv // 8) * 8
        for name in ('k_scale', 'v_scale'):
            sc = getattr(cache, name)[rows][:, :, hs]
            scales[name] = torch.nn.functional.pad(
                sc[:, :, :n_kv], (0, 0, 0, hp - n_kv)).contiguous()
    return KVCache(k=cut(cache.k), v=cut(cache.v), codes=cut(cache.codes),
                   length=cache.length[rows].clone(), **scales)


def shard_paged_cache(mesh, cache, iw: InferenceWeights = None):
    """This rank's part of a full paged cache: the pools' head axis on
    'model'; page tables and lengths whole."""
    hs = _heads_of(mesh, cache.k_pages.shape[0], iw)
    pools = {f.name: getattr(cache, f.name)[hs].clone()
             for f in dataclasses.fields(cache)
             if f.name in ('k_pages', 'v_pages', 'c_pages', 'k_scales',
                           'v_scales') and getattr(cache, f.name) is not None}
    return dataclasses.replace(cache, **pools)
