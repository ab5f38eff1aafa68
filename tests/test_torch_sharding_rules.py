"""The port's sharding rules (spt_proto_tpu_torch/parallel) against the JAX
package's, in plain Python on one process: the spec of every leaf, path for
path, of a training tree and of the serving trees (fp, int8, GQA), with
fsdp / pp as JAX writes them; _fit_spec on dividing and non-dividing dims;
shard_params and shard_inference_weights cutting each rank's part (the
parts put back together give the full leaf, the packed int8 QKV
head-aligned within its parts); the batch rows a data coordinate holds;
the first-maximum rule of the vocab-parallel greedy head; and the
collectives' transport rule."""
import functools
import types

import numpy as np
import pytest
import torch

from spt_proto_tpu.parallel import sharding as jsh
from spt_proto_tpu_torch.config import tiny_config
from spt_proto_tpu_torch.inference import engine as teng
from spt_proto_tpu_torch.inference.bridge import init_params
from spt_proto_tpu_torch.inference.weights import InferenceWeights
from spt_proto_tpu_torch.parallel import comm, infer_sharding, sharding
from spt_proto_tpu_torch.utils.tree import flatten

torch.set_num_threads(1)

SPARSE = dict(attention='sparse_v2', d_codeword=4, n_codewords=8)


@functools.lru_cache(maxsize=1)
def _trees():
    opt = tiny_config('opt', d_lora=4, **SPARSE)
    gqa = tiny_config('llama', d_model=128, n_heads=4, n_kv_heads=2,
                      d_feedforward=256, **SPARSE)
    p_opt = init_params(opt, 0, device='cpu')
    p_gqa = init_params(gqa, 0, device='cpu')
    return {'train': p_opt,
            'serve': InferenceWeights.from_params(opt, p_opt).params,
            'serve_int8': InferenceWeights.from_params(
                opt, p_opt, quant='int8').params,
            'serve_gqa': InferenceWeights.from_params(gqa, p_gqa).params}


def _fake_mesh(n_data, n_model, d=0, m=0):
    return types.SimpleNamespace(
        shape={'data': n_data, 'model': n_model, 'sp': 1, 'pipe': 1},
        coords={'data': d, 'model': m, 'sp': 0, 'pipe': 0},
        device=torch.device('cpu'))


@pytest.mark.parametrize('fsdp,pp', [(False, False), (True, False),
                                     (False, True)])
def test_param_specs_match_jax_path_for_path(fsdp, pp):
    for name, tree in _trees().items():
        got = flatten(sharding.param_specs(tree, fsdp=fsdp, pp=pp))
        want = flatten(jsh.param_specs(
            {k: v for k, v in tree.items()}, fsdp=fsdp, pp=pp))
        assert set(got) == set(want), name
        for path, spec in want.items():
            assert got[path] == tuple(spec), (name, path, got[path], spec)


def test_fit_spec_matches_jax():
    cases = [((None, 'model'), (4, 6)), (('model', None), (3, 8)),
             (('data', 'model'), (2, 4)), ((('data', 'model'), None), (8, 3)),
             ((('data', 'model'), None), (6, 3)), ((None,), (5,))]
    for sizes in ({'data': 2, 'model': 2}, {'data': 1, 'model': 4},
                  {'data': 4, 'model': 1}):
        fake = types.SimpleNamespace(shape=sizes)
        for spec, shape in cases:
            want_spec, want_axes = jsh._fit_spec(fake, jsh.P(*spec), shape)
            got_spec, got_axes = sharding._fit_spec(sizes, spec, shape)
            assert got_spec == tuple(want_spec) and got_axes == want_axes, \
                (sizes, spec, shape)


def test_shard_params_parts_make_the_whole():
    tree = _trees()['train']
    specs = flatten(sharding.param_specs(tree))
    parts = [flatten(sharding.shard_params(_fake_mesh(1, 2, m=m), tree))
             for m in range(2)]
    for path, full in flatten(tree).items():
        spec, _ = sharding._fit_spec({'data': 1, 'model': 2}, specs[path],
                                     full.shape)
        if 'model' in spec:
            dim = spec.index('model')
            assert parts[0][path].shape[dim] * 2 == full.shape[dim], path
            assert torch.equal(torch.cat([p[path] for p in parts], dim=dim),
                               full), path
        else:
            assert all(torch.equal(p[path], full) for p in parts), path


def test_shard_inference_weights_packed_int8_and_rows():
    cfg = tiny_config('opt', **SPARSE)
    iw = InferenceWeights.from_params(cfg, init_params(cfg, 0, device='cpu'),
                                      quant='int8')
    full = iw.params['blocks']
    o = cfg.d_model
    for m in range(2):
        sh = infer_sharding.shard_inference_weights(_fake_mesh(1, 2, m=m), iw)
        s = sh.shard
        assert (s.n_heads, s.kv_heads, s.d_ff, s.vocab, s.vocab_lo) == (
            2, 2, cfg.d_feedforward // 2, 128, 128 * m)
        qkv = sh.params['blocks']['mha']['qkv']['kernel']
        cols = np.concatenate([np.arange(t * o + m * o // 2,
                                         t * o + (m + 1) * o // 2)
                               for t in range(3)])
        assert qkv['q'].shape[-1] % 256 == 0
        assert torch.equal(qkv['q'][..., :3 * o // 2],
                           full['mha']['qkv']['kernel']['q'][..., cols])
        assert torch.equal(qkv['scale'],
                           full['mha']['qkv']['kernel']['scale'][..., cols])
        ok = sh.params['blocks']['mha']['o']['kernel']
        assert torch.equal(ok['scale'], full['mha']['o']['kernel']['scale'])
        assert torch.equal(ok['q'], full['mha']['o']['kernel']['q'][
            :, m * o // 2:(m + 1) * o // 2])
        assert torch.equal(sh.params['embedding']['embedding'],
                           iw.params['embedding']['embedding'][
                               128 * m:128 * (m + 1)])


def test_data_rows_and_the_first_maximum():
    mesh = _fake_mesh(2, 2, d=1)
    assert infer_sharding.data_rows(mesh, 8) == (slice(4, 8), True)
    assert infer_sharding.data_rows(mesh, 3) == (slice(None), False)
    assert infer_sharding.data_rows(_fake_mesh(1, 4), 8) == (slice(None),
                                                             False)
    vals = torch.tensor([[1.0, 3.0, 2.0], [1.0, 2.0, 2.0]])
    ids = torch.tensor([[7, 4, 9], [3, 90, 8]])
    assert teng.first_max(vals, ids).tolist() == [3, 4, 8]


def test_transport_rule():
    for op in ('all_reduce', 'all_gather', 'broadcast'):
        assert comm.transport('gloo', 'cuda', op) == 'native'
        assert comm.transport('nccl', 'cuda', op) == 'native'
        assert comm.transport('gloo', 'cpu', op) == 'native'
    assert comm.transport('gloo', 'cuda', 'reduce_scatter') == 'host'


def test_shard_caches_hold_the_rank_heads_and_rows():
    """shard_cache / shard_paged_cache cut a full cache as the sharded
    weights hold it: slots on 'data', kv heads on 'model' (the int8 scale
    lanes of the rank's heads, padded to 8 again); page tables and lengths
    whole."""
    from spt_proto_tpu_torch.inference.paged import PagedKVCache
    cfg = tiny_config('opt', **SPARSE)
    full = teng.KVCache.create(cfg, 4, 256, dtype=torch.float32,
                               quantized=True, device='cpu')
    for t in (full.k, full.v, full.codes, full.k_scale, full.length):
        t.copy_(torch.arange(t.numel()).reshape(t.shape).to(t.dtype))
    mesh = _fake_mesh(2, 2, d=1, m=1)
    part = infer_sharding.shard_cache(mesh, full)
    assert torch.equal(part.k, full.k[2:4, 2:4])
    assert torch.equal(part.codes, full.codes[2:4, 2:4])
    assert torch.equal(part.length, full.length[2:4])
    assert part.k_scale.shape[2] == 8
    assert torch.equal(part.k_scale[:, :, :2], full.k_scale[2:4, :, 2:4])
    assert not part.k_scale[:, :, 2:].any()
    pool = PagedKVCache.create(cfg, 4, 8, 16, 64, dtype=torch.float32,
                               device='cpu')
    pool.k_pages.copy_(torch.arange(pool.k_pages.numel()).reshape(
        pool.k_pages.shape).float())
    paged = infer_sharding.shard_paged_cache(mesh, pool)
    assert torch.equal(paged.k_pages, pool.k_pages[2:4])
    assert paged.page_indices is pool.page_indices
