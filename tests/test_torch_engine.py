"""PyTorch port vs the JAX package, the slice as a whole: config, weights
bridge, prefill into the int8 tile-major cache and greedy decode, on the CPU.

The JAX engine runs its Pallas kernels in interpret mode (attn_impl
'pallas'); the port, handed CPU tensors, runs its plain twins. Both start
from the same parameters (the JAX tree carried across with
params_from_numpy) and the same numpy prompts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu import config as jcfg
from spt_proto_tpu.inference import engine as jeng
from spt_proto_tpu.inference.weights import InferenceWeights as JIW
from spt_proto_tpu.tuning import surgery
from spt_proto_tpu_torch import config as tcfg
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference import engine as teng
from spt_proto_tpu_torch.inference.weights import InferenceWeights as TIW

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)

B, MAX_LEN, STEPS = 2, 1024, 8


def port_config(cfg):
    """The JAX ModelConfig as the port's (same fields, torch dtypes)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name in ('dtype', 'param_dtype'):
        kw[name] = getattr(torch, jnp.dtype(kw[name]).name)
    return tcfg.ModelConfig(**kw)


def flat(tree, prefix=''):
    if hasattr(tree, 'items'):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f'{prefix}/{k}'))
        return out
    return {prefix: tree}


@pytest.fixture(scope='module')
def model():
    """tests/test_decode_front.py's sparse_model recipe (d_model 128, two
    heads, l2 PQ metric) at max_length 1024 and sparse_coeff 2."""
    cfg = jcfg.tiny_config('opt', d_model=128, n_heads=2, d_feedforward=256,
                           vocab_size=256, max_length=MAX_LEN).replace(
        dtype=jnp.float32, pq_metric='l2', attn_impl='pallas')
    params = surgery.init_params(cfg, jax.random.PRNGKey(0))
    cfg, params = surgery.upgrade(cfg, params, 'mha_v1',
                                  jax.random.PRNGKey(1))
    cfg, params = surgery.upgrade(cfg, params, 'mha_v2',
                                  jax.random.PRNGKey(2))
    cfg = cfg.replace(sparse_coeff=2)
    params = jax.device_get(params)
    return cfg, params


def test_config_fields_and_presets_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.ModelConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.ModelConfig)}
    assert jf.keys() == tf.keys()
    for name in jf:
        if name in ('dtype', 'param_dtype'):
            assert getattr(torch, jnp.dtype(jf[name]).name) == tf[name]
        elif name != 'attn_impl':
            assert jf[name] == tf[name], name
    for j, t in ((jcfg.opt_config('125m'), tcfg.opt_config('125m')),
                 (jcfg.llama_config('3-8b'), tcfg.llama_config('3-8b')),
                 (jcfg.tiny_config('opt', d_model=128, n_heads=2,
                                   attention='sparse_v2'),
                  tcfg.tiny_config('opt', d_model=128, n_heads=2,
                                   attention='sparse_v2'))):
        assert port_config(j) == t
        for prop in ('d_head', 'kv_heads', 'kv_groups', 'n_subspaces',
                     'attn_bias', 'ffn_gated'):
            assert getattr(j, prop) == getattr(t, prop), prop


def test_weights_bridge_matches_jax(model):
    cfg, params = model
    want = flat(JIW.from_params(cfg, params).params)
    got = flat(TIW.from_params(
        port_config(cfg), bridge.params_from_numpy(params, device='cpu')
    ).params)
    assert got.keys() == want.keys()
    assert '/blocks/mha/qkv/kernel' in got
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix('torch.') == str(w.dtype), path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   err_msg=path)


def test_init_params_matches_surgery_tree(model):
    cfg, params = model
    want = flat(params)
    got = flat(bridge.init_params(port_config(cfg), seed=0, device='cpu'))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix('torch.') == str(w.dtype), path
        # the same init scale: ones/zeros exactly, random leaves by std
        ws, gs = float(np.std(w)), float(g.float().std())
        if ws == 0.0:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
        else:
            assert abs(gs - ws) < 0.1 * ws, (path, gs, ws)


def _jax_run(cfg, params, tokens):
    iw = JIW.from_params(cfg, params)
    cache = jeng.KVCache.create(cfg, B, MAX_LEN, dtype=jnp.float32,
                                quantized=True)
    logits, cache = jax.jit(jeng.prefill)(iw, jnp.asarray(tokens), cache)
    after_prefill = jax.device_get(cache)
    step = jax.jit(jeng.decode_step_greedy)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    out = []
    for _ in range(STEPS):
        tok, cache = step(iw, tok, cache)
        out.append(np.asarray(tok))
    return np.asarray(logits), after_prefill, np.stack(out, 1)


def _port_run(cfg, params, tokens):
    cfg = port_config(cfg)
    iw = TIW.from_params(cfg, bridge.params_from_numpy(params, device='cpu'))
    cache = teng.KVCache.create(cfg, B, MAX_LEN, dtype=torch.float32,
                                quantized=True, device='cpu')
    logits, cache = teng.prefill(iw, torch.from_numpy(tokens), cache)
    after_prefill = {k: getattr(cache, k).clone() for k in
                     ('k', 'v', 'codes', 'length', 'k_scale', 'v_scale')}
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    out = []
    for _ in range(STEPS):
        tok, cache = teng.decode_step_greedy(iw, tok, cache)
        out.append(tok.numpy())
    return logits.numpy(), after_prefill, np.stack(out, 1)


@pytest.mark.parametrize('prompt', [768, 300])
def test_prefill_and_greedy_decode_match_jax(model, prompt):
    """768: the block-sparse branch (n_sel 3 against a tile ratio of 2, so
    PQ scores pick off-diagonal tiles). 300: the per-row oracle branch and
    a partial current tile. Then 8 greedy steps over the int8 cache."""
    cfg, params = model
    tokens = np.random.RandomState(prompt).randint(
        1, cfg.vocab_size, size=(B, prompt)).astype(np.int32)
    j_logits, j_cache, j_tokens = _jax_run(cfg, params, tokens)
    t_logits, t_cache, t_tokens = _port_run(cfg, params, tokens)
    np.testing.assert_allclose(t_logits, j_logits, atol=1e-4, rtol=0)
    for name in ('codes', 'length'):
        np.testing.assert_array_equal(t_cache[name].numpy(),
                                      np.asarray(getattr(j_cache, name)),
                                      err_msg=name)
    # XLA's CPU dot and torch sum the k/v projections in different orders,
    # so k and v differ in their last bits: the per-token scales by up to
    # ~1e-6 relative, and a value that sits on a rounding boundary of the
    # int8 grid lands one step away (a handful of the ~500k entries)
    for name in ('k', 'v'):
        got = t_cache[name].numpy().astype(np.int32)
        want = np.asarray(getattr(j_cache, name)).astype(np.int32)
        assert np.abs(got - want).max() <= 1, name
        assert (got != want).mean() < 1e-4, name
    for name in ('k_scale', 'v_scale'):
        np.testing.assert_allclose(t_cache[name].numpy(),
                                   np.asarray(getattr(j_cache, name)),
                                   rtol=1e-5, atol=0, err_msg=name)
    np.testing.assert_array_equal(t_tokens, j_tokens)
