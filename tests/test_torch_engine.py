"""PyTorch port vs the JAX package, the slice as a whole: config, weights
bridge, prefill into the int8 tile-major cache and greedy decode, on the CPU.

The JAX engine runs its Pallas kernels in interpret mode (attn_impl
'pallas'); the port, handed CPU tensors, runs its plain twins. Both start
from the same parameters (the JAX tree carried across with
params_from_numpy) and the same numpy prompts.
"""
import dataclasses
import functools

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
from spt_proto_tpu_torch.tuning import surgery as surgery_port

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)

B, MAX_LEN, STEPS = 2, 1024, 8


def jitted(fn, *args, **kw):
    """A JAX function called through jax.jit (its keyword arguments static):
    the same function, traced and compiled once instead of dispatched op by
    op (eager dispatch compiles every primitive and costs seconds)."""
    return jax.jit(functools.partial(fn, **kw))(*args)


def port_config(cfg):
    """The JAX ModelConfig as the port's (same fields, torch dtypes)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name in ('dtype', 'param_dtype'):
        kw[name] = getattr(torch, jnp.dtype(kw[name]).name)
    return tcfg.ModelConfig(**kw)


def jax_config(cfg):
    """The port's ModelConfig as the JAX package's (jnp dtypes)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name in ('dtype', 'param_dtype'):
        kw[name] = jnp.dtype(str(kw[name]).removeprefix('torch.'))
    return jcfg.ModelConfig(**kw)


def port_seeded(cfg, stages=(), **stage_kw):
    """(JAX cfg, numpy params) of the JAX config `cfg` after the upgrade
    `stages`, made by the port's seeded init_params and surgery (seeds 0,
    1, 2, ...; milliseconds, where JAX's jitted surgery takes seconds a
    model). test_init_params_matches_surgery_tree holds the initial tree to
    JAX's (paths, shapes, dtypes, scales), test_upgrade_tree_matches_jax
    the trees after the 'lora' and 'ffn' stages (paths, shapes, dtypes);
    both packages then take the same numpy tree."""
    tc = port_config(cfg)
    params = surgery_port.init_params(tc, 0, 'cpu')
    for i, stage in enumerate(stages):
        tc, params = surgery_port.upgrade(tc, params, stage, i + 1,
                                          **stage_kw.get(stage, {}))
    return jax_config(tc), bridge.params_to_numpy(params)


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
    heads, l2 PQ metric) at max_length 1024 and sparse_coeff 2. The JAX
    engine takes its per-slot decode kernels (decode_multislot=False: the
    same function as the all-slot ones, which test_torch_decode.py holds
    the twin to, in half the compile time), as test_torch_engine_modes.py
    does."""
    cfg = jcfg.tiny_config('opt', d_model=128, n_heads=2, d_feedforward=256,
                           vocab_size=256, max_length=MAX_LEN).replace(
        dtype=jnp.float32, pq_metric='l2', attn_impl='pallas',
        decode_multislot=False)
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


def test_upgrade_tree_matches_jax():
    """port_seeded's tree after the 'lora' and 'ffn' stages (at
    test_w8_routed_matches_jax's d_lora and ffn_block_size) has the paths,
    shapes and dtypes of JAX's surgery.upgrade (jax.eval_shape: traced, not
    run)."""
    base = jcfg.tiny_config('opt', d_model=128, n_heads=2, d_feedforward=256,
                            vocab_size=256, max_length=512).replace(
        dtype=jnp.float32, attn_impl='pallas')
    stages = dict(lora=dict(d_lora=4), ffn=dict(ffn_block_size=64))

    def jax_tree():
        cfg, params = base, surgery.init_params(base, jax.random.PRNGKey(0))
        for i, (stage, kw) in enumerate(stages.items()):
            cfg, params = surgery.upgrade(cfg, params, stage,
                                          jax.random.PRNGKey(i + 1), **kw)
        return params
    want = flat(jax.eval_shape(jax_tree))
    got = flat(port_seeded(base, tuple(stages), **stages)[1])
    assert sorted(got) == sorted(want)
    assert any('lora' in p for p in want) and any('router' in p
                                                  for p in want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        assert got[path].dtype == w.dtype, path


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


def test_routed_lora_model_decodes_as_jax():
    """A checkpoint the SPT tuning made serves: tiny OPT after the four
    stages (routed FFN + LoRA, whose factors stay unfolded so that the
    2 * prob coeff scales only the frozen path; LoRA right factors random),
    sparse over the int8 cache: prefill 512 + 8 greedy steps, the port's
    tokens equal the JAX engine's; the paged step gives the contiguous
    engine's tokens."""
    from spt_proto_tpu_torch.inference import paged as tpaged
    from spt_proto_tpu_torch.utils.tree import flatten, unflatten
    tc = tcfg.tiny_config('opt', d_model=128, n_heads=2, d_feedforward=256,
                          vocab_size=256, max_length=MAX_LEN,
                          pq_metric='l2', attn_impl='pallas')
    params = surgery_port.init_params(tc, 0, 'cpu')
    tc, params = surgery_port.full_upgrade(tc, params, 1, d_lora=4,
                                           ffn_block_size=64)
    tc = tc.replace(sparse_coeff=2)
    flat = flatten(bridge.params_to_numpy(params))
    r = np.random.RandomState(9)
    for path in flat:
        if 'lora_right' in path:
            flat[path] = (r.randn(*flat[path].shape) * 0.1).astype(np.float32)
    params = unflatten(flat)
    kw = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    kw.update(dtype=jnp.float32, param_dtype=jnp.float32,
              decode_multislot=False)
    jc = jcfg.ModelConfig(**kw)
    tokens = r.randint(1, 256, size=(B, 512)).astype(np.int32)
    j_logits, _, j_tokens = _jax_run(jc, params, tokens)
    t_logits, _, t_tokens = _port_run(jc, params, tokens)
    np.testing.assert_allclose(t_logits, j_logits, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t_tokens, j_tokens)
    iw = TIW.from_params(tc, bridge.params_from_numpy(params, 'cpu'))
    cache = tpaged.PagedKVCache.create(tc, B, 24, 64, MAX_LEN,
                                       quantized=True, device='cpu')
    cache.page_indices[:, :12] = torch.arange(24, dtype=torch.int32
                                              ).reshape(B, 12)
    logits, cache = tpaged.paged_prefill(iw, torch.from_numpy(tokens), cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    out = []
    for _ in range(STEPS):
        logits, cache = tpaged.paged_decode_step(iw, tok, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(out, 1), t_tokens)
