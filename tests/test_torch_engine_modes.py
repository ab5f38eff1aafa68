"""PyTorch port vs the JAX package: every decode mode of the serving engine
on the CPU, beyond the int8-KV fused-front path of test_torch_engine.py.

Dense attention and PQ-sparse attention through the fused front (l2) and
the unfused front (l1, and l2 with two heads per table row), over an f32 or
an int8 KV cache, and the fused FFN tail, with fp weights or int8
weight-only ones (w8: the packed-int8 front, int8_matmul projections, the
int8 FFN tail and the int8 lm_head). The JAX engine runs its Pallas
kernels in interpret mode; the port, handed CPU tensors, runs its plain
twins. Both start from the same parameters and the same numpy prompts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu import config as jcfg
from spt_proto_tpu.inference import engine as jeng
from spt_proto_tpu.inference.weights import InferenceWeights as JIW
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference import engine as teng
from spt_proto_tpu_torch.inference.weights import InferenceWeights as TIW
from test_torch_engine import port_config, port_seeded

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)

B, MAX_LEN, STEPS = 2, 1024, 8


@pytest.fixture(scope='module')
def models():
    """test_torch_engine.py's recipe (d_model 128, two heads, max_length
    1024: 8 tiles per layer, so dense decode walks supertiles of 4), before
    and after the PQ upgrade, seeded by the port (port_seeded). The JAX
    engine takes its per-slot decode kernels (decode_multislot=False),
    which compute the same function as the all-slot ones and compile in
    half the time; the port has one kernel for both launch shapes."""
    dense = jcfg.tiny_config('opt', d_model=128, n_heads=2, d_feedforward=256,
                             vocab_size=256, max_length=MAX_LEN).replace(
        dtype=jnp.float32, pq_metric='l2', attn_impl='pallas',
        decode_multislot=False)
    dense, dparams = port_seeded(dense)
    cfg, params = port_seeded(dense, ('mha_v1', 'mha_v2'))
    return ((dense, dparams), (cfg.replace(sparse_coeff=2), params))


def _run(cfg, params, tokens, quantized, wquant, port):
    if port:
        cfg = port_config(cfg)
        iw = TIW.from_params(cfg, bridge.params_from_numpy(params,
                                                           device='cpu'),
                             quant=wquant)
        cache = teng.KVCache.create(cfg, B, MAX_LEN, dtype=torch.float32,
                                    quantized=quantized, device='cpu')
        logits, cache = teng.prefill(iw, torch.from_numpy(tokens), cache)
        step, argmax = teng.decode_step_greedy, torch.argmax
    else:
        # device arrays: JAX's eager build (its staged one, the default for
        # a host tree, jit-compiles every leaf)
        iw = JIW.from_params(cfg, jax.tree.map(jnp.asarray, params),
                             quant=wquant)
        cache = jeng.KVCache.create(cfg, B, MAX_LEN, dtype=jnp.float32,
                                    quantized=quantized)
        logits, cache = jax.jit(jeng.prefill)(iw, jnp.asarray(tokens), cache)
        step, argmax = jax.jit(jeng.decode_step_greedy), jnp.argmax
    names = ('k', 'v', 'codes', 'length') + (
        ('k_scale', 'v_scale') if quantized else ())
    after_prefill = {n: np.array(getattr(cache, n)) for n in names}
    tok = argmax(logits[:, -1], -1)
    tok = tok.to(torch.int32) if port else tok.astype(jnp.int32)
    out = []
    for _ in range(STEPS):
        tok, cache = step(iw, tok, cache)
        out.append(np.asarray(tok))
    return np.asarray(logits), after_prefill, np.stack(out, 1)


# (attention, quantized KV, config changes, prompt, weight quantization)
MODES = {
    'dense-f32kv': ('dense', False, {}, 512, None),
    'dense-int8kv': ('dense', True, {}, 512, None),
    'sparse-fused-front-f32kv': ('sparse', False, {}, 512, None),
    'sparse-fused-front-f32kv-prompt300': ('sparse', False, {}, 300, None),
    'sparse-unfused-l1-int8kv': ('sparse', True, {'pq_metric': 'l1'}, 512,
                                 None),
    'sparse-unfused-l2-select2-f32kv': (
        'sparse', False, {'sparse_select_heads': 2}, 512, None),
    'sparse-fused-ffn-int8kv': (
        'sparse', True, {'decode_fused_ffn': True}, 512, None),
    # int8 weights: the FFN tail is fused by default (decode_fused_ffn None)
    'w8-sparse-fused-front-int8kv': ('sparse', True, {}, 512, 'int8'),
    'w8-sparse-fused-front-unfused-ffn-int8kv': (
        'sparse', True, {'decode_fused_ffn': False}, 512, 'int8'),
    'w8-dense-f32kv': ('dense', False, {}, 512, 'int8'),
}


@pytest.mark.parametrize('mode', list(MODES))
def test_decode_mode_matches_jax(models, mode):
    """Prefill logits within 1e-4, prefill caches equal (f32 entries to
    1e-5, int8 entries within one step: XLA's CPU dot and torch sum the
    projections in different orders), and greedy tokens exactly equal over
    8 steps.

    With int8 weights every projection rounds its input to bf16 first
    (int8_matmul's numerics): the ulp by which XLA's and torch's layernorm
    sums may differ then becomes a whole bf16 step (2^-8 relative) for a
    value that sits on a rounding boundary, and moves that row's
    projections and what follows them by up to ~1e-2. So w8 modes hold
    logits, f32 caches and int8 scales to 2e-2 and int8 cache entries to
    one step in 1e-3 of them; codes and greedy tokens stay exact."""
    attention, quantized, changes, prompt, wquant = MODES[mode]
    cfg, params = models[attention == 'sparse']
    cfg = cfg.replace(**changes)
    tokens = np.random.RandomState(prompt).randint(
        1, cfg.vocab_size, size=(B, prompt)).astype(np.int32)
    j_logits, j_cache, j_tokens = _run(cfg, params, tokens, quantized, wquant,
                                       False)
    t_logits, t_cache, t_tokens = _run(cfg, params, tokens, quantized, wquant,
                                       True)
    logit_tol, kv_tol, flips, scale_tol = (2e-2, 2e-2, 1e-3, 2e-2) \
        if wquant else (1e-4, 1e-5, 1e-4, 1e-5)
    np.testing.assert_allclose(t_logits, j_logits, atol=logit_tol, rtol=0)
    for name in ('codes', 'length'):
        np.testing.assert_array_equal(t_cache[name], j_cache[name],
                                      err_msg=name)
    for name in ('k', 'v'):
        got, want = t_cache[name], j_cache[name]
        if quantized:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < flips, name
        else:
            np.testing.assert_allclose(got, want, atol=kv_tol, rtol=1e-5,
                                       err_msg=name)
    if quantized:
        for name in ('k_scale', 'v_scale'):
            np.testing.assert_allclose(t_cache[name], j_cache[name],
                                       rtol=scale_tol, atol=0, err_msg=name)
    np.testing.assert_array_equal(t_tokens, j_tokens)


def test_w8_routed_matches_jax():
    """int8 weights (w8) over a routed + LoRA checkpoint: the int8 builds
    keep the routed FFN's kernels fp (block views, LoRA separate) and its
    router, and quantize q/k/v (packed) / o and the lm_head, as JAX's do;
    the eager and staged port builds give one tree. Prefill + 8 greedy
    steps over an f32 cache against the JAX engine: logits to the standing
    w8 bound of 2e-2 (see test_decode_mode_matches_jax), tokens exact."""
    from spt_proto_tpu_torch.utils.tree import flatten
    base = jcfg.tiny_config('opt', d_model=128, n_heads=2, d_feedforward=256,
                            vocab_size=256, max_length=512).replace(
        dtype=jnp.float32, attn_impl='pallas', decode_multislot=False)
    cfg, params = port_seeded(base, ('lora', 'ffn'), lora=dict(d_lora=4),
                              ffn=dict(ffn_block_size=64))
    r = np.random.RandomState(3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (r.randn(*v.shape) * 0.1).astype(np.float32)
        if 'lora_right' in jax.tree_util.keystr(p) else np.asarray(v),
        params)
    tokens = np.random.RandomState(4).randint(1, 256, (B, 160)).astype(
        np.int32)
    jiw = JIW.from_params(cfg, jax.tree.map(jnp.asarray, params),
                          quant='int8')
    cache = jeng.KVCache.create(cfg, B, 512, dtype=jnp.float32)
    j_logits, cache = jax.jit(jeng.prefill)(jiw, jnp.asarray(tokens), cache)
    tok = jnp.argmax(j_logits[:, -1], -1).astype(jnp.int32)
    step, j_tokens = jax.jit(jeng.decode_step_greedy), []
    for _ in range(STEPS):
        tok, cache = step(jiw, tok, cache)
        j_tokens.append(np.asarray(tok))
    tc = port_config(cfg)
    trees = []
    for staged in (False, True):
        iw = TIW.from_params(tc, bridge.params_from_numpy(params, 'cpu'),
                             quant='int8', staged=staged)
        ffn = iw.params['blocks']['ffn']
        assert ffn['fc1']['kernel'].dtype == torch.float32
        assert 'lora_left' in ffn['fc1'] and 'router' in ffn
        assert iw.params['blocks']['mha']['qkv']['kernel']['q'].dtype == \
            torch.int8
        assert iw.params['lm_head']['kernel']['q'].dtype == torch.int8
        trees.append(flatten(iw.params))
        cache = teng.KVCache.create(tc, B, 512, dtype=torch.float32,
                                    device='cpu')
        logits, cache = teng.prefill(iw, torch.from_numpy(tokens), cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        out = []
        for _ in range(STEPS):
            tok, cache = teng.decode_step_greedy(iw, tok, cache)
            out.append(tok.numpy())
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   atol=2e-2, rtol=0)
        np.testing.assert_array_equal(np.stack(out, 1),
                                      np.stack(j_tokens, 1))
    assert trees[0].keys() == trees[1].keys()
    assert all(torch.equal(trees[0][k], trees[1][k]) for k in trees[0])
