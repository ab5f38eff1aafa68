"""The port's sharded serving (spt_proto_tpu_torch/parallel) against the JAX
package's, on the CPU over gloo.

Two worlds, one test item each (each item spawns its ranks once and runs
all its cases inside, tests/torch_parallel_cases.py, one torch thread a
rank), while this process computes the JAX references on as many virtual
devices:

- 4 ranks at (data 2, model 2): generate() dense and sparse_v2, and the
  fused-front envelope case of tests/test_infer_sharding.py, against JAX's
  generate(mesh=make_mesh(2, 2)); a prefill and a decode step dense and
  sparse, each rank's logits rows within JAX's own 2e-4 and its cache shard
  within 1e-5 (codes exact); the batching engine contiguous, paged and
  speculative against JAX's ContinuousBatchingEngine(mesh=...), tokens and
  speculative stats exact; chunked prefill with the prefix cache (a slot's
  owner runs its chunks and broadcasts the last logits over 'data')
  against the port's unsharded engine.
- 2 ranks at (1, 2): generate() with int8 weights (w8), with heads, and a
  vocabulary, that 'model' does not divide (held whole on every rank), and
  LLaMA GQA over an int8 KV cache, against JAX's generate(mesh=make_mesh(1,
  2)); the greedy head's tie across the two ranks' vocabulary halves (the
  lower global index wins); sampled generate() against the port's
  unsharded run (the same draws); the HTTP server over the sharded engine
  (rank 0 serves, rank 1 follows) and cli.generate under --mesh_model
  against the unsharded engine and CLI.

Tokens are exact in f32. Every rank must return the same tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parallel_cases as cases
from spt_proto_tpu.inference import engine as jeng
from spt_proto_tpu.inference.batching import \
    ContinuousBatchingEngine as JEngine
from spt_proto_tpu.inference.weights import InferenceWeights as JIW
from spt_proto_tpu.parallel.mesh import make_mesh
from spt_proto_tpu_torch.inference import engine as teng
from spt_proto_tpu_torch.parallel import launch
from test_torch_engine import jax_config

torch.set_num_threads(1)


def _jax_weights(name, quant=None):
    cfg = jax_config(cases.config(name))
    params = jax.tree.map(lambda a: jnp.asarray(a.numpy()),
                          cases.params(name))
    kw = dict(staged=False) if quant else {}
    return JIW.from_params(cfg, params, quant=quant, dtype=jnp.float32,
                           **kw)


def _jax_gen(name, mesh):
    model, quant, b, s, n, max_len, kv8 = cases.GEN_CASES[name]
    iw = _jax_weights(model, quant)
    p = jnp.asarray(cases.prompts(iw.cfg.vocab_size, b, s, 2), jnp.int32)
    return np.asarray(jeng.generate(iw, p, n, max_len=max_len,
                                    quantized_kv=kv8, mesh=mesh))


def _jax_step(name):
    iw = _jax_weights(name)
    tokens = jnp.asarray(np.random.RandomState(1).randint(
        0, iw.cfg.vocab_size, size=(4, 8)), jnp.int32)
    cache = jeng.KVCache.create(iw.cfg, 4, 16, dtype=jnp.float32)
    lg, cache = jax.jit(jeng.prefill)(iw, tokens, cache)
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
    dec, cache = jax.jit(jeng.decode_step)(iw, tok, cache)
    return dict(prefill=np.asarray(lg), decode=np.asarray(dec),
                k=np.asarray(cache.k), v=np.asarray(cache.v),
                codes=np.asarray(cache.codes))


def _jax_serve(mode, mesh):
    model, kw = cases.ENGINE_MODES[mode]
    iw = _jax_weights(model)
    reqs, n = cases.traffic(mode, iw.cfg.vocab_size)
    eng = JEngine(iw, n_slots=2, max_len=64, prefill_bucket=16, mesh=mesh,
                  **kw)
    rids = [eng.submit(p, max_new_tokens=n) for p in reqs]
    done = {c.request_id: c.tokens for c in eng.run_until_done()}
    return [list(map(int, done[r])) for r in rids], dict(eng.spec_stats)


def _same_on_every_rank(res, key):
    for r in res[1:]:
        np.testing.assert_array_equal(np.asarray(r[key], dtype=object),
                                      np.asarray(res[0][key], dtype=object),
                                      err_msg=key)
    return res[0][key]


def test_world_of_four_data2_model2():
    world = launch.start(cases.world, 4, (2, 2), threads=1, timeout=600)
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    want = {f'gen/{c}': _jax_gen(c, mesh) for c in cases.WORLD_GEN[4]}
    steps = {name: _jax_step(name) for name in ('dense', 'sparse')}
    engines = {mode: _jax_serve(mode, mesh) for mode in cases.ENGINE_MODES}
    chunked = cases.serve_chunked()
    res = world.join()

    for key, ref in want.items():
        np.testing.assert_array_equal(_same_on_every_rank(res, key), ref,
                                      err_msg=key)
    for name, ref in steps.items():
        for rank in res:
            got = rank[f'step/{name}']
            r0, nr = got['rows']
            h0, nh = got['heads']
            rows, hs = slice(r0, r0 + nr), slice(h0, h0 + nh)
            for k in ('prefill', 'decode'):
                np.testing.assert_allclose(got[k], ref[k][rows], atol=2e-4,
                                           err_msg=f'{name} {k}')
            for k in ('k', 'v'):
                np.testing.assert_allclose(got[k], ref[k][rows, hs],
                                           atol=1e-5, err_msg=f'{name} {k}')
            np.testing.assert_array_equal(got['codes'],
                                          ref['codes'][rows, hs])
    for mode, (tokens, stats) in engines.items():
        for rank in res:
            got_tokens, got_stats = rank[f'engine/{mode}']
            assert got_tokens == tokens, (mode, got_tokens, tokens)
            assert got_stats == stats, (mode, got_stats, stats)
    assert chunked[1] == 2
    for rank in res:
        assert rank['engine/chunked'] == chunked, (rank['engine/chunked'],
                                                   chunked)


def test_world_of_two_model2():
    from spt_proto_tpu_torch.cli import generate as tgen
    world = launch.start(cases.world, 2, (1, 2), threads=1, timeout=600)
    mesh = make_mesh(1, 2, devices=jax.devices()[:2])
    want = {f'gen/{c}': _jax_gen(c, mesh) for c in cases.WORLD_GEN[2]}
    sampled = teng.generate(
        cases.weights('sparse'), torch.from_numpy(cases.prompts(256, 4, 6, 3)),
        8, max_len=64, temperature=0.8, top_k=20).numpy()
    served = cases.serve_reference()
    cli = tgen.main(cases.CLI_ARGS)
    res = world.join()

    for key, ref in want.items():
        np.testing.assert_array_equal(_same_on_every_rank(res, key), ref,
                                      err_msg=key)
    for rank in res:
        assert rank['tie']['head'] and rank['tie']['got'] == \
            rank['tie']['want'] == [5, cases.config('dense').vocab_size // 2
                                    + 1], rank['tie']
    np.testing.assert_array_equal(_same_on_every_rank(res, 'sampled'),
                                  sampled)
    assert res[0]['serve'] == served, (res[0]['serve'], served)
    assert all(rank['cli'] == cli for rank in res), ([r['cli'] for r in res],
                                                     cli)
