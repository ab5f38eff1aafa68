"""PyTorch port vs the JAX package: LLaMA serving, MHA and GQA, on the CPU.

The seeded param tree (`init_params`) and the serving weights (fp, and int8
unstaged and staged) against JAX's; the plain twins of the gated FFN tails
and of the decode front's LLaMA (RMSNorm + RoPE), GQA triple and
triple_int8 forms and OPT's biased triple against the JAX Pallas kernels
(interpret mode); and the engine's greedy tokens against the JAX engine's
in seven LLaMA decode modes. Inputs come from numpy seeds; the JAX side runs
its eager weight build and its per-slot decode kernels
(decode_multislot=False), as tests/test_torch_engine_modes.py does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu import config as jcfg
from spt_proto_tpu.inference import weights as jw
from spt_proto_tpu.layers.common import rope_cos_sin as j_rope
from spt_proto_tpu.ops.pallas import ffn_tail as jffn
from spt_proto_tpu.ops.pallas.decode_front import build_pq_bd as j_build_pq_bd
from spt_proto_tpu.ops.pallas.decode_front import decode_front as j_front
from spt_proto_tpu.tuning import surgery
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference import weights as tw
from spt_proto_tpu_torch.ops import decode_front as tfront
from spt_proto_tpu_torch.ops import ffn_tail as tffn
from test_torch_engine import flat, port_config, port_seeded
from test_torch_engine_modes import B, _run
from test_torch_int8 import as_np, t

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)

TILE = 128


def _llama(n_kv_heads=None, **kw):
    """tiny LLaMA: d_model 128, 4 heads (d_head 32, 4 PQ subspaces), 2
    layers, max_length 1024 (8 tiles a layer); GQA with 2 kv heads."""
    return jcfg.tiny_config('llama', d_model=128, n_heads=4,
                            n_kv_heads=n_kv_heads, d_feedforward=256,
                            vocab_size=256, max_length=1024, **kw).replace(
        dtype=jnp.float32, pq_metric='l2', attn_impl='pallas',
        decode_multislot=False)


def _upgrade(cfg, params):
    cfg, params = surgery.upgrade(cfg, params, 'mha_v1', jax.random.PRNGKey(1))
    return surgery.upgrade(cfg, params, 'mha_v2', jax.random.PRNGKey(2))


@pytest.fixture(scope='module')
def models():
    """{'mha' | 'gqa': ((dense cfg, params), (sparse cfg, params))}, params
    as numpy arrays seeded by the port (port_seeded); the sparse model is
    the dense one after its PQ upgrade."""
    out = {}
    for name, kvh in (('mha', None), ('gqa', 2)):
        dense, dparams = port_seeded(_llama(kvh))
        cfg, params = port_seeded(dense, ('mha_v1', 'mha_v2'))
        out[name] = ((dense, dparams), (cfg.replace(sparse_coeff=2), params))
    return out


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['mha', 'gqa'])
def test_init_params_paths_and_shapes_match_jax(models, name):
    """The port's seeded tree has the paths, shapes and dtypes of JAX's
    (jax.eval_shape of surgery.init_params, and of it after the PQ
    upgrade): no learned positions, no biases, RMSNorm scales, gate / side
    / down, k and v kv_heads x d_head wide."""
    (dense, _), (sparse, _) = models[name]
    key = jax.random.PRNGKey(0)
    j_dense = jax.eval_shape(lambda: surgery.init_params(dense, key))
    j_sparse = jax.eval_shape(
        lambda: _upgrade(dense, surgery.init_params(dense, key))[1])
    for cfg, want in ((dense, j_dense), (sparse, j_sparse)):
        want = flat(want)
        got = flat(bridge.init_params(port_config(cfg), seed=0, device='cpu'))
        assert sorted(got) == sorted(want)
        for path, w_ in want.items():
            assert tuple(got[path].shape) == tuple(w_.shape), path
            assert str(got[path].dtype).split('.')[-1] == str(w_.dtype), path
        assert want['/blocks/mha/k/kernel'].shape[-1] == \
            cfg.kv_heads * cfg.d_head


@pytest.mark.parametrize('quant', [None, 'int8'])
@pytest.mark.parametrize('name', ['mha', 'gqa'])
def test_weights_match_jax(models, name, quant):
    """from_params gives JAX's serving tree path for path: MHA fuses q/k/v
    (a [3, D, D] stack, or one packed int8 kernel), GQA keeps them apart
    (int8: each part quantized on its own). int8 leaves equal JAX's eager
    build; the port's staged int8 build equals its unstaged one."""
    cfg, params = models[name][1]
    want = flat(jw.InferenceWeights.from_params(
        cfg, jax.tree.map(jnp.asarray, params), quant=quant).params)
    pcfg = port_config(cfg)
    tparams = bridge.params_from_numpy(params, device='cpu')
    got = flat(tw.InferenceWeights.from_params(pcfg, tparams,
                                               quant=quant).params)
    assert sorted(got) == sorted(want)
    fused = '/blocks/mha/qkv/kernel' + ('/q' if quant else '')
    assert (fused in got) == (name == 'mha')
    for path, w_ in want.items():
        g_ = got[path]
        assert tuple(g_.shape) == tuple(w_.shape), path
        assert str(g_.dtype).split('.')[-1] == str(w_.dtype), path
        np.testing.assert_allclose(as_np(g_), as_np(w_), rtol=1e-6,
                                   err_msg=path)
    if quant:
        staged = flat(tw.InferenceWeights.from_params(
            pcfg, tparams, quant=quant, staged=True, device='cpu').params)
        assert sorted(staged) == sorted(got)
        for path, g_ in got.items():
            assert torch.equal(staged[path], g_), path


# ---------------------------------------------------------------------------
# kernel twins vs the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

def test_ffn_tail_gated_matches_jax_kernel():
    """d_ff 384: three tiles of 128 in the TPU kernel; 1e-5 in f32."""
    rng = np.random.RandomState(11)
    m, d, f = 5, 128, 384
    x, res = (rng.randn(m, d).astype(np.float32) for _ in range(2))
    wg, ws = ((rng.randn(d, f) * 0.1).astype(np.float32) for _ in range(2))
    wd = (rng.randn(f, d) * 0.05).astype(np.float32)
    want = np.asarray(jffn.ffn_tail_gated(
        *(jnp.asarray(a) for a in (x, res, wg, ws, wd)), interpret=True))
    args = [t(a) for a in (x, res, wg, ws, wd)]
    got = tffn.ffn_tail_gated_ref(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    n0 = tffn.ffn_tail_gated.launches
    assert torch.equal(tffn.ffn_tail_gated(*args), got)
    assert tffn.ffn_tail_gated.launches == n0 == 0


def test_ffn_tail_gated_int8_matches_jax_kernel():
    """D = 128 (wdq padded to 256) and d_ff 384 (gate/side padded to 512,
    three true-width tiles of 128): 1e-5 in f32."""
    rng = np.random.RandomState(12)
    m, d, f = 5, 128, 384
    x, res = (rng.randn(m, d).astype(np.float32) for _ in range(2))
    wg, ws = ((rng.randn(d, f) * 0.1).astype(np.float32) for _ in range(2))
    wd = (rng.randn(f, d) * 0.05).astype(np.float32)
    wq = [jw.quantize_int8(jnp.asarray(w)) for w in (wg, ws, wd)]
    assert wq[0]['q'].shape == (d, 512) and wq[2]['q'].shape == (f, 256)
    want = np.asarray(jffn.ffn_tail_gated_int8(
        jnp.asarray(x), jnp.asarray(res), *wq, interpret=True))
    args = [t(x), t(res)] + [{k: t(a) for k, a in w.items()} for w in wq]
    got = tffn.ffn_tail_gated_int8_ref(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    n0 = tffn.ffn_tail_gated_int8.launches
    assert torch.equal(tffn.ffn_tail_gated_int8(*args), got)
    assert tffn.ffn_tail_gated_int8.launches == n0 == 0


def _front_case(form, seed=0):
    """d_model 128, 4 query heads of d_head 32 (4 PQ subspaces of 16 codes),
    2 layers of 8 tiles, slots at positions 300, 129 and 1000. LLaMA forms:
    'stack' (MHA), 'triple' / 'triple_int8' (GQA, 2 kv heads), with RoPE at
    the slots' positions; 'opt-triple-bias': OPT GQA with biases (the
    ragged bias stack). Returns (JAX args, port args, kw, kv heads)."""
    rng = np.random.RandomState(seed)
    b, d, h, dh, n_sub, n_code, nt, l = 3, 128, 4, 32, 4, 16, 8, 2
    kv = h if form == 'stack' else 2
    llama = form != 'opt-triple-bias'
    x = rng.randn(b, d).astype(np.float32)
    nsc = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    nbi = None if llama else (0.1 * rng.randn(d)).astype(np.float32)
    if form == 'stack':
        w = (rng.randn(3, d, d) / np.sqrt(d)).astype(np.float32)
    else:
        w = tuple((rng.randn(d, n) / np.sqrt(d)).astype(np.float32)
                  for n in (h * dh, kv * dh, kv * dh))
    if form == 'triple_int8':
        w = tuple({k: np.asarray(a) for k, a in
                   jw.quantize_int8(jnp.asarray(p_)).items()} for p_ in w)
        assert w[1]['q'].shape == (d, 256)         # k: 64 columns -> 256
    bq = None
    if not llama:                                  # parts padded to 128
        bq = np.zeros((3, h * dh), np.float32)
        bq[0] = 0.1 * rng.randn(h * dh)
        bq[1:, :kv * dh] = 0.1 * rng.randn(2, kv * dh)
    cb = rng.randn(n_sub, n_code, 8).astype(np.float32)
    bd, cbn = (np.asarray(a) for a in j_build_pq_bd(jnp.asarray(cb)))
    # few distinct codes per subspace so pooled tile scores tie often
    cc = rng.randint(0, 3, size=(b, kv, l * nt, n_sub, TILE)).astype(np.int32)
    pos = np.array([300, 129, 1000], np.int32)
    cos = sin = None
    if llama:
        cos, sin = (np.asarray(a) for a in j_rope(jnp.asarray(pos), dh))
    arrays = [x, nsc, nbi, w, bq, bd, cbn, cc, pos]
    base = nt                                       # second layer's slab
    kw = dict(nt=nt, nsel=5, n_sub=n_sub, ps=TILE,
              eps=1e-6 if llama else 1e-5, arch='llama' if llama else 'opt')
    j_args = [jax.tree.map(jnp.asarray, a) if a is not None else None
              for a in arrays] + [jnp.full((1,), base, jnp.int32)] + [
        None if a is None else jnp.asarray(a) for a in (cos, sin)]
    t_args = [jax.tree.map(t, a) if a is not None else None
              for a in arrays] + [base] + [
        None if a is None else t(a) for a in (cos, sin)]
    return j_args, t_args, kw, kv


@pytest.mark.parametrize('form,quantized', [
    ('stack', True), ('triple', True), ('triple', False),
    ('triple_int8', True), ('triple_int8', False), ('opt-triple-bias', True)])
def test_decode_front_forms_match_jax_kernel(form, quantized):
    """The twin vs the JAX kernel: q/k/v to 1e-5 (the int8 forms to 2e-5,
    as tests/test_torch_decode.py holds packed_int8), codes and tables
    exactly equal, k8/v8
    within one int8 step, scales to f32 rounding."""
    j_args, t_args, kw, kv = _front_case(form)
    want = [np.asarray(a) for a in j_front(*j_args, quantized=quantized,
                                           **kw)]
    got = [a.numpy() for a in tfront.decode_front_ref(
        *t_args, quantized=quantized, **kw)]
    assert len(got) == len(want) == (9 if quantized else 5)
    assert got[0].shape == (3, 128) and got[1].shape == (3, kv * 32)
    tol = 2e-5 if form == 'triple_int8' else 1e-5
    for g_, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g_, w_, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got[3], want[3])          # codes
    np.testing.assert_array_equal(got[4], want[4])          # tables
    assert (want[4][:, :, :-1] >= 0).any()       # some full tile selected
    if quantized:
        for g_, w_ in zip(got[5:7], want[5:7]):             # k8 / v8
            assert np.abs(g_.astype(np.int32) - w_).max() <= 1
        for g_, w_ in zip(got[7:], want[7:]):               # scales
            np.testing.assert_allclose(g_, w_, rtol=2e-6)
    n0 = tfront.decode_front.launches
    wrapped = tfront.decode_front(*t_args, quantized=quantized, **kw)
    for a, g_ in zip(wrapped, got):
        np.testing.assert_array_equal(a.numpy(), g_)
    assert tfront.decode_front.launches == n0 == 0


# ---------------------------------------------------------------------------
# the engine: greedy tokens against the JAX engine's
# ---------------------------------------------------------------------------

# (model, attention, quantized KV, config changes, weight quantization)
MODES = {
    'gqa-sparse-fused-front-int8kv': ('gqa', 'sparse', True, {}, None),
    'gqa-sparse-unfused-l1-int8kv': ('gqa', 'sparse', True,
                                     {'pq_metric': 'l1'}, None),
    'gqa-dense-f32kv': ('gqa', 'dense', False, {}, None),
    'gqa-sparse-fused-ffn-f32kv': ('gqa', 'sparse', False,
                                   {'decode_fused_ffn': True}, None),
    # int8 weights: the triple_int8 front and the gated int8 tail (default)
    'gqa-w8-sparse-int8kv': ('gqa', 'sparse', True, {}, 'int8'),
    'mha-sparse-fused-front-f32kv': ('mha', 'sparse', False, {}, None),
    'mha-w8-sparse-int8kv': ('mha', 'sparse', True, {}, 'int8'),
}


@pytest.mark.parametrize('mode', list(MODES))
def test_llama_decode_mode_matches_jax(models, mode):
    """Prompt 512, B=2, 8 greedy steps. The tolerances of
    test_decode_mode_matches_jax: prefill logits within 1e-4 (w8 2e-2),
    caches to 1e-5 (w8 2e-2), int8 entries within one step, codes exact
    (w8: the bf16 step of its drift may flip a code at a near-tie), greedy
    tokens exactly equal. The port's RoPE tables are torch's cos / sin,
    which differ from XLA's by an ulp in a few percent of entries."""
    name, attention, quantized, changes, wquant = MODES[mode]
    cfg, params = models[name][attention == 'sparse']
    cfg = cfg.replace(**changes)
    tokens = np.random.RandomState(512).randint(
        1, cfg.vocab_size, size=(B, 512)).astype(np.int32)
    j_logits, j_cache, j_tokens = _run(cfg, params, tokens, quantized, wquant,
                                       False)
    t_logits, t_cache, t_tokens = _run(cfg, params, tokens, quantized, wquant,
                                       True)
    logit_tol, kv_tol, flips, scale_tol = (2e-2, 2e-2, 1e-3, 2e-2) \
        if wquant else (1e-4, 1e-5, 1e-4, 1e-5)
    np.testing.assert_array_equal(t_cache['length'], j_cache['length'])
    if wquant:
        # the w8 drift can move a key across an argmin near-tie of the PQ
        # encode: at most 1e-4 of the code entries (1 of 32,768 seen); the
        # prefill rows whose tile selection that changes move by more than
        # the drift: at most 1e-4 of the logits past 2e-2, none past 5e-2
        assert (t_cache['codes'] != j_cache['codes']).mean() <= 1e-4
        err = np.abs(t_logits - j_logits)
        assert (err > logit_tol).mean() <= 1e-4 and err.max() <= 5e-2
    else:
        np.testing.assert_allclose(t_logits, j_logits, atol=logit_tol,
                                   rtol=0)
        np.testing.assert_array_equal(t_cache['codes'], j_cache['codes'])
    for n in ('k', 'v'):
        got, want = t_cache[n], j_cache[n]
        assert got.shape[1] == cfg.kv_heads, n
        if quantized:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < flips, n
        else:
            np.testing.assert_allclose(got, want, atol=kv_tol, rtol=1e-5,
                                       err_msg=n)
    if quantized:
        for n in ('k_scale', 'v_scale'):
            np.testing.assert_allclose(t_cache[n], j_cache[n], rtol=scale_tol,
                                       atol=0, err_msg=n)
    np.testing.assert_array_equal(t_tokens, j_tokens)


# The gated tails' kernel plan (ffn_tail_plan, gated=True), pure Python: the
# LLaMA decode shapes take the tensor-core streams in bf16 (the gate and the
# side streamed side by side, int8 splitting the up product's K where d_ff
# alone fills at most a third of a wave), f32 and off-rule shapes the
# CUDA-core pair.
@pytest.mark.parametrize('m,f,dtype,aligned,int8,route,up_slices', [
    (8, 14336, torch.bfloat16, True, False, 'tc', 1),     # Llama-3-8B
    (8, 14336, torch.bfloat16, True, True, 'tc', 3),
    (4, 11008, torch.bfloat16, True, False, 'tc', None),  # LLaMA-7B B=4
    (4, 11008, torch.bfloat16, True, True, 'tc', None),
    (1, 14336, torch.bfloat16, True, True, 'tc', 3),
    (64, 14336, torch.bfloat16, True, False, 'tc', 1),
    (65, 11008, torch.bfloat16, True, True, 'tc', 1),
    (256, 14336, torch.bfloat16, True, True, 'tc', 1),
    (8, 14336, torch.float32, True, False, 'cuda_core', None),
    (8, 11008, torch.float32, True, True, 'cuda_core', None),
    (8, 14336, torch.bfloat16, False, True, 'cuda_core', None)], ids=str)
def test_ffn_tail_gated_plan(m, f, dtype, aligned, int8, route, up_slices):
    from spt_proto_tpu_torch.ops import weight_stream as ws
    d = 4096
    plan = tffn.ffn_tail_plan(m, d, f, dtype, aligned, gated=True, int8=int8)
    assert plan['route'] == route
    if route == 'cuda_core':
        return
    up, down = plan['up'], plan['down']
    assert up_slices is None or up['slices'] == up_slices
    for p, n_w, n_x, k in ((up, 2, 1, d), (down, 1, 2, f)):
        assert (8 // p['cw']) * p['ng'] * 8 >= m
        smem = p['stages'] * ws.stage_bytes(1 if int8 else 2, n_w, n_x,
                                            p['cw'], m)
        assert smem <= ws.MAX_SMEM
        assert (p['slices'] - 1) * p['kslice'] < k <= \
            p['slices'] * p['kslice'] and p['kslice'] % 64 == 0
