"""Guards on the PyTorch port itself, on the CPU: it imports neither JAX nor
the JAX package, its entry points default to CUDA and raise without it,
and on CPU tensors every kernel wrapper runs its plain twin and launches
nothing."""
import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from spt_proto_tpu_torch import config as tcfg
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference import engine as teng
from spt_proto_tpu_torch.inference.weights import InferenceWeights
from spt_proto_tpu_torch.ops import block_sparse_attention as tbsa
from spt_proto_tpu_torch.ops import decode_attention as tattn
from spt_proto_tpu_torch.ops import decode_front as tfront
from spt_proto_tpu_torch.ops import ffn_tail as tffn
from spt_proto_tpu_torch.ops import int8_matmul as tmm
from spt_proto_tpu_torch.ops import lm_head as tlm

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

WRAPPERS = (tfront.decode_front, tattn.decode_attention_rows_q,
            tlm.lm_head_argmax, tbsa.block_sparse_attention,
            tattn.decode_attention_rows, tffn.ffn_tail, tmm.int8_matmul,
            tlm.lm_head_argmax_int8, tffn.ffn_tail_int8, tffn.ffn_tail_gated,
            tffn.ffn_tail_gated_int8, tattn.verify_attention_rows)

_IMPORT_CHECK = """
import importlib, pkgutil, sys
import spt_proto_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ('jax', 'jaxlib', 'flax', 'spt_proto_tpu')
             or m.startswith(('jax.', 'jaxlib.', 'flax.', 'spt_proto_tpu.')))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, '-c', _IMPORT_CHECK], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 12     # every module was imported


def _tiny_cfg():
    return tcfg.tiny_config('opt', d_model=128, n_heads=2, d_feedforward=256,
                            vocab_size=256, max_length=512,
                            attention='sparse_v2', pq_metric='l2',
                            attn_impl='pallas')


def _tiny_llama_gqa():
    return tcfg.tiny_config('llama', d_model=128, n_heads=4, n_kv_heads=2,
                            d_feedforward=256, vocab_size=256,
                            max_length=512, attention='sparse_v2',
                            pq_metric='l2', attn_impl='pallas')


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bridge.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bridge.params_from_numpy({'w': np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match='no CUDA device'):
        teng.KVCache.create(cfg, 1, 256, quantized=True)


def test_cpu_path_runs_the_plain_twins_and_launches_nothing():
    """Prefill + greedy decode + a speculative verify block on CPU tensors,
    sparse over an int8 cache, dense over an f32 cache with the fused FFN
    tail, and sparse int8-KV with int8 weights, for OPT and for a LLaMA GQA
    model (its gated tails): every kernel wrapper is reached, and none
    launches its kernel."""
    for w in WRAPPERS:
        w.launches = 0
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        1, 256, size=(2, 256)))
    for cfg, quantized, quant in (
            (_tiny_cfg(), True, None),
            (_tiny_cfg().replace(attention='dense', decode_fused_ffn=True),
             False, None),
            (_tiny_cfg(), True, 'int8'),
            (_tiny_llama_gqa().replace(decode_fused_ffn=True), False, None),
            (_tiny_llama_gqa(), True, 'int8')):
        iw = InferenceWeights.from_params(
            cfg, bridge.init_params(cfg, seed=0, device='cpu'), quant=quant)
        cache = teng.KVCache.create(cfg, 2, 512, dtype=torch.float32,
                                    quantized=quantized, device='cpu')
        logits, cache = teng.prefill(iw, tokens, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        for _ in range(2):
            tok, cache = teng.decode_step_greedy(iw, tok, cache)
        assert tok.dtype == torch.int32 and tok.shape == (2,)
        assert ((tok >= 0) & (tok < cfg.vocab_size)).all()
        assert cache.length.tolist() == [258, 258]
        logits, cache = teng.verify_step(iw, tokens[:, :3], cache)
        assert logits.shape == (2, 3, cfg.vocab_size)
        assert cache.length.tolist() == [261, 261]
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_settings_that_would_run_plain_pytorch_on_the_gpu_raise():
    """attn_impl other than 'pallas' or an unfused head would run plain
    PyTorch on CUDA tensors: the engine refuses them there (checked on a
    cache that reports a CUDA device) and runs the twins on the CPU."""
    params = bridge.init_params(_tiny_cfg(), seed=0, device='cpu')
    card = types.SimpleNamespace(device=torch.device('cuda'))
    card_cache = teng.KVCache(k=card, v=card, codes=card, length=card,
                              k_scale=card, v_scale=card)
    tokens = torch.ones((1, 256), dtype=torch.int64)
    for cfg in (_tiny_cfg().replace(attn_impl='ref'),
                _tiny_cfg().replace(decode_fused_head=False)):
        iw = InferenceWeights.from_params(cfg, params)
        if cfg.attn_impl != 'pallas':
            with pytest.raises(NotImplementedError, match='attn_impl'):
                teng.prefill(iw, tokens, card_cache)
        with pytest.raises(NotImplementedError, match='attn_impl|fused'):
            teng.decode_step_greedy(iw, tokens[:, 0], card_cache)
        cache = teng.KVCache.create(cfg, 1, 512, dtype=torch.float32,
                                    quantized=True, device='cpu')
        logits, cache = teng.prefill(iw, tokens, cache)
        tok, cache = teng.decode_step_greedy(iw, tokens[:, 0], cache)
        assert tok.shape == (1,) and cache.length.tolist() == [257]


def test_unported_forms_raise_not_implemented():
    """What a later slice brings raises and names its slice: the routed FFN
    (training slice), in init_params, the int8 weight build and the engine.
    What earlier slices brought runs: a bf16/f32 KV cache, int8 weights,
    and a tiny LLaMA GQA model that builds int8 weights (the triple_int8
    form) and decodes a step on the CPU."""
    cfg = _tiny_cfg()
    params = bridge.init_params(cfg, seed=0, device='cpu')
    with pytest.raises(NotImplementedError, match='training slice'):
        bridge.init_params(cfg.replace(ffn='routed'), seed=0, device='cpu')
    router = {'kernel': torch.zeros(2, 128, 4)}
    routed = {**params, 'blocks': {**params['blocks'], 'ffn': {
        **params['blocks']['ffn'], 'router': router}}}
    with pytest.raises(NotImplementedError, match='training slice'):
        InferenceWeights.from_params(cfg, routed, quant='int8')
    cache = teng.KVCache.create(cfg, 1, 256, device='cpu')
    tok = torch.zeros(1, dtype=torch.int32)
    iw = InferenceWeights.from_params(cfg, params)
    bad = dataclasses.replace(iw, cfg=cfg.replace(ffn='routed'))
    with pytest.raises(NotImplementedError, match='training slice'):
        teng.decode_step_greedy(bad, tok, cache)
    tok, cache = teng.decode_step_greedy(iw, tok, cache)
    assert cache.length.tolist() == [1]
    int8_weights = InferenceWeights.from_params(cfg, params, quant='int8')
    tok, cache = teng.decode_step_greedy(int8_weights, tok, cache)
    assert cache.length.tolist() == [2]
    llama = _tiny_llama_gqa()
    iw8 = InferenceWeights.from_params(
        llama, bridge.init_params(llama, seed=0, device='cpu'), quant='int8')
    mha = iw8.params['blocks']['mha']
    assert 'qkv' not in mha and all(
        mha[n]['kernel']['q'].dtype == torch.int8 for n in ('q', 'k', 'v'))
    cache = teng.KVCache.create(llama, 1, 256, quantized=True, device='cpu')
    tok, cache = teng.decode_step_greedy(
        iw8, torch.zeros(1, dtype=torch.int32), cache)
    assert cache.length.tolist() == [1] and 0 <= int(tok) < 256


def test_decode_attention_refuses_tables_past_its_envelope(monkeypatch):
    """On the card a table whose scores outgrow the kernel's shared memory
    raises RuntimeError naming the limit; it never runs the plain twin.
    (Checked on CPU tensors reported as CUDA ones: the check comes before
    the build.)"""
    monkeypatch.setattr(tattn._build, 'on_cuda', lambda *ts: True)
    b, kv, d, ps, t_max = 1, 2, 64, 128, 400
    q = torch.zeros((b, kv, 1, d))
    k = torch.zeros((b, kv, t_max, d, ps))
    codes = torch.zeros((b, kv, t_max, 1, ps), dtype=torch.int32)
    tables = torch.arange(t_max, dtype=torch.int32)[None, None]
    ints = torch.zeros((b,), dtype=torch.int32)
    with pytest.raises(RuntimeError, match='kernel envelope of 204800 B'):
        tattn.decode_attention_rows(
            q, k, k.clone(), codes, tables, ints + t_max, ints,
            torch.zeros((b, kv, d)), torch.zeros((b, kv, d)),
            torch.zeros((b, kv, 1), dtype=torch.int32))
    assert tattn.decode_attention_rows.launches == 0


def test_generate_with_a_mesh_raises_and_names_its_slice():
    """Tensor-parallel generate() comes with the parallelism slice."""
    cfg = _tiny_cfg()
    iw = InferenceWeights.from_params(
        cfg, bridge.init_params(cfg, seed=0, device='cpu'))
    with pytest.raises(NotImplementedError, match='parallelism slice'):
        teng.generate(iw, torch.ones((1, 4), dtype=torch.int64), 2,
                      mesh=object())


def test_verify_refuses_plain_attention_on_the_gpu_and_rows_past_its_envelope(
        monkeypatch):
    """On the card a bf16/f32 cache verifies only through the kernel:
    verify_step(impl='jnp') there raises (checked on a cache that reports a
    CUDA device), and the int8 cache, which has no kernel, refuses
    impl='kernel'. A query row count whose buffers outgrow the kernel's
    shared memory raises RuntimeError naming the limit and never runs the
    plain twin (CPU tensors reported as CUDA ones: the check comes before
    the build)."""
    iw = InferenceWeights.from_params(
        _tiny_cfg(), bridge.init_params(_tiny_cfg(), seed=0, device='cpu'))
    card = types.SimpleNamespace(device=torch.device('cuda'))
    card_cache = teng.KVCache(k=card, v=card, codes=card,
                              length=torch.zeros(1, dtype=torch.int32))
    block = torch.ones((1, 3), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="impl='kernel'"):
        teng.verify_step(iw, block, card_cache, impl='jnp')
    cache = teng.KVCache.create(_tiny_cfg(), 1, 256, quantized=True,
                                device='cpu')
    with pytest.raises(ValueError, match='impl=jnp'):
        teng.verify_step(iw, block, cache, impl='kernel')
    monkeypatch.setattr(tattn._build, 'on_cuda', lambda *ts: True)
    b, kv, d, ps, kk, g = 1, 1, 128, 128, 30, 8
    q = torch.zeros((b, kv, g * kk, d))
    k = torch.zeros((b, kv, 4, d, ps))
    codes = torch.zeros((b, kv, 4, 1, ps), dtype=torch.int32)
    tables = torch.tensor([[[0, 1, 1]]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match='kernel envelope of 204800 B'):
        tattn.verify_attention_rows(
            q, k, k.clone(), codes, tables, torch.ones_like(tables),
            torch.zeros((b,), dtype=torch.int32), torch.zeros((b, kv, d, kk)),
            torch.zeros((b, kv, d, kk)),
            torch.zeros((b, kv, 1, kk), dtype=torch.int32))
    assert tattn.verify_attention_rows.launches == 0
