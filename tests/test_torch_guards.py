"""Guards on the PyTorch port itself, on the CPU: it imports neither JAX nor
the JAX package, its entry points default to CUDA and raise without it,
and on CPU tensors every kernel wrapper runs its plain twin and launches
nothing."""
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
from spt_proto_tpu_torch.ops import lm_head as tlm

REPO = Path(__file__).resolve().parents[1]

WRAPPERS = (tfront.decode_front, tattn.decode_attention_rows_q,
            tlm.lm_head_argmax, tbsa.block_sparse_attention)

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
    """A whole prefill + greedy decode on CPU tensors: every wrapper on the
    main path is reached, and none launches its kernel."""
    cfg = _tiny_cfg()
    for w in WRAPPERS:
        w.launches = 0
    iw = InferenceWeights.from_params(
        cfg, bridge.init_params(cfg, seed=0, device='cpu'))
    cache = teng.KVCache.create(cfg, 2, 512, dtype=torch.float32,
                                quantized=True, device='cpu')
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        1, cfg.vocab_size, size=(2, 256)))
    logits, cache = teng.prefill(iw, tokens, cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    for _ in range(2):
        tok, cache = teng.decode_step_greedy(iw, tok, cache)
    assert tok.dtype == torch.int32 and tok.shape == (2,)
    assert ((tok >= 0) & (tok < cfg.vocab_size)).all()
    assert cache.length.tolist() == [258, 258]
    assert [w.launches for w in WRAPPERS] == [0, 0, 0, 0]


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
    cfg = _tiny_cfg()
    params = bridge.init_params(cfg, seed=0, device='cpu')
    with pytest.raises(NotImplementedError, match='int8-weight slice'):
        InferenceWeights.from_params(cfg, params, quant='int8')
    iw = InferenceWeights.from_params(cfg, params)
    bf16_cache = teng.KVCache.create(cfg, 1, 256, device='cpu')
    with pytest.raises(NotImplementedError, match='bf16-KV'):
        teng.decode_step_greedy(iw, torch.zeros(1, dtype=torch.int32),
                                bf16_cache)
    with pytest.raises(NotImplementedError, match='LLaMA slice'):
        bridge.init_params(tcfg.tiny_config('llama'), seed=0, device='cpu')
