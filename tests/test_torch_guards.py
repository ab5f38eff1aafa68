"""Guards on the PyTorch port itself, on the CPU: it imports neither JAX nor
the JAX package, its entry points default to CUDA and raise without it,
and on CPU tensors every kernel wrapper runs its plain twin and launches
nothing."""
import re
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
from spt_proto_tpu_torch.inference import paged as tpaged
from spt_proto_tpu_torch.inference.batching import ContinuousBatchingEngine
from spt_proto_tpu_torch.inference.weights import InferenceWeights
from spt_proto_tpu_torch.ops import block_sparse_attention as tbsa
from spt_proto_tpu_torch.ops import decode_attention as tattn
from spt_proto_tpu_torch.ops import decode_front as tfront
from spt_proto_tpu_torch.ops import ffn_tail as tffn
from spt_proto_tpu_torch.ops import gmm as tgmm
from spt_proto_tpu_torch.ops import int8_matmul as tmm
from spt_proto_tpu_torch.ops import lm_head as tlm
from spt_proto_tpu_torch.ops import paged_attention as tpa

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

WRAPPERS = (tfront.decode_front, tattn.decode_attention_rows_q,
            tlm.lm_head_argmax, tbsa.block_sparse_attention,
            tattn.decode_attention_rows, tffn.ffn_tail, tmm.int8_matmul,
            tlm.lm_head_argmax_int8, tffn.ffn_tail_int8, tffn.ffn_tail_gated,
            tffn.ffn_tail_gated_int8, tattn.verify_attention_rows,
            tpa.paged_attention, tattn.decode_attention,
            tbsa.block_sparse_attention_lse, tbsa.block_sparse_attention_dq,
            tbsa.block_sparse_attention_dkv, tmm.int8_matmul_t, tgmm.gmm,
            tgmm.tgmm)

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
    # every module was imported, the serving stack's among them
    assert int(out.stdout.split()[-1]) >= 20
    for name in ('inference/paged.py', 'inference/batching.py',
                 'inference/server.py', 'cli/serve.py',
                 'ops/paged_attention.py', 'ops/gmm.py', 'ops/routed_ffn.py',
                 'ops/int8_matmul.py', 'parallel/mesh.py', 'parallel/comm.py',
                 'parallel/sharding.py', 'parallel/infer_sharding.py',
                 'parallel/launch.py'):
        src = (REPO / 'spt_proto_tpu_torch' / name).read_text()
        assert 'import torch' in src or name in ('inference/server.py',
                                                 'parallel/launch.py'), name
        assert 'jax' not in src.replace('spt_proto_tpu_torch', ''), name
        assert 'spt_proto_tpu.' not in src.replace('spt_proto_tpu_torch',
                                                   ''), name
    # the command line and the data path: plain Python and numpy where
    # they need no tensor, never the JAX package
    for name in CLI_AND_DATA:
        src = (REPO / 'spt_proto_tpu_torch' / name).read_text()
        assert 'jax' not in src.replace('spt_proto_tpu_torch', ''), name
        assert 'spt_proto_tpu.' not in src.replace('spt_proto_tpu_torch',
                                                   ''), name


CLI_AND_DATA = ('data/transform.py', 'data/reader.py', 'data/mmlu.py',
                'data/datamodule.py', 'cli/generate.py',
                'cli/bench_serving.py', 'cli/convert.py', 'cli/model_info.py',
                'cli/dump_delta.py', 'cli/svd_rank.py', 'cli/evaluate.py',
                'cli/tune.py', 'utils/convert_hf.py', 'utils/metrics.py')
HUB_NAMES = ('facebook/', 'meta-llama/', 'princeton-nlp/', 'huggingface.co')


def test_no_download_from_the_port_or_chip_smoke():
    """Every from_pretrained( call in the port passes local_files_only=True
    (local directories only: no machine here reaches a hub); no port module
    or chip_smoke.py names a hub model; chip_smoke.py never imports
    transformers (the card's machine has none), and neither does any port
    module at import time."""
    calls = 0
    for path in sorted((REPO / 'spt_proto_tpu_torch').rglob('*.py')):
        src = path.read_text()
        assert not any(h in src for h in HUB_NAMES), path
        assert not re.search(r'^(import|from) (transformers|tokenizers)\b',
                             src, re.M), path
        for m in re.finditer(r'from_pretrained\(', src):
            depth, i = 1, m.end()
            while depth:
                depth += {'(': 1, ')': -1}.get(src[i], 0)
                i += 1
            assert 'local_files_only=True' in src[m.end():i], \
                f'{path}: {src[m.start():i]}'
            calls += 1
    assert calls >= 4           # generate, serve, convert, datamodule
    smoke = (REPO / 'chip_smoke.py').read_text()
    assert not re.search(r'^\s*(import|from) (transformers|tokenizers)\b',
                         smoke, re.M)
    assert 'from_pretrained' not in smoke
    assert not any(h in smoke for h in HUB_NAMES)


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
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tpaged.PagedKVCache.create(cfg, 1, 4, 64, 256)


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
    """What a later slice brings raises and names its slice: ffn_impl='ep'
    (expert parallelism), a training mesh (the trainer's mesh, fsdp and
    pp sharding, tune's mesh flags), context parallelism (the attention
    layer, n_sp > 1) and pipeline stages (n_pipe > 1). What this and
    earlier slices brought runs, and no NotImplementedError is left for it
    (the serving mesh among it: tests/test_torch_parallel.py): dense
    attention
    under attn_impl='pallas' (the flash kernels; their twins here, a CUDA
    tensor the kernel checks refuse only for a shape they do not take, such
    as d_head 16), remat_policy='dots', int8 weights over a routed + LoRA
    FFN (the FFN's block views stay fp), an int8_base model (with its
    frozen8 tree; without it, a ValueError), ffn_impl 'gmm' and 'gather',
    the routed FFN with LoRA in init_params and the engine, a bf16/f32 KV
    cache, int8 weights, and a tiny LLaMA GQA model that builds int8
    weights (the triple_int8 form) and decodes a step on the CPU."""
    from spt_proto_tpu_torch.cli import bench_serving, generate, tune
    from spt_proto_tpu_torch.models.decoder import DecoderLM
    from spt_proto_tpu_torch.ops import flash_attention as fa
    from spt_proto_tpu_torch.tuning import surgery, trainer
    cfg = _tiny_cfg()
    params = bridge.init_params(cfg, seed=0, device='cpu')
    rcfg = cfg.replace(ffn='routed', ffn_block_size=64, d_lora=4)
    routed = bridge.init_params(rcfg, seed=0, device='cpu')
    assert routed['blocks']['ffn']['router']['kernel'].shape == (2, 128, 4)
    tokens = torch.ones((1, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match='parallelism slice'):
        DecoderLM(rcfg.replace(ffn_impl='ep'), routed)
    for impl in ('gmm', 'gather', 'masked'):
        out = DecoderLM(rcfg.replace(ffn_impl=impl), routed)(tokens)
        assert out['logits'].shape == (1, 8, 256)
    c8, small, frozen8 = surgery.split_int8_base(rcfg, routed)
    assert DecoderLM(c8, small, frozen8=frozen8)(tokens)['logits'].shape == \
        (1, 8, 256)
    with pytest.raises(ValueError, match='frozen8'):
        DecoderLM(c8, small)(tokens)
    with pytest.raises(ValueError, match="'masked' or 'gmm'"):
        DecoderLM(c8.replace(ffn_impl='gather'), small, frozen8=frozen8)
    dense = cfg.replace(attention='dense')
    dense_params = bridge.init_params(dense, seed=0, device='cpu')
    assert DecoderLM(dense, dense_params)(torch.ones(
        (1, 128), dtype=torch.int64))['logits'].shape == (1, 128, 256)
    dots = dense.replace(remat=True, remat_policy='dots')
    assert DecoderLM(dots, dense_params)(tokens)['logits'].shape == \
        (1, 8, 256)
    q = torch.zeros((1, 4, 128, 16))
    with pytest.raises(ValueError, match='d_head 64 or 128'):
        fa._check_kernel(q, q, q, True)
    from spt_proto_tpu_torch.layers.attention import MultiheadAttention
    from spt_proto_tpu_torch.parallel import mesh as pmesh
    from spt_proto_tpu_torch.parallel import sharding
    for flags in (['--mesh_model', '2'], ['--fsdp']):
        with pytest.raises(NotImplementedError, match='training-mesh slice'):
            tune.main(['--device', 'cpu', '--config', 'tiny-opt', '--out',
                       'unused'] + flags)
    with pytest.raises(NotImplementedError, match='training-mesh slice'):
        trainer.train_loop(rcfg, routed, [], mesh=object())
    with pytest.raises(NotImplementedError, match='training-mesh slice'):
        sharding.shard_params(object(), params, fsdp=True)
    with pytest.raises(NotImplementedError, match='pipeline slice'):
        sharding.shard_params(object(), params, pp=True)
    with pytest.raises(NotImplementedError, match='context-parallelism'):
        pmesh.make_mesh(1, 1, n_sp=2)
    with pytest.raises(NotImplementedError, match='pipeline slice'):
        pmesh.make_mesh(1, 1, n_pipe=2)
    with pytest.raises(NotImplementedError, match='context-parallelism'):
        MultiheadAttention(cfg.replace(context_parallel=True))
    # the serving CLIs take the mesh flags now: without --mesh_model a
    # stray --mesh_data is refused, not dropped
    for cli, flags in ((generate, ['--prompt_ids', '1,2']),
                       (bench_serving, [])):
        with pytest.raises(ValueError, match='--mesh_data needs'):
            cli.main(['--device', 'cpu', '--config', 'tiny-opt',
                      '--mesh_data', '2'] + flags)
    w8_routed = InferenceWeights.from_params(rcfg, routed, quant='int8')
    tok_w8, _ = teng.decode_step_greedy(
        w8_routed, torch.zeros(1, dtype=torch.int32),
        teng.KVCache.create(rcfg, 1, 256, device='cpu'))
    assert 0 <= int(tok_w8) < 256
    cache = teng.KVCache.create(cfg, 1, 256, device='cpu')
    tok = torch.zeros(1, dtype=torch.int32)
    iw_r = InferenceWeights.from_params(rcfg, routed)
    assert 'lora_left' in iw_r.params['blocks']['ffn']['fc1']
    tok_r, cache_r = teng.decode_step_greedy(
        iw_r, tok, teng.KVCache.create(rcfg, 1, 256, device='cpu'))
    assert cache_r.length.tolist() == [1]
    iw = InferenceWeights.from_params(cfg, params)
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
    """A table whose scores outgrow the one-pass kernel's shared memory (a
    Llama-3-8B dense table of 96 tiles at G = 4, or 400 tiles at G = 1) no
    longer raises: the wrapper launches the two-pass walk, whose shared
    memory depends on G, d_head and the tile only. What lies past that
    envelope still raises RuntimeError naming the limit, before any
    launch, and never runs the plain twin. (CPU tensors reported as CUDA
    ones, and a stand-in for the library that records the launch.)"""
    assert tattn.rows_walk(4, 128, 128, 17, 2) == 'one-pass'
    assert tattn.rows_walk(4, 128, 128, 96, 2) == 'two-pass'
    assert tattn.rows_walk(4, 128, 128, 96, 4) == 'two-pass'
    assert tattn.rows_walk(4, 128, 128, 96, 1) == 'two-pass'
    with pytest.raises(RuntimeError, match='kernel envelope of 204800 B'):
        tattn.rows_walk(8, 128, 1024, 4, 4)
    calls = []
    monkeypatch.setattr(tattn._build, 'on_cuda', lambda *ts: True)
    monkeypatch.setattr(tattn._build, 'lib', lambda: types.SimpleNamespace(
        spt_decode_attention=lambda code, two_pass, *a: calls.append(
            two_pass) or 0))
    monkeypatch.setattr(tattn._build, 'stream', lambda: 0)
    b, kv, d, ps, t_max = 1, 2, 64, 128, 400
    q = torch.zeros((b, kv, 1, d))
    k = torch.zeros((b, kv, t_max, d, ps))
    codes = torch.zeros((b, kv, t_max, 1, ps), dtype=torch.int32)
    tables = torch.arange(t_max, dtype=torch.int32)[None, None]
    ints = torch.zeros((b,), dtype=torch.int32)
    tattn.decode_attention_rows.launches = 0
    tattn.decode_attention_rows(
        q, k, k.clone(), codes, tables, ints + t_max, ints,
        torch.zeros((b, kv, d)), torch.zeros((b, kv, d)),
        torch.zeros((b, kv, 1), dtype=torch.int32))
    assert calls == [1] and tattn.decode_attention_rows.launches == 1
    tattn.decode_attention_rows.launches = 0


def test_generate_with_a_mesh_raises_and_names_its_slice():
    """Tensor-parallel generate() and serving run (tests/
    test_torch_parallel.py); what they cannot take yet under a mesh raises
    and names its slice: tp_overlap (the overlapped collective matmuls,
    the overlap slice) and a routed FFN (expert parallelism)."""
    cfg = _tiny_cfg()
    params = bridge.init_params(cfg, seed=0, device='cpu')
    iw = InferenceWeights.from_params(cfg.replace(tp_overlap=True), params)
    with pytest.raises(NotImplementedError, match='overlap slice'):
        teng.generate(iw, torch.ones((1, 4), dtype=torch.int64), 2,
                      mesh=object())
    with pytest.raises(NotImplementedError, match='overlap slice'):
        ContinuousBatchingEngine(iw, n_slots=1, max_len=256, mesh=object())
    rcfg = cfg.replace(ffn='routed', ffn_block_size=64)
    routed = InferenceWeights.from_params(
        rcfg, bridge.init_params(rcfg, seed=0, device='cpu'))
    with pytest.raises(NotImplementedError, match='expert-parallelism'):
        teng.generate(routed, torch.ones((1, 4), dtype=torch.int64), 2,
                      mesh=object())


def test_serving_stack_on_cpu_runs_the_twins_and_launches_nothing():
    """The batching engine on CPU weights (contiguous sparse int8-KV with a
    prefix and chunked prefill; paged dense over f32 and int8 pages, with a
    -1 table row through the sink) serves on the CPU, through the plain
    twins: no kernel wrapper launches."""
    for w in WRAPPERS:
        w.launches = 0
    cfg = _tiny_cfg()
    params = bridge.init_params(cfg, seed=0, device='cpu')
    prompts = [[i % 255 + 1 for i in range(n)] for n in (299, 145, 3)]
    runs = ((cfg, dict(quantized_kv=True, prefill_chunk=128,
                       prefix_cache=True)),
            (cfg.replace(attention='dense'), dict(paged=True)),
            (cfg.replace(attention='dense'), dict(paged=True,
                                                  quantized_kv=True)))
    for c, kw in runs:
        iw = InferenceWeights.from_params(c, params)
        eng = ContinuousBatchingEngine(iw, n_slots=2, max_len=384,
                                       prefill_bucket=16, **kw)
        assert eng.dev.type == 'cpu'
        rids = [eng.submit(p, max_new_tokens=3) for p in prompts]
        done = {x.request_id: x.tokens for x in eng.run_until_done()}
        assert sorted(done) == sorted(rids)
        assert all(len(v) == 3 for v in done.values())
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_verify_refuses_plain_attention_on_the_gpu_and_rows_past_its_envelope(
        monkeypatch):
    """On the card a bf16/f32 cache verifies only through the kernel:
    verify_step(impl='jnp') there raises (checked on a cache that reports a
    CUDA device), and the int8 cache, which has no kernel, refuses
    impl='kernel'. Query rows whose buffers outgrow one CTA's shared memory
    (G = 4 x K = 30 at d_head 128, K at the int32 bitfield's limit) no longer
    raise: they split into chunks of rows, a CTA each (in bf16 the split
    walk's equal row groups of at most 64), and a block that fits still
    launches as one chunk. What lies past even one 8-row chunk
    raises RuntimeError naming the limit and never runs the plain twin.
    (CPU tensors reported as CUDA ones, and a stand-in for the library
    that records the rows per CTA.)"""
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
    rows = []
    monkeypatch.setattr(tattn._build, 'on_cuda', lambda *ts: True)
    monkeypatch.setattr(tattn._build, 'lib', lambda: types.SimpleNamespace(
        spt_verify_attention=lambda *a: rows.append((a[16], a[-6])) or 0,
        spt_verify_split_scores=lambda *a: 0))
    monkeypatch.setattr(tattn._build, 'stream', lambda: 0)

    def launch(kk, g, d=128, ps=128, dtype=torch.float32):
        b, kv = 1, 1
        q = torch.zeros((b, kv, g * kk, d), dtype=dtype)
        k = torch.zeros((b, kv, 4, d, ps), dtype=dtype)
        codes = torch.zeros((b, kv, 4, 1, ps), dtype=torch.int32)
        tables = torch.tensor([[[0, 1, 1]]], dtype=torch.int32)
        tattn.verify_attention_rows(
            q, k, k.clone(), codes, tables, torch.ones_like(tables),
            torch.zeros((b,), dtype=torch.int32),
            torch.zeros((b, kv, d, kk), dtype=dtype),
            torch.zeros((b, kv, d, kk), dtype=dtype),
            torch.zeros((b, kv, 1, kk), dtype=torch.int32), ps=ps)
    tattn.verify_attention_rows.launches = 0
    launch(5, 4)                                   # fits: one chunk
    launch(30, 4, dtype=torch.bfloat16)            # 120 rows: the split
    launch(30, 8)                                  # walk's 2 x 60; 240
    assert rows == [(20, 20), (120, 60), (240, 64)]   # rows: 4 x 64 (f32)
    assert tattn.verify_attention_rows.launches == 3
    assert tattn.verify_rows_per_cta(84, 128, 128, 40, 2) == 48
    with pytest.raises(RuntimeError, match='kernel envelope of 204800 B'):
        launch(5, 1, ps=1024)
    assert tattn.verify_attention_rows.launches == 3
    tattn.verify_attention_rows.launches = 0


@pytest.mark.parametrize('attention,quantized,prompt,max_len', [
    ('sparse_v2', False, 300, 512), ('sparse_v2', True, 300, 512),
    ('dense', False, 140, 512), ('dense', True, 700, 1024)])
def test_decode_writer_is_the_same_every_layer(monkeypatch, attention,
                                               quantized, prompt, max_len):
    """The engine names the split walks' appending chunk once a step, from
    the first layer's tables: split_writer over every layer's decode tables
    (sparse and dense, int8 and bf16 KV; 8 tiles a layer give dense
    supertiles of 4) names the same chunks as over the first layer's."""
    cfg = _tiny_cfg().replace(attention=attention, n_layers=3,
                              max_length=max_len)
    iw = InferenceWeights.from_params(
        cfg, bridge.init_params(cfg, seed=0, device='cpu'))
    seen, tps_seen = [], []

    def record(*a, **k):
        tables, n_tiles, pos, base = (a[6:9] + a[14:15] if quantized
                                      else a[4:7] + a[10:11])
        tps_seen.append(k['tps'])
        seen.append(tattn.split_writer(
            tables, n_tiles, pos, base, ps=k['ps'], tps=k['tps'],
            e=tattn.split_entries(quantized, tables.shape[0] * cfg.kv_heads,
                                  tables.shape[2] * k['tps'])))
        fn = (tattn.decode_attention_rows_q_ref if quantized
              else tattn.decode_attention_rows_ref)
        k.pop('writer')
        return fn(*a, **k)
    name = 'decode_attention_rows_q' if quantized else 'decode_attention_rows'
    monkeypatch.setattr(teng, name, record)
    tokens = torch.randint(1, 256, (2, prompt), generator=torch.Generator()
                           .manual_seed(0))
    cache = teng.KVCache.create(cfg, 2, max_len, quantized=quantized,
                                device='cpu')
    _, cache = teng.prefill(iw, tokens, cache)
    teng.decode_step_greedy(iw, tokens[:, -1].to(torch.int32), cache)
    assert len(seen) == cfg.n_layers
    assert tps_seen[0] == (4 if max_len == 1024 else 1)
    assert all(torch.equal(w, seen[0]) for w in seen)
