"""What each rank of tests/test_torch_parallel.py's worlds runs (imported by
the spawned ranks, so it imports neither JAX nor the JAX package).

Every rank builds the same tiny f32 models from the port's seeded
init_params and returns numpy arrays and lists; the test compares them
with the JAX package's references. The configs, prompts and traffic are
defined here once, for both sides.
"""
import numpy as np
import torch

from spt_proto_tpu_torch.config import tiny_config
from spt_proto_tpu_torch.inference import engine as teng
from spt_proto_tpu_torch.inference.batching import ContinuousBatchingEngine
from spt_proto_tpu_torch.inference.bridge import init_params
from spt_proto_tpu_torch.inference.weights import InferenceWeights
from spt_proto_tpu_torch.parallel.infer_sharding import data_rows
from spt_proto_tpu_torch.parallel.mesh import make_mesh

SPARSE = dict(attention='sparse_v2', d_codeword=4, n_codewords=8,
              sparse_coeff=4)
MODELS = {
    'dense': dict(arch='opt'),
    'sparse': dict(arch='opt', **SPARSE),
    # the fused decode front's envelope (tests/test_infer_sharding.py's
    # fused-front case): l2 metric, d_model 128
    'fused': dict(arch='opt', d_model=128, n_heads=2, d_feedforward=256,
                  vocab_size=256, attention='sparse_v2', pq_metric='l2'),
    # heads that 'model' = 2 does not divide (attention whole on every
    # rank), a d_ff it does, and a vocabulary it does not
    'odd': dict(arch='opt', d_model=48, n_heads=3, d_feedforward=96,
                vocab_size=255),
    # GQA: 4 query heads over 2 kv heads
    'gqa': dict(arch='llama', d_model=128, n_heads=4, n_kv_heads=2,
                d_feedforward=256, **SPARSE),
}
ENGINE_MODES = {
    'contiguous': ('sparse', dict()),
    'paged': ('dense', dict(paged=True, page_size=16)),
    'speculative': ('sparse', dict(speculative=3)),
}


def config(name: str):
    """The port's config of a model (max_length 512, f32)."""
    kw = dict(MODELS[name])
    return tiny_config(kw.pop('arch'), max_length=512, **kw).replace(
        dtype=torch.float32)


def params(name: str):
    return init_params(config(name), 0, device='cpu')


def weights(name: str, quant=None) -> InferenceWeights:
    return InferenceWeights.from_params(config(name), params(name),
                                        quant=quant)


def prompts(vocab: int, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(1, vocab, size=(b, s)
                                               ).astype(np.int64)


def traffic(mode: str, vocab: int):
    """The engine cases' requests (tests/test_infer_sharding.py's)."""
    rng = np.random.RandomState({'contiguous': 5, 'paged': 6,
                                 'speculative': 7}[mode])
    if mode == 'speculative':
        base = list(map(int, rng.randint(1, vocab, size=4)))
        return [base * 3, base * 2,
                list(map(int, rng.randint(1, vocab, size=5)))], 8
    return [list(map(int, rng.randint(1, vocab, size=n)))
            for n in (5, 9, 3)], 6


def serve(iw, mode: str, mesh=None):
    """(completions in request order, speculative stats) of one engine
    case, n_slots 2, max_len 64."""
    _, kw = ENGINE_MODES[mode]
    reqs, n = traffic(mode, iw.cfg.vocab_size)
    eng = ContinuousBatchingEngine(iw, n_slots=2, max_len=64,
                                   prefill_bucket=16, mesh=mesh, **kw)
    rids = [eng.submit(p, max_new_tokens=n) for p in reqs]
    done = {c.request_id: c.tokens for c in eng.run_until_done()}
    return [done[r] for r in rids], dict(eng.spec_stats)


def serve_chunked(mesh=None):
    """Chunked prefill (128-token chunks) with the prefix cache over 2
    slots: a pinned 128-token prefix, prompts past it (a prefix hit, its
    tail a chunk), a long one chunked over three steps while the others
    decode; under a data split the slot's owner runs each chunk. Returns
    the completions in request order."""
    iw = weights('sparse')
    rng = np.random.RandomState(9)
    shared = list(map(int, rng.randint(1, 256, size=128)))
    reqs = [shared + list(map(int, rng.randint(1, 256, size=n)))
            for n in (20, 150)] + [list(map(int, rng.randint(1, 256,
                                                            size=n)))
                                   for n in (300, 7)]
    eng = ContinuousBatchingEngine(iw, n_slots=2, max_len=512,
                                   prefill_bucket=16, prefill_chunk=128,
                                   prefix_cache=True, mesh=mesh)
    eng.cache_prefix(shared)
    rids = [eng.submit(p, max_new_tokens=6) for p in reqs]
    done = {c.request_id: c.tokens for c in eng.run_until_done()}
    return [done[r] for r in rids], eng.prefix_hits


GEN_CASES = {   # name -> (model, quant, batch, prompt, new, max_len, kv8)
    'dense': ('dense', None, 4, 6, 8, 64, False),
    'sparse': ('sparse', None, 4, 6, 8, 64, False),
    'fused': ('fused', None, 4, 200, 6, 256, False),
    'w8': ('dense', 'int8', 4, 6, 8, 64, False),
    'odd': ('odd', None, 4, 6, 8, 64, False),
    'gqa_kv8': ('gqa', None, 2, 150, 6, 256, True),
}
WORLD_GEN = {4: ('dense', 'sparse', 'fused'), 2: ('w8', 'odd', 'gqa_kv8')}


def gen_case(name: str, mesh=None) -> np.ndarray:
    model, quant, b, s, n, max_len, kv8 = GEN_CASES[name]
    iw = weights(model, quant)
    p = torch.from_numpy(prompts(iw.cfg.vocab_size, b, s, 2))
    return teng.generate(iw, p, n, max_len=max_len, quantized_kv=kv8,
                         mesh=mesh).numpy()


def step_case(name: str, mesh=None):
    """One prefill of [4, 8] tokens into a 16-token cache and one decode
    step (tests/test_infer_sharding.py's first test): the rank's rows of
    the logits, its cache shard (k, v, codes) and where they sit."""
    iw = weights(name)
    if mesh is not None:
        iw = teng.mesh_weights(iw, mesh)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, iw.cfg.vocab_size, size=(4, 8)))
    rows = slice(None) if mesh is None else data_rows(mesh, 4)[0]
    cache = teng.new_cache(iw, tokens[rows].shape[0], 16)
    lg, cache = teng.prefill(iw, tokens[rows], cache)
    tok = torch.argmax(lg[:, -1], -1).to(torch.int32)
    dec, cache = teng.decode_step(iw, tok, cache)
    kv = iw.shard.kv_heads if iw.shard is not None else iw.cfg.kv_heads
    h0 = (mesh.coords['model'] * kv
          if iw.shard is not None and iw.shard.attn else 0)
    return dict(prefill=lg.numpy(), decode=dec.numpy(), k=cache.k.numpy(),
                v=cache.v.numpy(), codes=cache.codes.numpy(),
                rows=(rows.start or 0, tokens[rows].shape[0]),
                heads=(h0, kv))


def tie_case(mesh) -> dict:
    """A greedy head whose maximum straddles the two ranks' vocabulary
    halves: rank 0's column 5 and rank 1's column V/2 + 1 (local index 1,
    lower than 5). Row 0 ties them (the global first maximum is column 5),
    in row 1 rank 1's is larger by 1. Integer-valued f32, so exact."""
    iw = weights('dense')
    v, d = iw.cfg.vocab_size, iw.cfg.d_model
    w = torch.zeros((d, v))
    w[:, 5] = 1.0
    w[:, v // 2 + 1] = 1.0
    w[0, v // 2 + 1] = 2.0
    w[:, 9] = 0.5
    iw.params['lm_head']['kernel'] = w
    x = torch.ones((2, d))
    x[0, 0] = 0.0
    sharded = teng.mesh_weights(iw, mesh)
    return dict(got=teng._greedy_head(sharded, x).tolist(),
                want=teng._greedy_head(iw, x).tolist(),
                head=sharded.shard.head)


def world(rank: int, n_data: int, n_model: int):
    """Every case of one world, on this rank."""
    mesh = make_mesh(n_data, n_model, device='cpu')
    out = {f'gen/{c}': gen_case(c, mesh) for c in WORLD_GEN[n_data *
                                                            n_model]}
    if n_data * n_model == 4:
        for name in ('dense', 'sparse'):
            out[f'step/{name}'] = step_case(name, mesh)
        for mode, (model, _) in ENGINE_MODES.items():
            out[f'engine/{mode}'] = serve(weights(model), mode, mesh)
        out['engine/chunked'] = serve_chunked(mesh)
    else:
        out['tie'] = tie_case(mesh)
        out['sampled'] = teng.generate(
            weights('sparse'), torch.from_numpy(prompts(256, 4, 6, 3)), 8,
            max_len=64, temperature=0.8, top_k=20, mesh=mesh).numpy()
        out['serve'] = serve_case(mesh)
        out['cli'] = cli_case()
    return out


def serve_case(mesh):
    """The HTTP server over the sharded engine: rank 0 serves three
    concurrent requests, rank 1 follows its steps."""
    import json
    import threading
    import urllib.request

    from spt_proto_tpu_torch.cli import serve
    args = serve.parser().parse_args([
        '--config', 'tiny-opt', '--device', 'cpu', '--dtype', 'float32',
        '--port', '0', '--n_slots', '2', '--max_len', '64',
        '--mesh_model', '2'])
    if mesh.coords['model'] != 0:
        from spt_proto_tpu_torch.inference.server import follow
        follow(serve.build_engine(args, mesh)[0])
        return None
    server, frontend = serve.build_server(args, mesh)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = f'http://127.0.0.1:{server.server_address[1]}/v1/completions'
    reqs = prompts(256, 3, 7, 4).tolist()
    got = [None] * len(reqs)

    def post(i):
        body = json.dumps({'prompt': reqs[i], 'max_tokens': 5}).encode()
        r = urllib.request.urlopen(urllib.request.Request(
            url, data=body, headers={'Content-Type': 'application/json'}),
            timeout=120)
        got[i] = json.loads(r.read())['tokens']
    posts = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for t in posts:
        t.start()
    for t in posts:
        t.join()
    server.shutdown()
    frontend.shutdown()
    return got


def serve_reference():
    """serve_case's requests through the unsharded engine (what the
    server's frontend submits: each request in order, 5 new tokens)."""
    from spt_proto_tpu_torch.cli import serve
    args = serve.parser().parse_args([
        '--config', 'tiny-opt', '--device', 'cpu', '--dtype', 'float32',
        '--n_slots', '2', '--max_len', '64'])
    eng, _ = serve.build_engine(args)
    reqs = prompts(256, 3, 7, 4).tolist()
    rids = [eng.submit(p, max_new_tokens=5) for p in reqs]
    done = {c.request_id: c.tokens for c in eng.run_until_done()}
    return [done[r] for r in rids]


CLI_ARGS = ['--config', 'tiny-opt', '--device', 'cpu', '--prompt_ids',
            '5,6,7,8', '--prompt_ids', '9,10,11', '--max_new_tokens', '6']


def cli_case():
    """cli.generate under the mesh flags (this world's process group)."""
    from spt_proto_tpu_torch.cli import generate
    return generate.main(CLI_ARGS + ['--mesh_model', '2'])
