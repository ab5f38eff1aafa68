"""The port's HTTP serving front end over its continuous batching engine, on
the CPU: /health and /stats, concurrent completions equal to JAX's greedy
generate(), streaming, live_progress, a 400 on an oversized request that
the server survives, the front end's error and timeout bookkeeping, and
the serve CLI's server (tests/test_server.py's cases, over the port)."""
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu.config import tiny_config
from spt_proto_tpu.inference import engine as jeng
from spt_proto_tpu.inference.weights import InferenceWeights as JIW
from spt_proto_tpu_torch.cli import serve
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference.batching import ContinuousBatchingEngine
from spt_proto_tpu_torch.inference.server import ServingFrontend, make_server
from spt_proto_tpu_torch.inference.weights import InferenceWeights as TIW
from test_torch_engine import port_config

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def weights():
    """(JAX weights, port weights) of a tiny f32 OPT model, the port's
    seeded init_params handed to both as numpy."""
    cfg = tiny_config('opt').replace(dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.numpy(), bridge.init_params(
        port_config(cfg), 0, device='cpu'))
    return (JIW.from_params(cfg, jax.tree.map(jnp.asarray, params),
                            dtype=jnp.float32),
            TIW.from_params(port_config(cfg),
                            bridge.params_from_numpy(params, device='cpu')))


def _engine(iw, max_len=64):
    return ContinuousBatchingEngine(iw, n_slots=2, max_len=max_len,
                                    prefill_bucket=16)


@pytest.fixture(scope='module')
def served(weights):
    server, frontend = make_server(_engine(weights[1]), port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = f'http://{server.server_address[0]}:{server.server_address[1]}'
    yield url
    server.shutdown()
    frontend.shutdown()


def _post(url, payload):
    req = urllib.request.Request(
        url + '/v1/completions', data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health_and_bad_requests(served):
    with urllib.request.urlopen(served + '/health', timeout=30) as r:
        assert json.loads(r.read()) == {'ok': True}
    status, body = _post(served, {'prompt': 'text without tokenizer'})
    assert status == 400 and 'tokenizer' in body['error']
    assert _post(served, {})[0] == 400


def test_concurrent_completions_match_generate(weights, served):
    """Four requests posted at once batch through the engine thread and
    each returns JAX's greedy generate() tokens."""
    j_iw, _ = weights
    rs = np.random.RandomState(2)
    prompts = [list(map(int, rs.randint(1, 256, size=n)))
               for n in (5, 9, 3, 7)]
    results = [None] * len(prompts)

    def worker(i):
        status, body = _post(served, {'prompt': prompts[i],
                                      'max_tokens': 6})
        assert status == 200, body
        results[i] = body['tokens']

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    for p, got in zip(prompts, results):
        want = np.asarray(jeng.generate(j_iw, jnp.asarray([p], jnp.int32),
                                        6, max_len=64))[0, len(p):]
        assert got == list(want), (got, want)
    with urllib.request.urlopen(served + '/stats', timeout=30) as r:
        stats = json.loads(r.read())
    assert stats['served'] >= len(prompts)
    assert stats['active'] == 0 and stats['queued'] == 0


def test_streaming_completion(served):
    """stream=true gives NDJSON token lines whose concatenation is the
    non-streamed completion, then a done line."""
    prompt = [4, 11, 7, 2, 9]
    _, whole = _post(served, {'prompt': prompt, 'max_tokens': 6})
    req = urllib.request.Request(
        served + '/v1/completions',
        data=json.dumps({'prompt': prompt, 'max_tokens': 6,
                         'stream': True}).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.headers['Content-Type'] == 'application/x-ndjson'
        lines = [json.loads(raw) for raw in r]
    assert lines[-1]['done'] is True
    streamed = [tok for ln in lines[:-1] for tok in ln['tokens']]
    assert streamed == whole['tokens']
    assert lines[-1]['n_tokens'] == len(streamed)


def test_live_progress_grows(weights):
    """engine.live_progress() (the streaming source) shows tokens as they
    decode, before the request completes."""
    eng = ContinuousBatchingEngine(weights[1], n_slots=1, max_len=64,
                                   prefill_bucket=16)
    rid = eng.submit([3, 1, 4, 1, 5], max_new_tokens=5)
    eng.step()            # prefill (samples token 1) + one decode (token 2)
    snap1 = eng.live_progress()
    assert list(snap1) == [rid] and len(snap1[rid]) == 2
    eng.step()
    snap2 = eng.live_progress()
    assert len(snap2[rid]) == 3 and snap2[rid][:2] == snap1[rid]
    assert eng.run_until_done()[0].tokens[:3] == snap2[rid]
    assert eng.live_progress() == {}


def test_oversized_request_400_and_server_survives(served):
    status, body = _post(served, {'prompt': [1, 2, 3], 'max_tokens': 1000})
    assert status == 400 and 'max_len' in body['error']
    status, body = _post(served, {'prompt': [4, 5, 6], 'max_tokens': 3})
    assert status == 200 and len(body['tokens']) == 3


def test_frontend_engine_error_resolves_ticket(weights):
    """engine.submit raising on the engine thread fails only that ticket
    (ValueError from wait()); the loop serves the next one."""
    fe = ServingFrontend(_engine(weights[1], max_len=32))
    try:
        bad = fe.submit([1] * 30, 30)
        with pytest.raises(ValueError):
            fe.wait(bad, timeout=60)
        ok = fe.submit([1, 2, 3], 2)
        assert len(fe.wait(ok, timeout=120)) == 2
        assert fe._errors == {} and fe._tickets == {}
    finally:
        fe.shutdown()


def test_wait_timeout_cleans_up_ticket_state(weights):
    """A timed-out wait() abandons its ticket: the engine loop drops the
    eventual completion instead of keeping it."""
    fe = ServingFrontend(_engine(weights[1], max_len=32))
    try:
        t0 = fe.submit([7, 8, 9], 4)
        with pytest.raises(TimeoutError):
            fe.wait(t0, timeout=0.0)
        ok = fe.submit([1, 2, 3], 2)
        assert len(fe.wait(ok, timeout=120)) == 2
        deadline = time.time() + 60
        while fe._rid_to_ticket and time.time() < deadline:
            time.sleep(0.05)
        with fe._cv:
            assert fe._tickets == {} and fe._progress == {}
            assert fe._rid_to_ticket == {}
    finally:
        fe.shutdown()


def test_serve_cli_builds_a_paged_server_on_the_cpu():
    """cli/serve.py's server (a tiny model from --seed, the paged int8-KV
    engine, on --device cpu, port 0) answers a completion of the requested
    length; cuda is the default device."""
    args = serve.parser().parse_args(
        ['--config', 'tiny-opt', '--dtype', 'float32', '--device', 'cpu',
         '--port', '0', '--n_slots', '2', '--max_len', '64', '--paged',
         '--page_size', '16', '--quantized_kv'])
    assert serve.parser().parse_args([]).device == 'cuda'
    server, frontend = serve.build_server(args)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        eng = frontend.engine
        assert eng.paged and eng.quantized_kv and eng.dev.type == 'cpu'
        url = f'http://{server.server_address[0]}:{server.server_address[1]}'
        status, body = _post(url, {'prompt': [5, 6, 7], 'max_tokens': 4})
        assert status == 200 and body['n_tokens'] == 4
    finally:
        server.shutdown()
        frontend.shutdown()
