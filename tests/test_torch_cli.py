"""PyTorch port vs the JAX package: the command line (cli/generate.py,
bench_serving.py, model_info.py, dump_delta.py, svd_rank.py, tune.py
--data_root, evaluate.py) and utils/metrics.py, on the CPU at tiny sizes.

Both packages read the same checkpoints (the port's seeded weights, saved
by the JAX package) and a character-level tokenizer saved to a temporary
directory (tokenizers + PreTrainedTokenizerFast; the port loads it with
local_files_only, the JAX CLIs through a patched AutoTokenizer that does
the same). Each CLI runs its JAX counterpart at most once; where the
path under a CLI is already held to JAX by another test file, the CLI is
held to the port's own function."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu import config as jcfg
from spt_proto_tpu.tuning.partition import count_trainable as jcount
from spt_proto_tpu.utils import checkpoint as jckpt
from spt_proto_tpu_torch.cli import (bench_serving, dump_delta, evaluate,
                                     generate, model_info, svd_rank, tune)
from spt_proto_tpu_torch.config import tiny_config
from spt_proto_tpu_torch.data.datamodule import (default_tokenizer,
                                                 mmlu_batches)
from spt_proto_tpu_torch.inference.bridge import params_to_numpy
from spt_proto_tpu_torch.tuning import surgery
from spt_proto_tpu_torch.tuning import evaluate as tevaluate
from spt_proto_tpu_torch.tuning.partition import count_trainable
from spt_proto_tpu_torch.utils import checkpoint as tckpt
from spt_proto_tpu_torch.utils.tree import flatten

torch.set_num_threads(1)

CPU = ['--device', 'cpu']


def jax_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name in ('dtype', 'param_dtype'):
        kw[name] = jnp.dtype(str(kw[name]).removeprefix('torch.'))
    return jcfg.ModelConfig(**kw)


def char_tok(text):
    return [ord(c) % 120 + 1 for c in text]


def save_tokenizer(path):
    """A character-level tokenizer (printable ASCII and newline, no eos)
    saved as a local transformers tokenizer directory."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    chars = [chr(i) for i in range(32, 127)] + ['\n']
    vocab = {'<unk>': 0, **{c: i + 1 for i, c in enumerate(chars)}}
    tk = Tokenizer(models.WordLevel(vocab, unk_token='<unk>'))
    tk.pre_tokenizer = pre_tokenizers.Split(Regex(r'[\s\S]'), 'isolated')
    tk.decoder = decoders.Fuse()
    PreTrainedTokenizerFast(tokenizer_object=tk,
                            unk_token='<unk>').save_pretrained(path)
    return path


def write_corpus(root):
    """MMLU (dev / test / auxiliary_train) CSVs and flan-mini jsonl."""
    r = np.random.RandomState(0)
    words = ['alpha', 'beta', 'ring', 'field', 'force', 'mass', 'temple']

    def phrase(n):
        return ' '.join(r.choice(words, size=n))
    for split, n in (('dev', 3), ('test', 8), ('auxiliary_train', 6)):
        os.makedirs(f'{root}/mmlu/{split}')
        for subject in ('abstract_algebra', 'virology'):
            with open(f'{root}/mmlu/{split}/{subject}_{split}.csv', 'w') as f:
                for _ in range(n):
                    f.write(f'"{phrase(r.randint(2, 6))}?","{phrase(1)}",'
                            f'"{phrase(2)}","{phrase(1)}","{phrase(1)}",'
                            f'"{"ABCD"[r.randint(4)]}"\n')
    os.makedirs(f'{root}/flan-mini')
    with open(f'{root}/flan-mini/a.jsonl', 'w') as f:
        for _ in range(12):
            f.write(json.dumps({'input': phrase(r.randint(2, 12)),
                                'output': phrase(r.randint(1, 4))}) + '\n')
    return root


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    """Checkpoints saved by the JAX package from the port's seeded weights
    (tiny OPT, vocab 128, max_length 512: dense and sparse_v2), the
    tokenizer directory and the corpus."""
    root = tmp_path_factory.mktemp('cli')
    out = {'tok': save_tokenizer(str(root / 'tok')),
           'data': write_corpus(str(root / 'data'))}
    for name, kw in (('base', {}), ('sparse', dict(attention='sparse_v2'))):
        cfg = tiny_config('opt', vocab_size=128, max_length=512, **kw)
        out[name] = str(root / name)
        jckpt.save_checkpoint(out[name], jax_config(cfg), params_to_numpy(
            surgery.init_params(cfg, 0, 'cpu')))
    # cli.tune --data_root on the base: 2 steps, the batches each step
    # trained on and its loss
    steps = []
    from spt_proto_tpu_torch.tuning import trainer
    make = trainer.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            state, m = step(state, batch)
            steps.append((batch, float(m['loss'])))
            return state, m
        return run
    trainer.make_train_step = recording
    try:
        out['tuned'] = str(root / 'tuned')
        params, _ = tune.main(
            CPU + ['--ckpt', out['base'], '--data_root', out['data'],
                   '--out', out['tuned'], '--steps', '2', '--seq_length',
                   '65', '--batch_size', '2'], tokenizer=char_tok)
    finally:
        trainer.make_train_step = make
    out.update(tune_steps=steps, tune_params=params)
    return out


@pytest.fixture
def jax_tokenizers(monkeypatch):
    """The JAX CLIs load tokenizers from the local directory only."""
    import transformers

    import spt_proto_tpu.data.datamodule as jdm
    load = transformers.AutoTokenizer.from_pretrained
    monkeypatch.setattr(transformers.AutoTokenizer, 'from_pretrained',
                        staticmethod(lambda name, **kw: load(
                            name, local_files_only=True)))
    monkeypatch.setattr(jdm, 'default_tokenizer', lambda name: char_tok)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_generate_matches_jax(env, capsys, jax_tokenizers):
    """Greedy text generation: the port's lines equal the JAX CLI's; the
    --prompt_ids form returns the same ids; --speculative equals plain;
    --int8 and --quantized_kv run."""
    from spt_proto_tpu.cli import generate as jgenerate
    from transformers import AutoTokenizer
    prompts = ['hello world hello world', 'abcabcabc']
    argv = ['--ckpt', env['base'], '--tokenizer', env['tok'],
            '--max_new_tokens', '6']
    for p in prompts:
        argv += ['--prompt', p]
    jgenerate.main(argv)
    want = capsys.readouterr().out.strip().splitlines()
    outs = generate.main(CPU + argv)
    assert capsys.readouterr().out.strip().splitlines() == want
    tok = AutoTokenizer.from_pretrained(env['tok'], local_files_only=True)
    assert [repr(tok.decode(o)) for o in outs] == \
        [w.split(' -> ')[1] for w in want]
    ids = CPU + ['--ckpt', env['base'], '--max_new_tokens', '6']
    for p in prompts:
        ids += ['--prompt_ids', ','.join(map(str, tok.encode(p)))]
    assert generate.main(ids) == outs
    assert [json.loads(x) for x in
            capsys.readouterr().out.strip().splitlines()] == outs
    assert generate.main(ids + ['--speculative', '--spec_k', '3']) == outs
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        '[speculative]')
    for flags in (['--int8'], ['--quantized_kv'], ['--int8',
                                                   '--quantized_kv']):
        got = generate.main(ids + flags)
        assert [len(g) for g in got] == [6, 6]
        assert all(0 <= t < 128 for g in got for t in g)
    sampled = generate.main(ids + ['--temperature', '0.8', '--top_k', '5',
                                   '--seed', '3'])
    assert sampled == generate.main(ids + ['--temperature', '0.8',
                                           '--top_k', '5', '--seed', '3'])


def test_generate_continuous_prefix_cache_matches_plain(env, capsys):
    """--continuous --prefix_cache prints the plain continuous engine's
    completions when the prompts share a head of more than one tile, and
    both equal greedy generate (as the JAX package's CLI test checks)."""
    head = 'abcd' * 33
    argv = CPU + ['--ckpt', env['base'], '--tokenizer', env['tok'],
                  '--prompt', head + 'xy', '--prompt', head + 'zw',
                  '--max_new_tokens', '4']
    plain = generate.main(argv + ['--continuous'])
    cached = generate.main(argv + ['--continuous', '--prefix_cache'])
    assert cached == plain == generate.main(argv)
    assert generate.main(argv + ['--continuous', '--speculative']) == plain


def test_bench_serving_matches_jax(env, capsys):
    """The port's JSON lines carry the JAX CLI's keys in all four modes
    and with --spec_k; the speculative acceptance (f32, greedy, on the
    sparse checkpoint, so neither CLI draws a codebook) equals JAX's."""
    from spt_proto_tpu.cli import bench_serving as jbench
    argv = ['--ckpt', env['sparse'], '--batch', '2', '--prompt_len', '128',
            '--max_len', '256', '--steps', '2', '--spec_k', '3']
    jbench.main(argv + ['--mode', 'paged'])
    want = [json.loads(x) for x in
            capsys.readouterr().out.strip().splitlines()]
    got = bench_serving.main(CPU + argv + ['--mode', 'dense', 'sparse',
                                           'int8', 'paged'])
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[-1] == got and len(lines) == 6
    assert [list(x) for x in lines[:4]] == [['dense'], ['sparse'], ['int8'],
                                            ['paged']]
    assert sorted(got) == sorted(want[-1])
    mode_keys = sorted(want[0]['paged'])
    for mode in ('dense', 'sparse', 'int8', 'paged'):
        assert sorted(got['decode_throughput'][mode]) == mode_keys
        assert got['decode_throughput'][mode]['tokens_per_s'] > 0
    spec, jspec = (got['decode_throughput']['speculative'],
                   want[-1]['decode_throughput']['speculative'])
    assert sorted(spec) == sorted(jspec)
    assert spec['acceptance'] == jspec['acceptance'] and spec['k'] == 3
    # the workloads
    np.testing.assert_array_equal(
        bench_serving.random_prompts(128, 2, 128),
        np.random.RandomState(0).randint(1, 128, size=(2, 128)))
    rows = bench_serving.spec_prompts(128, 3, 40)
    phrase = np.random.RandomState(7).randint(1, 128, size=16)
    for i in range(3):
        assert rows[i].tolist() == [int(t) % 128 for t in np.tile(
            phrase + i, 40 // 16 + 1)[:40]]


def test_speculative_engine_at_the_cache_end(env):
    """Requests that end exactly at max_len (bench_serving's workload at
    prompt 96, max_len 128, k 3: one finishes rounds before the other):
    a finished lane's dead verify block stays inside the cache, and every
    request's tokens equal greedy generate's (a dense model: the sparse
    engine selects tiles per row, as the JAX engine does)."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.batching import \
        ContinuousBatchingEngine
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    cfg, params = tckpt.load_checkpoint(env['base'], 'cpu')
    iw = InferenceWeights.from_params(cfg, params)
    prompts = bench_serving.spec_prompts(cfg.vocab_size, 3, 96)
    eng = ContinuousBatchingEngine(iw, n_slots=3, max_len=128, speculative=3)
    rids = [eng.submit(p.tolist(), 32) for p in prompts]
    done = {c.request_id: c.tokens for c in eng.run_until_done()}
    want = engine.generate(iw, torch.from_numpy(prompts), 32)[:, 96:]
    assert [list(done[r]) for r in rids] == want.tolist()
    assert eng.spec_stats['accepted'] > 0


def test_model_info_matches_jax(env, capsys):
    """--tuning sparse --serving --hbm_gb 16 on the tuned checkpoint (its
    stages already applied): the JSON equals the JAX CLI's; from the base,
    the sparse counts equal the tuned tree's, and the dense and lora counts
    JAX's count_trainable over the same trees; --hbm_gb defaults to the
    v5e's 16 only on the CPU."""
    from spt_proto_tpu.cli import model_info as jinfo
    argv = ['--ckpt', env['tuned'], '--tuning', 'sparse', '--serving',
            '--hbm_gb', '16']
    jinfo.main(argv)
    want = last_json(capsys)
    assert model_info.main(CPU + argv) == want
    assert last_json(capsys) == want
    assert model_info.main(CPU + argv[:-2]) == want
    base = model_info.main(CPU + ['--ckpt', env['base']] + argv[2:])
    assert {k: v for k, v in base.items() if k != 'config'} == \
        {k: v for k, v in want.items() if k != 'config'}
    cfg, params = tckpt.load_checkpoint(env['base'], 'cpu')
    _, lora = surgery.upgrade(cfg, params, 'lora', 0, d_lora=16)
    for tuning, tree in (('dense', params), ('lora', lora)):
        got = model_info.main(CPU + ['--ckpt', env['base'], '--tuning',
                                     tuning])
        train, frozen = jcount(params_to_numpy(tree))
        assert (got['trainable_params'], got['frozen_params']) == \
            (train, frozen) == count_trainable(tree)
        assert got['total_params'] == train + frozen
        assert 'hbm_gb' not in got


def test_dump_delta_matches_jax(env, capsys):
    """The delta of the tune output against its base: the port's count
    equals the JAX CLI's, and JAX's load_delta_checkpoint overlays it on
    the upgraded base to the tuned leaves."""
    from spt_proto_tpu.cli import dump_delta as jdump
    out = os.path.dirname(env['tuned'])
    jdump.main(['--base', env['base'], '--tuned', env['tuned'], '--out',
                out + '/jdd'])
    want = last_json(capsys)
    got = dump_delta.main(CPU + ['--base', env['base'], '--tuned',
                                 env['tuned'], '--out', out + '/tdd'])
    assert got['delta_params'] == want['delta_params'] > 0
    assert got['delta_params'] == count_trainable(env['tune_params'])[0]
    _, tuned = jckpt.load_checkpoint(env['tuned'])
    _, base = jckpt.load_checkpoint(env['base'])
    jflat_tuned = flatten(tuned)
    skeleton = {k: np.zeros_like(v) for k, v in jflat_tuned.items()}
    skeleton.update(flatten(base))
    from spt_proto_tpu.utils.tree import unflatten
    _, restored = jckpt.load_delta_checkpoint(out + '/tdd',
                                              unflatten(skeleton))
    for path, leaf in flatten(restored).items():
        np.testing.assert_array_equal(np.asarray(leaf), jflat_tuned[path],
                                      err_msg=path)


def test_svd_rank_matches_jax(env, capsys):
    """The FFN weight ranks equal the JAX CLI's exactly; --activations adds
    the logits' ranks (keys only: the tokens come from other
    generators)."""
    from spt_proto_tpu.cli import svd_rank as jsvd
    jsvd.main(['--ckpt', env['base']])
    want = json.loads(capsys.readouterr().out)
    got = svd_rank.main(CPU + ['--ckpt', env['base'], '--activations'])
    assert json.loads(capsys.readouterr().out) == got
    acts = got.pop('activations.logits')
    assert got == want and len(want) == 4
    assert sorted(acts) == sorted(want['ffn.fc1.layer0'])
    assert all(0 < r <= 128 for r in acts.values())


def test_tune_data_root_trains_on_jax_batches(env):
    """cli.tune --data_root: 2 steps with finite losses, on exactly the
    batches JAX's mmlu_flan_mixture builds from the same tree and
    tokenizer."""
    from spt_proto_tpu.data.datamodule import mmlu_flan_mixture
    want = mmlu_flan_mixture(env['data'], char_tok, seq_length=65,
                             batch_size=2)
    steps = env['tune_steps']
    assert len(steps) == 2
    for batch, _ in steps:
        jb = next(want)
        assert sorted(batch) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(batch[k], jb[k], err_msg=k)
    assert steps[0][0]['inputs'].shape == (2, 64)
    assert np.isfinite([loss for _, loss in steps]).all()


def test_evaluate_matches_jax(env, capsys, jax_tokenizers):
    """--spt_ckpt (the four stages, then the tune output's delta): ppl to
    1e-5 relative and accuracy equal to the JAX CLI's (both on the tuned
    checkpoint, whose stages are in place, so neither draws a new leaf;
    from the base the port gives the same). Without it, and with
    --tokenizer DIR: equal to the port's tuning.evaluate over mmlu_batches
    with the directory's tokenizer."""
    from spt_proto_tpu.cli import evaluate as jeval
    argv = ['--data_root', env['data'], '--n_shots', '1', '--seq_length',
            '65', '--batch_size', '2', '--max_batches', '3', '--spt_ckpt',
            env['tuned'] + '-delta']
    jeval.main(['--ckpt', env['tuned']] + argv)
    want = last_json(capsys)
    for ckpt in ('tuned', 'base'):
        got = evaluate.main(CPU + ['--ckpt', env[ckpt]] + argv,
                            tokenizer=char_tok)
        assert abs(got['ppl'] - want['ppl']) <= 1e-5 * want['ppl'], ckpt
        assert (got['accuracy'], got['n_examples']) == \
            (want['accuracy'], want['n_examples']) and got['n_examples'] == 6
    dense = evaluate.main(CPU + ['--ckpt', env['base'], '--tokenizer',
                                 env['tok']] + argv[:-2])
    cfg, params = tckpt.load_checkpoint(env['base'], 'cpu')
    tok = default_tokenizer(env['tok'])
    assert tok('ab\n') == [66, 67, 96]
    ref = tevaluate.evaluate(cfg, params, mmlu_batches(
        env['data'], tok, n_shots=1, seq_length=65, batch_size=2),
        max_batches=3)
    assert dense == ref


def test_bf16_checkpoint_round_trip(tmp_path):
    """A checkpoint of bf16 leaves (ml_dtypes' bfloat16 in the npz, which
    np.load hands back as 2-byte void records) loads back bit for bit, as
    the serving CLIs load one."""
    cfg = tiny_config('opt', vocab_size=128, attention='sparse_v2',
                      param_dtype=torch.bfloat16)
    params = surgery.init_params(cfg, 0, 'cpu')
    tckpt.save_checkpoint(str(tmp_path), cfg, params)
    got_cfg, got = tckpt.load_checkpoint(str(tmp_path), 'cpu')
    assert got_cfg == cfg
    for path, leaf in flatten(params).items():
        assert flatten(got)[path].dtype == torch.bfloat16, path
        assert torch.equal(flatten(got)[path], leaf), path
    assert generate.main(CPU + ['--ckpt', str(tmp_path), '--prompt_ids',
                                '1,2,3', '--max_new_tokens', '2'])


def test_serve_cli_loads_a_checkpoint(env):
    """cli.serve --ckpt serves the checkpoint's weights (through
    cli/common.py::load_or_init): a completion over HTTP equals greedy
    generate's tokens on the same checkpoint."""
    import threading
    import urllib.request

    from spt_proto_tpu_torch.cli import serve
    server, frontend = serve.build_server(serve.parser().parse_args(
        CPU + ['--ckpt', env['base'], '--dtype', 'float32', '--port', '0',
               '--n_slots', '2', '--max_len', '256']))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        url = f'http://{server.server_address[0]}:{server.server_address[1]}'
        req = urllib.request.Request(
            url + '/v1/completions', headers={'Content-Type':
                                              'application/json'},
            data=json.dumps({'prompt': [5, 6, 7, 8], 'max_tokens': 5}
                            ).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())['tokens']
    finally:
        server.shutdown()
        frontend.shutdown()
        th.join(timeout=30)
    assert not th.is_alive()
    assert got == generate.main(CPU + ['--ckpt', env['base'],
                                       '--prompt_ids', '5,6,7,8',
                                       '--max_new_tokens', '5'])[0]


def test_metrics_logger(tmp_path, capsys):
    """utils/metrics.py: the JAX package's MetricsLogger records (step,
    seconds, floats of 0-d tensors, other values as they are, extra keys),
    appended as JSON lines, echoed when asked."""
    from spt_proto_tpu.utils.metrics import MetricsLogger as JLogger
    from spt_proto_tpu_torch.utils.metrics import MetricsLogger
    for cls, name in ((MetricsLogger, 'port'), (JLogger, 'jax')):
        path = str(tmp_path / name / 'm.jsonl')
        with cls(path, echo=name == 'port') as log:
            log.log(0, {'loss': torch.tensor(1.5) if name == 'port'
                        else jnp.asarray(1.5)}, phase='train')
            log.log(1, {'loss': 1.2, 'tag': [1, 2]})
        with cls(path) as log:
            log.log(2, {'loss': 1})
    port = [json.loads(x) for x in open(tmp_path / 'port' / 'm.jsonl')]
    jax_ = [json.loads(x) for x in open(tmp_path / 'jax' / 'm.jsonl')]
    for rec in port + jax_:
        assert rec.pop('t') >= 0
    assert port == jax_
    assert port[0] == {'step': 0, 'loss': 1.5, 'phase': 'train'}
    assert port[1]['tag'] == [1, 2] and port[2]['step'] == 2
    echoed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r['step'] for r in echoed] == [0, 1]
    MetricsLogger().log(0, {'x': 1})          # no path: nothing written
