"""PyTorch port vs the JAX package: the data path (data/transform.py,
reader.py, mmlu.py, datamodule.py), on the same inputs, exactly equal.

The port keeps its own copy of the JAX package's pure-Python data modules;
every function here is called on both with the same arguments (the same
seeds for the random crops, mixtures and shuffles) and the outputs must
be identical: strings, token rows and numpy batches alike."""
import json
import random

import numpy as np
import pytest
import torch

from spt_proto_tpu.data import datamodule as jdm
from spt_proto_tpu.data import mmlu as jmmlu
from spt_proto_tpu.data import reader as jreader
from spt_proto_tpu.data import transform as jtf
from spt_proto_tpu_torch.data import datamodule as tdm
from spt_proto_tpu_torch.data import mmlu as tmmlu
from spt_proto_tpu_torch.data import reader as treader
from spt_proto_tpu_torch.data import transform as ttf

torch.set_num_threads(1)

GOLDEN = ['hello   world', '  pad  ', 'a () b', 'word , next .',
          'p1\n\n\n\np2']
# ASCII (the native path) and Unicode whitespace (the Python path)
SANITIZE_CASES = GOLDEN + [
    'a [] b {} c , d ; e : f ! g ?', 'tabs\t\tand\nnewlines  ,  ok',
    'café , fine', 'nbsp\xa0\xa0, here', 'ideographic\u3000space .',
    '\n\n', '', '((nested ()))']


def char_tok(text):
    return [ord(c) % 97 + 1 for c in text]


def write_tree(root, seed=0):
    """An MMLU tree (dev / test / val / auxiliary_train, two subjects),
    flan-mini jsonl, a wikitext folder and alpaca json under root."""
    r = np.random.RandomState(seed)
    words = ['alpha', 'beta', 'gamma', 'delta', 'ring', 'field', 'force']

    def phrase(n):
        return ' '.join(r.choice(words, size=n))
    for split, n in (('dev', 3), ('test', 5), ('val', 2),
                     ('auxiliary_train', 4)):
        d = root / 'mmlu' / split
        d.mkdir(parents=True)
        for subject in ('abstract_algebra', 'virology'):
            with open(d / f'{subject}_{split}.csv', 'w') as f:
                for i in range(n):
                    f.write(f'"{phrase(r.randint(3, 12))} {i}?","{phrase(2)}"'
                            f',"{phrase(1)}","{phrase(3)}","{phrase(2)}",'
                            f'"{"ABCD"[r.randint(4)]}"\n')
                f.write('"a short row","x"\n')          # not six columns
    fl = root / 'flan-mini'
    fl.mkdir()
    with open(fl / 'a.jsonl', 'w') as f:
        for i in range(7):
            f.write(json.dumps({'input': phrase(r.randint(2, 30)),
                                'output': phrase(r.randint(1, 9))}) + '\n')
        f.write('\n' + json.dumps({'instruction': 'do it',
                                   'response': 'done'}) + '\n')
    wk = root / 'wikitext-103'
    wk.mkdir()
    (wk / 'wiki.valid.tokens').write_text('\n'.join(
        ['= Heading ='] + [f'{phrase(r.randint(8, 20))} , line {i} .'
                           for i in range(30)]))
    al = root / 'alpaca'
    al.mkdir()
    (al / 'alpaca_data.json').write_text(json.dumps(
        [{'instruction': 'add', 'input': '1 2', 'output': '3'},
         {'instruction': 'greet', 'input': '', 'output': 'hi'}]))
    return str(root)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp('data'))


def test_sanitize_matches_jax_on_both_paths():
    assert ttf._native_sanitize() is not None, 'runtime lib failed to load'
    assert ttf.sanitize('hello   world') == 'hello world'
    for case in SANITIZE_CASES:
        want = jtf.sanitize(case)
        assert ttf.sanitize(case) == want, repr(case)
        assert ttf.sanitize_py(case) == jtf.sanitize_py(case) == want
        if not any(c in case for c in ttf._UNICODE_WS):
            assert ttf._native_sanitize()(case) == want, repr(case)
    assert ttf._UNICODE_WS == jtf._UNICODE_WS
    # both paths were taken
    assert {any(c in case for c in ttf._UNICODE_WS)
            for case in SANITIZE_CASES} == {True, False}
    rng = random.Random(0)
    alphabet = 'ab \t\n,.?!;:()[]{} '
    for _ in range(200):
        s = ''.join(rng.choice(alphabet) for _ in range(rng.randrange(80)))
        assert ttf.sanitize(s) == jtf.sanitize(s), repr(s)


@pytest.mark.parametrize('n', [0, 3, 8, 9, 20])
def test_padding_matches_jax(n):
    seq = list(range(1, n + 1))
    for length in (1, 8, 16):
        assert ttf.trunc_padding(seq, length) == jtf.trunc_padding(seq,
                                                                   length)
        assert ttf.trunc_padding(seq, length, pad_value=7) == \
            jtf.trunc_padding(seq, length, pad_value=7)
        got = [ttf.clamp_padding(seq, length, rng=random.Random(s))
               for s in range(4)]
        want = [jtf.clamp_padding(seq, length, rng=random.Random(s))
                for s in range(4)]
        assert got == want


def test_mmlu_prompts_match_jax(tree):
    path = '/x/high_school_us_history_test.csv'
    assert tmmlu.subject_from_path(path) == jmmlu.subject_from_path(path)
    row = ['Q?', 'w', 'x', 'y', 'z', 'C']
    assert tmmlu.format_question(row, 'virology') == \
        jmmlu.format_question(row, 'virology')
    d = tree + '/mmlu/test'
    for shuffle, seed in ((False, None), (True, 0), (True, 5)):
        assert list(tmmlu.iter_csv_rows(d, shuffle, seed)) == \
            list(jmmlu.iter_csv_rows(d, shuffle, seed))
    for mode in ('test', 'valid', 'train'):
        for shots, shuffle, seed in ((0, False, 0), (2, False, 0),
                                     (5, True, 3)):
            got = list(tmmlu.iter_mmlu_prompts(tree, mode, n_shots=shots,
                                               shuffle=shuffle, seed=seed))
            want = list(jmmlu.iter_mmlu_prompts(tree, mode, n_shots=shots,
                                                shuffle=shuffle, seed=seed))
            assert got == want and got


def test_readers_match_jax(tree):
    wk = tree + '/wikitext-103/wiki.valid.tokens'
    assert list(treader.iter_lines(wk, 2)) == list(jreader.iter_lines(wk, 2))
    fl = tree + '/flan-mini/a.jsonl'
    assert list(treader.iter_jsonl(fl)) == list(jreader.iter_jsonl(fl))
    c_t = treader.cycle(lambda: iter([1, 2, 3]))
    c_j = jreader.cycle(lambda: iter([1, 2, 3]))
    assert [next(c_t) for _ in range(8)] == [next(c_j) for _ in range(8)]
    assert list(treader.cycle(lambda: iter([]))) == []
    for seed in (0, 1):
        got = list(treader.weighted_mux(
            {iter(range(30)): 1.0, iter(range(100, 110)): 3.0}, seed=seed))
        want = list(jreader.weighted_mux(
            {iter(range(30)): 1.0, iter(range(100, 110)): 3.0}, seed=seed))
        assert got == want
        assert list(treader.shuffle_buffer(iter(range(50)), 7, seed)) == \
            list(jreader.shuffle_buffer(iter(range(50)), 7, seed))
    folder = tree + '/wikitext-103'
    for kw in (dict(min_length=16), dict(min_length=8, do_sanitize=False),
               dict(shuffle=True, buffer_size=5, seed=2, min_length=16)):
        assert list(treader.text_folder(folder, **kw)) == \
            list(jreader.text_folder(folder, **kw))
    it_t = treader.text_folder(folder, infinite=True, seed=4, min_length=16)
    it_j = jreader.text_folder(folder, infinite=True, seed=4, min_length=16)
    assert [next(it_t) for _ in range(70)] == [next(it_j) for _ in range(70)]
    with pytest.raises(FileNotFoundError):
        treader.text_folder(folder, pattern='*.none')


def _equal_batches(got, want):
    assert len(got) == len(want) and got
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_batches_match_jax(tree):
    rows = [[5, 1, 2, 3, 4, 0, 0], [7, 9, 8, 7, 6, 5, 4], [2, 3, 0, 0, 0,
                                                          0, 0]]
    _equal_batches([tdm.batch_from_rows(rows)], [jdm.batch_from_rows(rows)])
    padded = [ttf.trunc_padding(char_tok(t), 9) for t in
              ('abc', 'a longer text', 'xy', 'q', 'words here')]
    for drop in (True, False):
        _equal_batches(list(tdm._batched(iter(padded), 2, drop)),
                       list(jdm._batched(iter(padded), 2, drop)))
    for kw in (dict(n_shots=0, seq_length=33, batch_size=2),
               dict(n_shots=2, seq_length=65, batch_size=3, shuffle=True,
                    seed=1)):
        _equal_batches(list(tdm.mmlu_batches(tree, char_tok, **kw)),
                       list(jdm.mmlu_batches(tree, char_tok, **kw)))
    inf_t = tdm.mmlu_batches(tree, char_tok, mode='valid', seq_length=17,
                             batch_size=3, infinite=True)
    inf_j = jdm.mmlu_batches(tree, char_tok, mode='valid', seq_length=17,
                             batch_size=3, infinite=True)
    _equal_batches([next(inf_t) for _ in range(5)],
                   [next(inf_j) for _ in range(5)])
    texts = ['some reasonably long line of text ' * (i % 3 + 1)
             for i in range(9)]
    _equal_batches(list(tdm.lm_batches(iter(texts), char_tok, seq_length=32,
                                       batch_size=4, seed=3)),
                   list(jdm.lm_batches(iter(texts), char_tok, seq_length=32,
                                       batch_size=4, seed=3)))
    _equal_batches(list(tdm.wikitext_batches(tree, char_tok, seq_length=24,
                                             batch_size=4, seed=1)),
                   list(jdm.wikitext_batches(tree, char_tok, seq_length=24,
                                             batch_size=4, seed=1)))
    assert list(tdm.flanmini_prompts(tree)) == list(jdm.flanmini_prompts(tree))
    assert list(tdm.alpaca_prompts(tree)) == list(jdm.alpaca_prompts(tree))
    mix_t = tdm.mmlu_flan_mixture(tree, char_tok, seq_length=65,
                                  batch_size=4, seed=2)
    mix_j = jdm.mmlu_flan_mixture(tree, char_tok, seq_length=65,
                                  batch_size=4, seed=2)
    _equal_batches([next(mix_t) for _ in range(6)],
                   [next(mix_j) for _ in range(6)])
