"""Tokenized batch pipelines for training/eval (port of
spt_proto_tpu/data/datamodule.py).

Reference parity: naive_gpt/loaders/{mmlu,flanmini,wikitext}.py
(LightningDataModules). A "datamodule" here is a generator of numpy batches
{'inputs', 'targets', 'mask'} plus eval metadata, as the port's trainer and
tuning.evaluate take them. A tokenizer is any callable str -> list[int];
`default_tokenizer` loads one from a local directory only (never a hub
download), so runs without `transformers` pass their own callable.

Batch convention (from the reference training flow,
script/4-sparse-tuning-0.py:66-93 + 3-mmlu-evaluate.py:65-90):
each tokenized example passes through TruncPadding, which prepends the true
length at element 0; the model consumes batch[:, 1:-1] and targets are
batch[:, 2:] (shift by one), while MMLU eval reads the answer position from
element 0.
"""
from __future__ import annotations

import os
import random
from typing import Callable, Iterable, Iterator, List

import numpy as np

from spt_proto_tpu_torch.data import mmlu as mmlu_mod
from spt_proto_tpu_torch.data.reader import (cycle, iter_jsonl, text_folder,
                                             weighted_mux)
from spt_proto_tpu_torch.data.transform import clamp_padding, trunc_padding

Tokenizer = Callable[[str], List[int]]


def default_tokenizer(path: str) -> Tokenizer:
    """The encoder of the tokenizer saved in the local directory `path`
    (transformers' AutoTokenizer, imported only here)."""
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
    return lambda text: tok.encode(text)


def batch_from_rows(rows: List[List[int]]) -> dict:
    """TruncPadding-style rows ([length] + tokens) -> model batch.

    inputs = row[1:-1], targets = row[2:], mask = positions before pad
    (derived from the length prefix)."""
    arr = np.asarray(rows, dtype=np.int32)
    lengths = arr[:, 0]
    inputs = arr[:, 1:-1]
    targets = arr[:, 2:]
    pos = np.arange(inputs.shape[1])[None, :]
    mask = (pos < (lengths - 2)[:, None]).astype(np.float32)
    return {'inputs': inputs, 'targets': targets, 'mask': mask,
            'lengths': lengths}


def _batched(row_iter: Iterable[List[int]], batch_size: int,
             drop_last: bool = True) -> Iterator[dict]:
    buf: List[List[int]] = []
    for row in row_iter:
        buf.append(row)
        if len(buf) == batch_size:
            yield batch_from_rows(buf)
            buf = []
    if buf and not drop_last:
        yield batch_from_rows(buf)


def mmlu_batches(root: str, tokenizer: Tokenizer, *, mode: str = 'test',
                 n_shots: int = 5, seq_length: int = 513,
                 batch_size: int = 8, shuffle: bool = False,
                 seed: int = 0, infinite: bool = False) -> Iterator[dict]:
    """MMLU eval/train batches (ref loaders/mmlu.py:37-46: tokenize ->
    TruncPadding(seq_length) -> tensor)."""
    def rows():
        src = mmlu_mod.iter_mmlu_prompts(root, mode, n_shots=n_shots,
                                         shuffle=shuffle, seed=seed)
        if infinite:
            src = cycle(lambda: mmlu_mod.iter_mmlu_prompts(
                root, mode, n_shots=n_shots, shuffle=shuffle, seed=seed))
        for text in src:
            yield trunc_padding(tokenizer(text), seq_length)
    return _batched(rows(), batch_size)


def lm_batches(text_iter: Iterable[str], tokenizer: Tokenizer, *,
               seq_length: int = 512, batch_size: int = 8,
               seed: int = 0) -> Iterator[dict]:
    """Generic LM batches with ClampPadding (random window crop) — the
    wikitext flow (ref loaders/wikitext.py)."""
    rng = random.Random(seed)

    def rows():
        for text in text_iter:
            toks = tokenizer(text)
            # +1 so that inputs/targets shift still yields seq_length-2
            padded = clamp_padding(toks, seq_length, rng=rng)
            yield [min(len(toks), seq_length)] + padded
    return _batched(rows(), batch_size)


def wikitext_batches(root: str, tokenizer: Tokenizer, *, split: str = 'valid',
                     seq_length: int = 512, batch_size: int = 8,
                     seed: int = 0) -> Iterator[dict]:
    """wikitext-103 raw files (ref loaders/wikitext.py:9-73)."""
    folder = os.path.join(root, 'wikitext-103')
    it = text_folder(folder, pattern=f'*{split}*', min_length=64,
                     do_sanitize=True, seed=seed)
    return lm_batches(it, tokenizer, seq_length=seq_length,
                      batch_size=batch_size, seed=seed)


def flanmini_prompts(root: str) -> Iterator[str]:
    """flan-mini jsonl instruction data (ref details/flanmini.py:13-42)."""
    import glob as _glob
    for path in sorted(_glob.glob(os.path.join(root, 'flan-mini', '*.jsonl'))):
        for item in iter_jsonl(path):
            src = item.get('input') or item.get('instruction') or ''
            tgt = item.get('output') or item.get('response') or ''
            yield f'{src}\n{tgt}'


def mmlu_flan_mixture(root: str, tokenizer: Tokenizer, *,
                      seq_length: int = 513, batch_size: int = 8,
                      seed: int = 0) -> Iterator[dict]:
    """Training mixture: MMLU aux-train 0.1 + FlanMini 1.0
    (ref loaders/mmlu.py:48-58)."""
    mm = cycle(lambda: mmlu_mod.iter_mmlu_prompts(root, 'train', n_shots=0,
                                                  shuffle=True, seed=seed))
    fl = cycle(lambda: flanmini_prompts(root))
    mix = weighted_mux({mm: 0.1, fl: 1.0}, seed=seed)

    def rows():
        for text in mix:
            yield trunc_padding(tokenizer(text), seq_length)
    return _batched(rows(), batch_size)


def alpaca_prompts(root: str) -> Iterator[str]:
    """Alpaca instruction prompts (ref legacy/alpaca.py:37-102)."""
    for path in (os.path.join(root, 'alpaca', 'alpaca_data.json'),
                 os.path.join(root, 'alpaca', 'alpaca.jsonl')):
        if os.path.exists(path):
            import json
            if path.endswith('.json'):
                with open(path) as f:
                    items = json.load(f)
            else:
                items = list(iter_jsonl(path))
            for item in items:
                instr = item.get('instruction', '')
                inp = item.get('input', '')
                out = item.get('output', '')
                if inp:
                    yield (f'Below is an instruction that describes a task, '
                           f'paired with an input that provides further '
                           f'context.\n\n### Instruction:\n{instr}\n\n'
                           f'### Input:\n{inp}\n\n### Response:\n{out}')
                else:
                    yield (f'Below is an instruction that describes a task.'
                           f'\n\n### Instruction:\n{instr}\n\n'
                           f'### Response:\n{out}')
            return
    raise FileNotFoundError(f'no alpaca data under {root}/alpaca')
