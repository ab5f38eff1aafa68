"""MMLU prompt construction + dataset iteration (port of
spt_proto_tpu/data/mmlu.py).

The "The following are multiple choice questions (with answers) about
{subject} ... Answer: X" prompt and the n-shot prefixing from a parallel
dev-set iterator. File layout expected:
  root/mmlu/{dev,val,test,auxiliary_train}/<subject>_<split>.csv
with 6 columns: question, A, B, C, D, answer.
"""
from __future__ import annotations

import csv
import glob
import io
import os
import random
from typing import Iterator, List, Optional, Sequence

PROMPT_HEAD = ('The following are multiple choice questions (with answers) '
               'about')
CHOICES = ['A', 'B', 'C', 'D']
SPLIT_DIRS = {'test': 'test', 'valid': 'val', 'train': 'auxiliary_train'}


def subject_from_path(path: str) -> str:
    """'.../abstract_algebra_test.csv' -> 'abstract algebra'
    (ref mmlu.py:83-87)."""
    filename = os.path.basename(path)
    stem = filename.rsplit('.', 1)[0]
    return ' '.join(stem.split('_')[:-1])


def format_question(row: Sequence[str], subject: str) -> str:
    """Ref mmlu.py:89-101."""
    assert len(row) == 6, row
    question = '{}\n'.format(row[0])
    question += '\n'.join('{}. {}'.format(CHOICES[i], row[1 + i])
                          for i in range(4))
    return '{} {}\n{}\nAnswer: {}'.format(PROMPT_HEAD, subject, question,
                                          row[-1])


def iter_csv_rows(root_dir: str, shuffle: bool = False,
                  seed: Optional[int] = None
                  ) -> Iterator[tuple[List[str], str]]:
    paths = sorted(glob.glob(os.path.join(root_dir, '*.csv')))
    if shuffle:
        random.Random(seed).shuffle(paths)
    for path in paths:
        with io.open(path, newline='', encoding='utf-8') as f:
            for row in csv.reader(f):
                if len(row) == 6:
                    yield row, path


def iter_mmlu_prompts(root: str, mode: str, *, n_shots: int = 0,
                      shuffle: bool = False, seed: Optional[int] = 0
                      ) -> Iterator[str]:
    """Yield few-shot prompt strings (ref MMLUDataset.__iter__:148-171).

    The n-shot context comes from a cycling iterator over mmlu/dev."""
    split = SPLIT_DIRS[mode]
    data_dir = os.path.join(root, 'mmlu', split)
    dev_dir = os.path.join(root, 'mmlu', 'dev')

    def dev_cycle():
        while True:
            found = False
            for row, path in iter_csv_rows(dev_dir, shuffle=True, seed=seed):
                found = True
                yield format_question(row, subject_from_path(path))
            if not found:
                return

    ctx = dev_cycle() if n_shots > 0 else None
    for row, path in iter_csv_rows(data_dir, shuffle=shuffle, seed=seed):
        text = format_question(row, subject_from_path(path))
        if n_shots > 0:
            shots = [next(ctx) for _ in range(n_shots)]
            text = '\n\n'.join(shots + [text])
        yield text
