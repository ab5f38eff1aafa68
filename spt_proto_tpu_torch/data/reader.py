"""Streaming text readers: line/CSV/JSONL folders, weighted mixtures,
shuffle buffers (port of spt_proto_tpu/data/reader.py). Plain Python
generators: FileOpener -> parser -> Cycler -> weighted SampleMultiplexer
-> Sanitize -> min-length filter -> Shuffler, with Python's `random`
seeded as the JAX package seeds it, so both give the same stream.
"""
from __future__ import annotations

import glob
import io
import json
import os
import random
from typing import Callable, Dict, Iterable, Iterator, List, Optional

from spt_proto_tpu_torch.data.transform import sanitize


def iter_lines(path: str, skip_lines: int = 0) -> Iterator[str]:
    with io.open(path, encoding='utf-8', errors='ignore') as f:
        for i, line in enumerate(f):
            if i < skip_lines:
                continue
            yield line.rstrip('\n')


def iter_jsonl(path: str) -> Iterator[dict]:
    with io.open(path, encoding='utf-8', errors='ignore') as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def cycle(make_iter: Callable[[], Iterator]) -> Iterator:
    """Infinite restartable cycle (ref reader.py Cycler)."""
    while True:
        emitted = False
        for item in make_iter():
            emitted = True
            yield item
        if not emitted:
            return


def weighted_mux(sources: Dict[Iterator, float],
                 seed: Optional[int] = None) -> Iterator:
    """Weighted sample multiplexer over infinite iterators
    (ref reader.py:47-56, details/concat.py:5-26)."""
    rng = random.Random(seed)
    items = list(sources.items())
    iters = [it for it, _ in items]
    weights = [w for _, w in items]
    while iters:
        i = rng.choices(range(len(iters)), weights=weights)[0]
        try:
            yield next(iters[i])
        except StopIteration:
            del iters[i], weights[i]


def shuffle_buffer(it: Iterable, buffer_size: int,
                   seed: Optional[int] = None) -> Iterator:
    """Streaming shuffle (ref reader.py Shuffler)."""
    rng = random.Random(seed)
    buf: List = []
    for item in it:
        buf.append(item)
        if len(buf) >= buffer_size:
            j = rng.randrange(len(buf))
            buf[j], buf[-1] = buf[-1], buf[j]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def text_folder(root: str, *, pattern: str = '*', min_length: int = 64,
                skip_lines: int = 0, do_sanitize: bool = True,
                shuffle: bool = False, buffer_size: int = 16384,
                seed: Optional[int] = None,
                infinite: bool = False) -> Iterator[str]:
    """Weighted (by file size, ref reader.py:138-141) line stream over a
    folder of text files."""
    paths = sorted(glob.glob(os.path.join(root, pattern)))
    paths = [p for p in paths if os.path.isfile(p)]
    if not paths:
        raise FileNotFoundError(f'no files match {root}/{pattern}')

    def stream():
        if infinite:
            sources = {
                cycle(lambda p=p: iter_lines(p, skip_lines)):
                    float(os.path.getsize(p))
                for p in paths
            }
            yield from weighted_mux(sources, seed=seed)
        else:
            for p in paths:
                yield from iter_lines(p, skip_lines)

    it = stream()
    if do_sanitize:
        it = (sanitize(t) for t in it)
    it = (t for t in it if len(t) >= min_length)
    if shuffle:
        it = shuffle_buffer(it, buffer_size, seed=seed)
    return it
