"""Structured metrics logging (port of spt_proto_tpu/utils/metrics.py):
every run can append JSONL records, each stamped with its step and the
seconds since the logger opened, that downstream tooling (or jq) reads.
Values that convert to float are stored as floats (a 0-d tensor too),
others as they are."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer with wall-clock stamps."""

    def __init__(self, path: Optional[str] = None, *,
                 echo: bool = False):
        self.path = path
        self.echo = echo
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._f = open(path, 'a')
        else:
            self._f = None

    def log(self, step: int, metrics: Dict[str, Any], **extra) -> None:
        rec = {'step': int(step), 't': round(time.time() - self._t0, 3)}
        for k, v in {**metrics, **extra}.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + '\n')
            self._f.flush()
        if self.echo:
            print(line)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
