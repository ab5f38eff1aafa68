"""Text/token transforms (port of spt_proto_tpu/data/transform.py).

Sanitize (regex cleanup), ClampPadding (pad or random-window crop) and
TruncPadding (pad or keep-tail with the true sequence length prepended as
element 0, which the MMLU eval uses to locate the answer token). Pure
Python; `sanitize` takes the native C++ implementation
(runtime/textproc.cc, through the serving engine's ctypes binding of
runtime/libsptrt.so) where it applies, byte for byte the same output.
"""
from __future__ import annotations

import random
import re
from typing import List, Sequence


def sanitize_py(text: str) -> str:
    """Whitespace/punctuation normalization (ref transform.py:7-37).

    Pure-Python reference; `sanitize` dispatches to the native C++
    implementation (runtime/textproc.cc) when the runtime library is
    available, with byte-identical output.
    """
    normalizes = [
        (r'\(\)', ' '), (r'\[\]', ' '), (r'\{\}', ' '),
        (r'\s([\,\.\?\!\;\:])', r'\g<1>'),
    ]
    blanks = [(r'\s+', ' '), (r'^\s+', ''), (r'\s+$', '')]
    out = []
    for paragraph in text.split('\n\n'):
        for pattern, repl in normalizes:
            paragraph = re.sub(pattern, repl, paragraph)
            for bp, br in blanks:
                paragraph = re.sub(bp, br, paragraph)
        if paragraph:
            out.append(paragraph)
    return '\n\n'.join(out)


_NATIVE_SANITIZE = None


def _native_sanitize():
    global _NATIVE_SANITIZE
    if _NATIVE_SANITIZE is None:
        try:
            import ctypes
            from spt_proto_tpu_torch.inference.batching import \
                native_scheduler_lib
            lib = native_scheduler_lib()
            lib.textproc_sanitize.restype = ctypes.c_int32
            lib.textproc_sanitize.argtypes = [
                ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p,
                ctypes.c_int32]

            def call(text: str) -> str:
                raw = text.encode('utf-8')
                cap = len(raw) + 16
                buf = ctypes.create_string_buffer(cap)
                n = lib.textproc_sanitize(raw, len(raw), buf, cap)
                if n < 0:   # shouldn't happen: output never grows
                    return sanitize_py(text)
                return buf.raw[:n].decode('utf-8')
            _NATIVE_SANITIZE = call
        except Exception:
            _NATIVE_SANITIZE = False
    return _NATIVE_SANITIZE or None


# Unicode whitespace that Python's \s matches but the bytewise C++ fast
# path does not; their presence routes to the Python implementation.
_UNICODE_WS = ('\xa0        '
               '        　'
               '\x1c\x1d\x1e\x1f\x85')


def sanitize(text: str) -> str:
    native = _native_sanitize()
    if native is not None and not any(c in text for c in _UNICODE_WS):
        return native(text)
    return sanitize_py(text)


def clamp_padding(sequence: Sequence[int], seq_length: int,
                  pad_value: int = 0,
                  rng: random.Random | None = None) -> List[int]:
    """Pad to seq_length, or crop a random window (training-friendly,
    ref transform.py:40-66)."""
    seq = list(sequence)
    n = len(seq)
    if n < seq_length:
        seq.extend([pad_value] * (seq_length - n))
    elif n > seq_length:
        r = rng if rng is not None else random
        left = r.randrange(n - seq_length + 1)
        seq = seq[left:left + seq_length]
    return seq


def trunc_padding(sequence: Sequence[int], seq_length: int,
                  pad_value: int = 0) -> List[int]:
    """Pad or keep-tail; PREPENDS the true (clamped) sequence length as
    element 0 (ref transform.py:69-92) — the eval decodes answers at that
    position."""
    seq = list(sequence)
    n = len(seq)
    if n < seq_length:
        seq = seq + [pad_value] * (seq_length - n)
    elif n > seq_length:
        seq = seq[-seq_length:]
        n = seq_length
    return [n] + seq
