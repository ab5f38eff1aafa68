"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` compiles with nvcc for sm_90a (one nvcc process per
source, all started together), and the objects link into one shared
library with a plain C interface that is loaded with ctypes. The library
lands in `_build/<hash>/` (listed in .gitignore), keyed by a hash of the
sources and flags, so it is rebuilt at first use whenever a source changes.
Processes that start at once on a fresh checkout (the ranks of a world)
build it once: the build holds a file lock on its directory, and the
others wait for it and load the library it leaves.
Nothing here runs at import time: the CPU tests import every module of the
package on a machine without nvcc or a GPU.

Each C entry point launches on the stream it is given, allocates nothing,
and returns cudaGetLastError() after its launches; `check` turns a non-zero
return into an exception.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / 'csrc'
BUILD_DIR = _HERE / '_build'
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ('-std=c++17', '-O3', '-Xcompiler', '-fPIC')

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    'spt_decode_front': [_I, _I] + [_P] * 6 + [_I] * 3 + [_P] * 12 + [_I]
                        + [_P] * 9 + [_I] * 13 + [_F, _F] + [_I] * 7
                        + [_P] * 3,
    'spt_decode_attention': [_I, _I] + [_P] * 12 + [_I] * 10
                            + [_F, _F, _I, _I, _P, _P, _P],
    'spt_rows_split_scores': [_I] * 4,
    'spt_decode_attention_q': [_I, _I] + [_P] * 16 + [_I] * 11
                              + [_F, _F, _I, _P, _P, _P, _P],
    'spt_verify_attention': [_I, _I] + [_P] * 12 + [_I] * 9
                            + [_F, _F, _I, _I, _I, _P, _I, _P],
    'spt_verify_split_scores': [_I] * 3,
    'spt_ffn_tail': [_I] + [_P] * 8 + [_I] * 4 + [_P],
    'spt_ffn_tail_int8': [_I] + [_P] * 10 + [_I] * 6 + [_P],
    'spt_ffn_tail_gated': [_I] + [_P] * 7 + [_I] * 4 + [_P],
    'spt_ffn_tail_gated_int8': [_I] + [_P] * 10 + [_I] * 6 + [_P],
    'spt_int8_matmul': [_I] + [_P] * 4 + [_I] * 5 + [_P],
    'spt_int8_matmul_t': [_I] + [_P] * 4 + [_I] * 5 + [_P],
    'spt_int8_matmul_tc': [_P] * 5 + [_I] * 9 + [_P],
    'spt_ffn_tail_tc': [_I] + [_P] * 13 + [_I] * 13 + [_P],
    'spt_lm_head_argmax': [_I] + [_P] * 6 + [_I] * 3 + [_P],
    'spt_lm_head_argmax_int8': [_I] + [_P] * 7 + [_I] * 5 + [_P],
    'spt_block_sparse_fwd': [_I, _I] + [_P] * 6 + [_I] * 6
                            + [_F, _F, _I, _P],
    'spt_block_sparse_bwd': [_I] * 3 + [_P] * 11 + [_I] * 6
                            + [_F, _F, _I, _P],
    'spt_paged_attention': [_I, _I] + [_P] * 8 + [_I] * 7 + [_F, _I, _I,
                                                             _P, _P],
    'spt_paged_split_scores': [_I] * 5,
    'spt_gmm': [_I, _I] + [_P] * 4 + [_I] * 4 + [_L] * 3 + [_P],
    'spt_tgmm': [_I] + [_P] * 4 + [_I] * 4 + [_P],
    'spt_gmm_tc': [_I, _I] + [_P] * 4 + [_I] * 4 + [_L] * 3 + [_P],
    'spt_tgmm_tc': [_I] + [_P] * 5 + [_I] * 5 + [_P],
    'spt_tile_pool_attention': [_I] + [_P] * 13 + [_I] * 7 + [_F, _F, _P],
    'spt_flash_fwd': [_I] + [_P] * 6 + [_I] * 4 + [_F, _P, _P],
    'spt_flash_bwd': [_I] + [_P] * 10 + [_I] * 4 + [_F, _P, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                           'bin', 'nvcc')
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels are built with the '
                       'CUDA toolkit on a machine with an sm_90 GPU')


def build() -> Path:
    """Compile csrc/*.cu into one shared library (cached by content hash)
    and return its path."""
    sources = sorted(CSRC.glob('*.cu'))
    headers = sorted(CSRC.glob('*.cuh'))
    flags = [*ARCH_FLAGS, *NVCC_FLAGS]
    h = hashlib.sha256(' '.join(flags).encode())
    for f in sources + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib_path = out_dir / 'libspt_kernels.so'
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / '.lock', 'w') as lock:
        # one process builds; the others wait here and find its library
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not lib_path.exists():
                _compile(sources, flags, out_dir, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def _compile(sources, flags, out_dir: Path, lib_path: Path) -> None:
    nvcc = nvcc_path()
    procs = []
    for src in sources:
        obj = out_dir / f'{src.stem}.o'
        procs.append((src, subprocess.Popen(
            [nvcc, *flags, '-c', str(src), '-o', str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f'{src.name}:\n{out}')
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    tmp = out_dir / f'libspt_kernels.{os.getpid()}.so'
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, '-shared', '-o', str(tmp),
         *[str(out_dir / f'{s.stem}.o') for s in sources]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f'nvcc link failed:\n{link.stdout}')
    os.replace(tmp, lib_path)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def build_timed() -> float:
    """Build and load the library; returns the seconds it took."""
    t0 = time.perf_counter()
    lib()
    return time.perf_counter() - t0


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} '
                           f'({torch.cuda.get_device_name()})')


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f'kernels take float32 or bfloat16, got {t.dtype}') \
            from None


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def require(cond: bool, msg: str) -> None:
    """Wrapper argument check that survives python -O."""
    if not cond:
        raise ValueError(msg)


def on_cuda(*ts: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when all are on
    the CPU; mixed devices raise."""
    kinds = {t.device.type for t in ts}
    if kinds == {'cpu'}:
        return False
    if kinds == {'cuda'}:
        return True
    raise ValueError(f'tensors on mixed devices: {sorted(kinds)}')
