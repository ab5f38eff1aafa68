"""Start a world of ranks on this host, one process each, for callers that
are not run under torchrun (the sharded CPU tests over gloo, chip_smoke.py's
ranks sharing one GPU).

`start(fn, world, args)` starts `world` processes (multiprocessing's spawn
start method), each of which joins a process group at a free localhost
port with the given backend and device, calls fn(rank, *args) and sends
back its result (anything picklable), and returns at once; `World.join`
returns the results in rank order and stops every process it started (a
rank that raises makes it stop the others and raise with that rank's
traceback), so the caller can work while the ranks run.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _entry(rank, world, port, backend, device, threads, fn, args, out):
    try:
        import torch
        import torch.distributed as dist

        from spt_proto_tpu_torch.parallel.mesh import initialize_multihost
        if threads:
            torch.set_num_threads(threads)
        initialize_multihost(f'127.0.0.1:{port}', world, rank,
                             backend=backend, device=device)
        try:
            res = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        # by value (plain pickle): multiprocessing's own pickler would hand
        # tensors over as shared memory that dies with this process
        out.put((rank, pickle.dumps(res), None))
    except BaseException:          # noqa: BLE001 - reported to the parent
        out.put((rank, None, traceback.format_exc()))


class World:
    """A started world of ranks (`start`); `join` waits for their results."""

    def __init__(self, procs, out, timeout: float):
        self.procs, self.out = procs, out
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def join(self) -> List[Any]:
        """The ranks' results in rank order; stops every process."""
        procs, world = self.procs, len(self.procs)
        results, errors = {}, []
        try:
            while len(results) < world and not errors:
                left = self.deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f'{world} ranks: no result in {self.timeout} s')
                try:
                    rank, res, err = self.out.get(timeout=min(left, 5.0))
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        raise RuntimeError(
                            f'rank process died: exit codes '
                            f'{[p.exitcode for p in procs]}') from None
                    continue
                if err is not None:
                    errors.append(f'rank {rank}:\n{err}')
                else:
                    results[rank] = pickle.loads(res)
        finally:
            for p in procs:
                p.join(timeout=1 if errors else 30)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
        if errors:
            raise RuntimeError('\n'.join(errors))
        return [results[r] for r in range(world)]


def start(fn: Callable, world: int, args: Sequence[Any] = (), *,
          backend: str = 'gloo', device: str = 'cpu', threads: int = 0,
          timeout: float = 900.0) -> World:
    """Start fn(rank, *args) on each of `world` ranks and return at once.
    fn must be importable by name (a module-level function)."""
    ctx = mp.get_context('spawn')
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, daemon=True, args=(
        r, world, port, backend, device, threads, fn, tuple(args), out))
        for r in range(world)]
    for p in procs:
        p.start()
    return World(procs, out, timeout)

