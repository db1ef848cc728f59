"""Start the ranks of a sharded program as processes of this host.

:func:`run_ranks` spawns ``world`` processes (the ``spawn`` start method:
each starts from a fresh import, so ``target`` and its arguments must be
picklable by import path), joins each to one process group through a
``FileStore`` file (no TCP port, so independent runs on one host never
meet), sets the card of each rank where the backend drives cards, runs
``target(rank, world, *args)`` and tears the group down.  Every
collective is bounded by the group's timeout and the whole run by
``timeout``: a rank that dies or hangs fails the run instead of stalling
it, and every process started is ended before the call returns.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time


def _rank_entry(rank, world, init_file, backend, timeout, threads, target,
                args):
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        target(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, target, args=(), *, backend: str = "gloo",
              timeout: float = 300.0, threads: int | None = None) -> None:
    """Run ``target(rank, world, *args)`` on ``world`` spawned ranks of one
    ``backend`` process group; ``threads`` sets each rank's torch threads.
    Raises ``RuntimeError`` when a rank fails and ``TimeoutError`` when
    the ranks outlast ``timeout`` seconds."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    init_file = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, init_file, backend, timeout,
                               threads, target, tuple(args)))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            for p in procs:
                p.join(0.1)
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.pid is None:              # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
    if any(c not in (None, 0) for c in codes):
        raise RuntimeError(f"rank exit codes {codes} (ranks {hung} ended "
                           f"after a failure)")
    if hung:
        raise TimeoutError(f"ranks {hung} outlasted {timeout} s")
