"""Run a function on N ranks, one process each, with a time limit.

``run_ranks(fn, world, args)`` spawns ``world`` processes (start method
"spawn"); rank r calls ``fn(r, *args)`` after joining a gloo process
group through a ``file://`` store in a fresh temporary directory (gloo:
ranks may share a card, which NCCL refuses). A rank that
raises fails the whole run: its traceback is re-raised here and the other
ranks are terminated. Past ``timeout`` seconds every rank is killed and
``TimeoutError`` raised, so a collective that never completes (group
creation that differs between ranks, say) cannot hang the caller.

``fn`` must be importable by the children: a module-level function of a
module they can import (``sys.path`` is passed on).
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence


def _entry(rank: int, fn: Callable, world: int, init_method: str,
           threads: Optional[int], args: Sequence) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed
    if threads:
        torch.set_num_threads(threads)
    init_distributed(init_method, world, rank, "gloo")
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (), *,
              timeout: float = 600.0,
              threads: Optional[int] = None) -> None:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks and wait for all
    of them (see the module docstring). ``threads`` sets each rank's
    intra-op thread count."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="ranks_")
    init_method = f"file://{os.path.join(tmp, 'store')}"
    ctx = mp.start_processes(
        _entry, args=(fn, world, init_method, threads, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
