"""A model of the launch the Mamba chunk-scan kernels work out for a call
(``src/repro_torch/kernels/csrc/mamba_scan.cu:Plan``), from their design:
states padded to DS = 8 or 16, a thread owning Q = 4 of a channel's states
(``kQFwd``, ``kQBwd``), 128 threads a forward block and 256 a backward
block (``kFwdThreads``, ``kBwdThreads``), 16-step tiles and segments
(``kTile``, ``kSeg``). ``tests/test_torch_mamba_plan.py`` runs
its model of the kernels' order of sums on it (also at narrower blocks);
``tests/test_torch_port.py`` holds the built library's plan to it on the
card. Imports neither JAX nor the port."""
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

Q, FWD_THREADS, BWD_THREADS, STEPS = 4, 128, 256, 16


@dataclass(frozen=True)
class ModelPlan:
    DS: int
    q: int
    lanes: int
    threads: int
    channels: int
    grid: Tuple[int, int]
    steps: int
    nseg: int


def model_plan(B: int, c: int, di: int, ds: int, backward: bool,
               threads: Optional[int] = None) -> ModelPlan:
    """The launch at (B, c, di, ds) in one direction, with blocks of
    ``threads`` threads (by default the kernels' own)."""
    if threads is None:
        threads = BWD_THREADS if backward else FWD_THREADS
    DS = 8 if ds <= 8 else 16
    q = min(Q, DS)
    lanes = DS // q
    channels = threads // lanes
    return ModelPlan(DS, q, lanes, threads, channels,
                     (-(-di // channels), B), STEPS, -(-c // STEPS))


def owners(p, di: int, ds: int) -> np.ndarray:
    """(di, ds) counts of the threads of one batch row's blocks that own each
    (channel, state) under plan ``p``: thread t of block x owns channel
    x * channels + t // lanes and states (t % lanes) * q + [0, q)."""
    tiles, _ = p.grid
    tid = np.arange(p.threads)
    ch, sg = tid // p.lanes, tid % p.lanes
    d = np.arange(tiles)[:, None] * p.channels + ch[None, :]
    s = sg[None, :, None] * p.q + np.arange(p.q)[None, None, :]
    d = np.broadcast_to(d[:, :, None], (tiles, p.threads, p.q))
    s = np.broadcast_to(s, (tiles, p.threads, p.q))
    keep = (d < di) & (s < ds)
    count = np.zeros((di, ds), np.int64)
    np.add.at(count, (d[keep], s[keep]), 1)
    return count
