"""Batching pipeline (the port of ``repro.data.pipeline``): epoch-shuffled
minibatch index iterators, bit-equal to the reference's (both draw from
numpy's ``RandomState``), and the per-rank batch slice."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.launch.mesh import dp_axes, dp_size


def epoch_batches(rng: np.random.RandomState, n: int, batch_size: int,
                  drop_remainder: bool = True) -> Iterator[np.ndarray]:
    """Yield index arrays for one epoch."""
    perm = rng.permutation(n)
    end = n - n % batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        yield perm[i:i + batch_size]


def minibatch_stream(rng_seed: int, n: int, batch_size: int
                     ) -> Iterator[np.ndarray]:
    """Infinite stream of shuffled minibatch index arrays."""
    rng = np.random.RandomState(rng_seed)
    while True:
        yield from epoch_batches(rng, n, batch_size)


def shard_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's slice of a global batch: rows split evenly over the
    mesh's data-parallel axes, in rank order along them (the reference
    places the batch with a ``NamedSharding`` over those axes)."""
    n, i = dp_size(mesh), mesh.index(dp_axes(mesh))

    def one(a):
        if a.shape[0] % n:
            raise ValueError(f"batch of {a.shape[0]} rows does not split "
                             f"over {n} data-parallel ranks")
        k = a.shape[0] // n
        return a[i * k:(i + 1) * k]

    return {k: one(v) for k, v in batch.items()}
