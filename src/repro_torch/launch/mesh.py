"""Process meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``).

The JAX package lays a mesh over devices and runs ``shard_map`` regions on
it. The port runs one process per rank: rank r of a mesh of shape
(n_0, ..., n_k) sits at the row-major coordinates of r, computes on
``mesh.device`` and holds its slice of every sharded tensor. A reduction
over a set of axes runs in the process group of the ranks that share this
rank's coordinates on every other axis. :class:`Mesh` creates one group
per non-empty set of axes whose product exceeds 1 (data, model, both; pod
x data, ...), on every rank in one fixed order, as ``dist.new_group``
requires.

The axis NAMES are the module constants ``POD_AXIS`` / ``DATA_AXIS`` /
``MODEL_AXIS``; the collectives (:mod:`repro_torch.launch.collectives`)
take them, never string literals (lint rule ``axis-name-literal``).

The shape-only helpers (:func:`dp_axes`, :func:`dp_size`,
:func:`dp_spec_entry`, :func:`fsdp_axes`, :func:`axis_size`) read only
``mesh.shape`` (axis name -> size) and ``mesh.axis_names``, so a
``SimpleNamespace(shape=..., axis_names=...)`` stub serves them as it
serves the reference's.
"""
from __future__ import annotations

import itertools
import os
from typing import Any, Dict, FrozenSet, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, process_index_count, resolve_device

POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"

Axes = Tuple[str, ...]


def init_distributed(init_method: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "gloo") -> None:
    """Join the default process group (idempotent).

    With no arguments it reads a launcher's environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them)
    and does nothing without ``WORLD_SIZE``. Otherwise pass the store
    (``tcp://127.0.0.1:<port>`` or ``file://<path>``), the world size and
    this process's rank. ``backend`` is "gloo" wherever ranks share a card
    or run on the CPU (NCCL refuses two ranks on one GPU), "nccl" on a
    host with a card a rank."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            return
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


class Mesh:
    """A named mesh of processes: ``axis_names``, ``shape`` (name -> size),
    this process's ``rank`` and ``coords`` (name -> index), the ``device``
    it computes on and one process group per reduced axis set.

    A mesh of size 1 is local to its process (no group, any world size);
    a larger one spans the whole initialised world, rank for rank."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device: DeviceLike = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        self.axis_names: Axes = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self.device = resolve_device(device)
        rank, world = process_index_count()
        if self.size == 1:
            rank = 0
        elif self.size != world:
            raise ValueError(f"a mesh of {self.size} ranks needs a world of "
                             f"{self.size} processes, not {world}")
        self.rank = rank
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(rank, tuple(shape)))))
        self._groups: Dict[FrozenSet[str], Any] = {}
        if self.size > 1:
            self._make_groups()

    def _make_groups(self) -> None:
        """Every group in the default group's backend."""
        import torch.distributed as dist
        backend = dist.get_backend()
        dims = tuple(self.shape.values())
        ranks = np.arange(self.size).reshape(dims)
        for r in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, r):
                if self.axis_size(axes) == 1:
                    continue
                keep = [i for i, a in enumerate(self.axis_names)
                        if a in axes]
                rest = [i for i in range(len(dims)) if i not in keep]
                # one group per combination of the other axes' coordinates
                blocks = np.transpose(ranks, rest + keep).reshape(
                    -1, self.axis_size(axes))
                for members in blocks:
                    g = dist.new_group([int(m) for m in members],
                                       backend=backend)
                    if self.rank in members:
                        self._groups[frozenset(axes)] = g

    def axis_size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in axes:
            n *= self.shape.get(a, 1)
        return n

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` (None when their product is 1:
        nothing to reduce)."""
        axes = tuple(a for a in axes if a in self.shape)
        if self.axis_size(axes) == 1:
            return None
        return self._groups[frozenset(axes)]

    def index(self, axes: Sequence[str]) -> int:
        """This rank's position along ``axes`` flattened row-major in the
        given order (the first axis the slowest), as a tiled all-gather
        over those axes orders its pieces."""
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords},"
                f" device={self.device})")


def _world() -> int:
    return process_index_count()[1]


def make_host_mesh(device: DeviceLike = None) -> Mesh:
    """Degenerate (1, 1) ("data", "model") mesh of this process alone."""
    return Mesh((1, 1), (DATA_AXIS, MODEL_AXIS), device=device)


def make_data_mesh(n_devices: int = 0, device: DeviceLike = None) -> Mesh:
    """1-D ("data",) mesh over the world's ranks: one slot per GBN shard,
    the data-parallel vision trainer's mesh."""
    return Mesh((n_devices or _world(),), (DATA_AXIS,), device=device)


def make_2d_mesh(n_devices: int = 0, model: int = 0,
                 device: DeviceLike = None) -> Mesh:
    """2-D ("data", "model") mesh over the world's ranks. ``model=0``
    picks 2 when the rank count is even (the smallest non-degenerate model
    axis), else 1."""
    n = n_devices or _world()
    m = model or (2 if n > 1 and n % 2 == 0 else 1)
    if n % m:
        raise ValueError(f"{n} devices do not factor into model={m}")
    return Mesh((n // m, m), (DATA_AXIS, MODEL_AXIS), device=device)


def make_local_mesh(model: int = 1, device: DeviceLike = None) -> Mesh:
    """2-D ("data", "model") mesh over THIS process's devices: one device
    a process, so (1, 1)."""
    if model <= 0 or 1 % model:
        raise ValueError(f"1 local devices do not factor into model={model}")
    return Mesh((1, 1), (DATA_AXIS, MODEL_AXIS), device=device)


def spec_axes(entry) -> Axes:
    """The axes of one spec entry: None -> (), a name -> (name,), a tuple
    as it is."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def global_array(mesh: Mesh, arr, spec) -> torch.Tensor:
    """This rank's slice of a global tensor (numpy or torch, the same on
    every rank) laid out by ``spec`` (one entry per dim), as its own
    contiguous tensor on ``mesh.device`` (the kernels refuse views)."""
    t = torch.as_tensor(arr)
    idx = []
    for dim, entry in zip(t.shape, tuple(spec) + (None,) * t.dim()):
        axes = spec_axes(entry)
        n = mesh.axis_size(axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {axes} ({n})")
        k = dim // n
        i = mesh.index(axes)
        idx.append(slice(i * k, (i + 1) * k))
    return t[tuple(idx)].to(mesh.device).contiguous().clone()


def dp_axes(mesh) -> Axes:
    """The axes the global batch is sharded over (only those present)."""
    return tuple(a for a in (POD_AXIS, DATA_AXIS) if a in mesh.axis_names)


def dp_size(mesh) -> int:
    """Total data-parallel ways: the product of the present dp axis sizes."""
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def dp_spec_entry(mesh):
    """The dp axes as one spec entry: None without data axes, the bare
    name for one, the tuple for several."""
    axes = dp_axes(mesh)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def fsdp_axes(mesh) -> Axes:
    """The axes parameters are fully-sharded over (in addition to 'model')."""
    return ((DATA_AXIS, POD_AXIS) if POD_AXIS in mesh.axis_names
            else (DATA_AXIS,))


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1
