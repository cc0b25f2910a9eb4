"""Collectives over a mesh's named axes: the port's stand-ins for
``lax.psum`` / ``pmean`` / ``all_gather(tiled=True)`` / ``psum_scatter`` /
``axis_index``, all built from one primitive, ``all_reduce(SUM)``.

- :func:`all_gather` places this rank's piece into a zero buffer of the
  gathered shape and sums: exact, since it only adds zeros.
- :func:`psum_scatter` sums, then keeps this rank's piece (a contiguous
  copy).

``all_reduce`` is the one collective every backend takes on both CPU and
CUDA tensors: gloo on the CPU (the tests), gloo between ranks that share
one GPU (NCCL refuses two ranks on a card), NCCL on a host with a card a
rank. Where the installed gloo refuses CUDA tensors, the first collective
on a CUDA mesh finds out (every rank alike, before any data moves), says so
once on stderr, and from then on copies each operand through pinned host
memory, counted in ``STATS["staged_bytes"]``; the computation stays on the
card.

``STATS`` counts the calls and bytes (``bytes``: the tensor's size, once a
call); inside ``with timed():`` every call synchronizes the device before
and after and adds its wall ms to ``STATS["ms"]``.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Sequence, Union

import torch

from repro_torch.launch.mesh import Mesh

Axes = Union[str, Sequence[str]]

STATS: Dict[str, float] = {"calls": 0, "bytes": 0, "staged_bytes": 0,
                           "ms": 0.0}
_TIMED = [False]
_STAGED = [None]          # None: not probed yet; then True / False


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k == "ms" else 0


@contextlib.contextmanager
def timed():
    """Time every collective inside (device synchronized around each)."""
    _TIMED[0] = True
    try:
        yield STATS
    finally:
        _TIMED[0] = False


def _axes(axes: Axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether CUDA tensors must go through host memory: probed once, on a
    one-element tensor, the first time a CUDA tensor is reduced."""
    if t.device.type != "cuda":
        return False
    if _STAGED[0] is None:
        import torch.distributed as dist
        try:
            dist.all_reduce(torch.zeros(1, device=t.device), group=group)
            _STAGED[0] = False
        except RuntimeError as e:
            _STAGED[0] = True
            print(f"collectives: the {dist.get_backend(group)} backend "
                  f"refuses CUDA tensors ({e}); staging through pinned "
                  f"host memory", file=sys.stderr, flush=True)
    return _STAGED[0]


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group``."""
    import torch.distributed as dist
    nbytes = t.numel() * t.element_size()
    STATS["calls"] += 1
    STATS["bytes"] += nbytes
    if _TIMED[0] and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    if _staged(t, group):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.all_reduce(host, group=group)
        t.copy_(host)
        STATS["staged_bytes"] += 2 * nbytes
    else:
        dist.all_reduce(t, group=group)
    if _TIMED[0]:
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        STATS["ms"] += (time.perf_counter() - t0) * 1e3
    return t


def psum(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axes`` (a new tensor)."""
    group = mesh.group(_axes(axes))
    if group is None:
        return x
    return _all_reduce_(x.detach().clone(), group)


def pmean(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    n = mesh.axis_size(_axes(axes))
    if n == 1:
        return x
    return psum(x, axes, mesh) / n


def pmean_many(xs: List[torch.Tensor], axes: Axes, mesh: Mesh
               ) -> List[torch.Tensor]:
    """:func:`pmean` of each tensor, the tensors of one dtype packed into
    one buffer: one all-reduce a dtype instead of one a tensor."""
    n = mesh.axis_size(_axes(axes))
    if n == 1 or not xs:
        return list(xs)
    out: List[torch.Tensor] = list(xs)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([xs[i].detach().reshape(-1) for i in idx])
        flat = _all_reduce_(flat, mesh.group(_axes(axes))) / n
        for i, piece in zip(idx, flat.split([xs[i].numel() for i in idx])):
            out[i] = piece.view(xs[i].shape)
    return out


def axis_index(axes: Axes, mesh: Mesh) -> int:
    return mesh.index(_axes(axes))


def all_gather(x: torch.Tensor, axes: Axes, mesh: Mesh, dim: int = 0
               ) -> torch.Tensor:
    """The pieces of ``x`` along ``axes`` concatenated on ``dim`` in rank
    order along the axes (``all_gather(..., tiled=True)``)."""
    axes = _axes(axes)
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    k = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = k * n
    buf = x.new_zeros(shape)
    i = mesh.index(axes)
    buf.narrow(dim, i * k, k).copy_(x.detach())
    return _all_reduce_(buf, mesh.group(axes))


def psum_scatter(x: torch.Tensor, axes: Axes, mesh: Mesh, dim: int = 0
                 ) -> torch.Tensor:
    """This rank's piece (on ``dim``) of the sum over ``axes``
    (``psum_scatter(..., tiled=True)``)."""
    axes = _axes(axes)
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    total = psum(x, axes, mesh)
    k = x.shape[dim] // n
    return total.narrow(dim, mesh.index(axes) * k, k).contiguous()


def barrier() -> None:
    """Every rank of the world reaches this point (a one-element sum on
    the CPU over the default group); nothing without a group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.all_reduce(torch.zeros(1))
