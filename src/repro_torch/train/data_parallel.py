"""Data-parallel training: the paper's ghost batches made literal on
hardware (the port of ``repro.train.data_parallel``).

Hoffer et al. compute normalization statistics over small "ghost" slices of
the large batch, and note this is what a data-parallel cluster does for
free, since each worker only sees its own shard. With one process a rank:

- the batch splits over the mesh's dp axes; parameters, BN running state
  and the optimizer state are replicated;
- every rank evaluates the SAME vision loss as the single-device trainer
  (:func:`repro_torch.train.trainer.make_vision_loss_fn`) on its shard, so
  the ghost statistics that NORMALIZE activations are per rank by
  construction and never cross processes;
- a step's traffic is one all-reduce: the gradients, the running-EMA state
  (averaged so the replicated inference statistics stay identical
  everywhere) and the two scalar metrics, packed into one buffer; the
  replicated SGD update then keeps every rank's parameters bit-identical.

A shard of ``B/ndev`` rows split into ghosts of ``|B_S|`` rows partitions
the global batch exactly as the single-device GBN step does, so the loss
and gradients MATCH the single-device step (same ghost boundaries, a mean
of means over equal shards). Only the running-statistics EMA differs:
each rank folds its own ghosts before the average. The general
data x model step lives in :mod:`repro_torch.train.parallel`; this module
keeps the 1-D names.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_models import VisionModelConfig
from repro_torch.core.large_batch import LargeBatchConfig
from repro_torch.core.regime import Regime
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import DATA_AXIS, dp_axes
from repro_torch.train import parallel

Tensor = torch.Tensor


def _check_axis(axis: str, mesh) -> None:
    """``axis`` must name a dp axis of ``mesh``: ignoring a custom name
    would skip every reduction."""
    if axis not in dp_axes(mesh):
        raise ValueError(
            f"axis {axis!r} is not a data-parallel axis of mesh "
            f"{tuple(mesh.axis_names)}; the batch shards over "
            f"{dp_axes(mesh)}")


def mesh_compatible(lb: LargeBatchConfig, mesh, *, axis: str = DATA_AXIS,
                    batch_size: int = 0,
                    cfg: Optional[ModelConfig] = None) -> bool:
    """:func:`repro_torch.train.parallel.mesh_compatible` (batch over the
    dp axes, whole ghosts a shard, experts over the model axis) for 1-D
    callers; ``axis`` must name a dp axis of the mesh."""
    _check_axis(axis, mesh)
    return parallel.mesh_compatible(lb, mesh, batch_size=batch_size, cfg=cfg)


def make_dp_vision_train_step(model_apply: Callable, cfg: VisionModelConfig,
                              lb: LargeBatchConfig, regime: Regime, mesh, *,
                              weight_decay: float = 5e-4,
                              use_kernels: bool = False,
                              axis: str = DATA_AXIS) -> Callable:
    """The data-parallel vision step: (params, bn_state, opt_state, x, y,
    step, generator=None) -> (params, bn_state, opt_state, metrics), x and
    y this rank's rows. Delegates to
    :func:`repro_torch.train.parallel.make_mesh_vision_train_step`."""
    _check_axis(axis, mesh)
    return parallel.make_mesh_vision_train_step(
        model_apply, cfg, lb, regime, mesh, weight_decay=weight_decay,
        use_kernels=use_kernels)


def dp_gbn_forward(x: Tensor, gamma: Tensor, beta: Tensor, mesh, *,
                   ghost_batch_size: int, eps: float = 1e-5,
                   use_kernels: bool = False, axis: str = DATA_AXIS
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """The data-parallel GBN forward, every rank's ghost statistics in
    view.

    x: this rank's (B_local, ..., C) rows; gamma/beta: (C,) replicated.
    Returns (y (B_local, ..., C), mu, var) with mu/var (ndev * G_local, C)
    stacked rank-major: one row of statistics a ghost a rank, none of them
    synchronized (the gather only shows them). ``use_kernels`` normalizes
    through the GBN kernel (B1), else its plain version."""
    C_ = x.shape[-1]
    ndev = mesh.shape[axis]
    if x.shape[0] % ghost_batch_size:
        raise ValueError(
            f"local batch {x.shape[0]} not divisible by "
            f"ghost_batch_size={ghost_batch_size}")
    G = x.shape[0] // ghost_batch_size
    xg = x.float().reshape(G, -1, C_).contiguous()
    g, b = gamma.float(), beta.float()
    if use_kernels:
        from repro_torch.kernels import ops as kops
        y, mu, var = kops.gbn_forward(xg, g, b, eps=eps)
    else:
        from repro_torch.kernels import ref
        y, mu, var = ref.gbn_ref(xg, g, b, eps=eps)
    if ndev > 1:
        mu = C.all_gather(mu.contiguous(), axis, mesh, 0)
        var = C.all_gather(var.contiguous(), axis, mesh, 0)
    return y.reshape(x.shape).to(x.dtype), mu, var
