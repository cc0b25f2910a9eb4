"""Ghost Batch Normalization (Hoffer et al. 2017, Algorithm 1), in PyTorch.

Port of ``repro.core.gbn``. The large batch is scattered into ghost batches
of ``ghost_batch_size`` rows; training normalizes with per-ghost statistics,
inference with the running statistics. The running statistics follow the
paper's cascaded EMA (ghost batches absorbed sequentially, in closed form),
with the unbiased variance, and are set outright by the first batch.

Layout: x is (batch, ..., C) with C innermost; statistics reduce over the
batch rows of a ghost and every non-channel axis. A channels_last conv
activation, seen as (N, H, W, C), is such a tensor, and its (G, R, C) ghost
view is then free.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Params = Dict[str, Any]
Tensor = torch.Tensor


def gbn_init(n_features: int, device: torch.device = torch.device("cpu")
             ) -> Tuple[Params, Params]:
    """Returns (learnable params, running state)."""
    params = {
        "gamma": torch.ones(n_features, device=device),
        "beta": torch.zeros(n_features, device=device),
    }
    state = {
        "mu_run": torch.zeros(n_features, device=device),
        "var_run": torch.ones(n_features, device=device),
        "initialized": torch.zeros((), dtype=torch.bool, device=device),
    }
    return params, state


def _ghost_stats(xg: Tensor) -> Tuple[Tensor, Tensor]:
    """xg: (G, ghost_rows, C) -> per-ghost mean/var (G, C)."""
    mu = xg.mean(dim=1)
    var = (xg - mu[:, None, :]).square().mean(dim=1)
    return mu, var


def _cascaded_ema(run: Tensor, per_ghost: Tensor, eta: float) -> Tensor:
    """Closed form of folding G ghost statistics into the EMA in order:
    run <- (1-eta)^G run + eta * sum_i (1-eta)^(G-1-i) stats_i."""
    G = per_ghost.shape[0]
    decay = (1.0 - eta) ** torch.arange(G - 1, -1, -1, dtype=torch.float32,
                                         device=per_ghost.device)
    return (1.0 - eta) ** G * run + eta * (decay[:, None] * per_ghost).sum(0)


def _new_state(state: Params, first_mu: Tensor, first_var: Tensor,
               mu_run: Tensor, var_run: Tensor) -> Params:
    """The first batch sets the running statistics outright."""
    first = ~state["initialized"]
    return {"mu_run": torch.where(first, first_mu, mu_run),
            "var_run": torch.where(first, first_var, var_run),
            "initialized": torch.ones_like(state["initialized"])}


def _eval_norm(params: Params, state: Params, x: Tensor, eps: float
               ) -> Tensor:
    y = (x.float() - state["mu_run"]) * torch.rsqrt(state["var_run"] + eps)
    return (y * params["gamma"].float() + params["beta"].float()).to(x.dtype)


def gbn_apply(params: Params, state: Params, x: Tensor, *,
              ghost_batch_size: int, eps: float = 1e-5,
              momentum: float = 0.1, training: bool = True,
              use_kernels: bool = False) -> Tuple[Tensor, Params]:
    """Apply GBN over x: (B, ..., C). Returns (y, new_state).

    G = B // ghost_batch_size ghosts (B < ghost_batch_size is one ghost:
    plain BN). Leftover rows are normalized with the last ghost's
    statistics. ``use_kernels`` routes the ghost normalization through the
    differentiable kernel pair (:func:`repro_torch.kernels.ops.gbn_forward`).
    """
    if not training:
        return _eval_norm(params, state, x, eps), state
    orig_shape = x.shape
    Bsz, C = x.shape[0], x.shape[-1]
    gamma = params["gamma"].float()
    beta = params["beta"].float()

    gbs = min(ghost_batch_size, Bsz)
    G = Bsz // gbs
    rows = G * gbs
    xg = x[:rows].float().reshape(G, -1, C)

    if use_kernels:
        from repro_torch.kernels import ops as kops
        y, mu, var = kops.gbn_forward(xg.contiguous(), gamma, beta, eps=eps)
    else:
        mu, var = _ghost_stats(xg)
        y = (xg - mu[:, None, :]) * torch.rsqrt(var[:, None, :] + eps)
        y = y * gamma + beta

    y = y.reshape((rows,) + tuple(orig_shape[1:]))
    if rows < Bsz:
        tail = (x[rows:].float() - mu[-1]) * torch.rsqrt(var[-1] + eps) \
            * gamma + beta
        y = torch.cat([y, tail], dim=0)

    n = xg.shape[1]
    with torch.no_grad():
        vu = var * (n / max(n - 1, 1))         # unbiased, for the EMA
        new_state = _new_state(
            state, mu.mean(0), vu.mean(0),
            _cascaded_ema(state["mu_run"], mu, momentum),
            _cascaded_ema(state["var_run"], vu, momentum))
    return y.to(x.dtype), new_state


def equal_weight_bn_apply(params: Params, state: Params, x: Tensor, *,
                          eps: float = 1e-5, momentum: float = 0.1,
                          training: bool = True) -> Tuple[Tensor, Params]:
    """Conventional BatchNorm over the full batch with the equal-weight
    running update: the baseline GBN is compared against."""
    if not training:
        return _eval_norm(params, state, x, eps), state
    C = x.shape[-1]
    xf = x.float().reshape(-1, C)
    mu = xf.mean(0)
    var = (xf - mu).square().mean(0)
    y = (x.float() - mu) * torch.rsqrt(var + eps) * params["gamma"].float() \
        + params["beta"].float()
    n = xf.shape[0]
    with torch.no_grad():
        vu = var * (n / max(n - 1, 1))
        new_state = _new_state(
            state, mu, vu,
            (1 - momentum) * state["mu_run"] + momentum * mu,
            (1 - momentum) * state["var_run"] + momentum * vu)
    return y.to(x.dtype), new_state
