"""Plain PyTorch versions of the GBN kernels: the CPU path of the wrappers in
:mod:`repro_torch.kernels.gbn`, and what ``chip_smoke.py`` holds the CUDA
kernels to on the card. Mirrors ``repro.kernels.ref.gbn_ref`` /
``gbn_vjp_ref`` (two-pass, biased variance)."""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def gbn_ref(xg: Tensor, gamma: Tensor, beta: Tensor, *, eps: float = 1e-5
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """xg: (G, R, C) -> (y (G,R,C), mu (G,C), var (G,C)); biased variance."""
    xf = xg.float()
    mu = xf.mean(dim=1)
    var = (xf - mu[:, None, :]).square().mean(dim=1)
    y = (xf - mu[:, None, :]) * torch.rsqrt(var[:, None, :] + eps)
    y = y * gamma.float() + beta.float()
    return y.to(xg.dtype), mu, var


def gbn_backward_ref(xg: Tensor, gamma: Tensor, mu: Tensor, var: Tensor,
                     dy: Tensor, dmu: Tensor, dvar: Tensor, *,
                     eps: float = 1e-5) -> Tuple[Tensor, Tensor, Tensor]:
    """VJP of :func:`gbn_ref` from the saved (mu, var), with the cotangents
    of all three outputs. Returns (dx in xg.dtype, dgamma f32, dbeta f32).

        gvar = dvar - 1/2 gamma rstd^2 sum_r dy xhat
        gmu  = dmu  - gamma rstd sum_r dy
        dx_r = gamma rstd dy_r + 2 gvar (x_r - mu)/R + gmu/R
    """
    xf = xg.float()
    dyf = dy.float()
    g = gamma.float()
    R = xg.shape[1]
    rstd = torch.rsqrt(var.float() + eps)
    xc = xf - mu.float()[:, None, :]
    sdy = dyf.sum(dim=1)                                       # (G, C)
    sdyxh = (dyf * (xc * rstd[:, None, :])).sum(dim=1)
    gvar = dvar.float() - 0.5 * g * rstd * rstd * sdyxh
    gmu = dmu.float() - g * rstd * sdy
    dx = dyf * (g * rstd)[:, None, :] + xc * (2.0 * gvar / R)[:, None, :] \
        + (gmu / R)[:, None, :]
    return dx.to(xg.dtype), sdyxh.sum(dim=0), sdy.sum(dim=0)


def gbn_vjp_ref(xg: Tensor, gamma: Tensor, beta: Tensor,
                cts: Tuple[Tensor, Tensor, Tensor], *, eps: float = 1e-5
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """VJP of :func:`gbn_ref` w.r.t. (xg, gamma, beta), statistics
    recomputed from ``xg``; ``cts = (dy, dmu, dvar)``."""
    _, mu, var = gbn_ref(xg, gamma, beta, eps=eps)
    dx, dgamma, dbeta = gbn_backward_ref(xg, gamma, mu, var, *cts, eps=eps)
    return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype)
