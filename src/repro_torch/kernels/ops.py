"""Differentiable GBN: the kernel pair of :mod:`repro_torch.kernels.gbn`
behind a ``torch.autograd.Function`` (the port of
``repro.kernels.ops.gbn_forward``'s ``jax.custom_vjp``).

A CUDA tensor goes to the CUDA kernels, forward and backward, or the call
raises; a CPU tensor goes to their plain versions. The saved residuals are
the input and the reduced (G, C) statistics: nothing activation-sized
besides x.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import gbn as K

Tensor = torch.Tensor


class _GBN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xg: Tensor, gamma: Tensor, beta: Tensor, eps: float):
        y, mu, var = K.gbn_forward(xg, gamma, beta, eps=eps)
        ctx.save_for_backward(xg, gamma, mu, var)
        ctx.eps = eps
        ctx.beta_dtype = beta.dtype
        return y, mu, var

    @staticmethod
    def backward(ctx, dy: Tensor, dmu: Tensor, dvar: Tensor):
        xg, gamma, mu, var = ctx.saved_tensors
        dx, dgamma, dbeta = K.gbn_backward(
            xg, gamma, mu, var, dy.contiguous(), dmu.contiguous(),
            dvar.contiguous(), eps=ctx.eps)
        return dx, dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype), None


def gbn_forward(xg: Tensor, gamma: Tensor, beta: Tensor, *,
                eps: float = 1e-5) -> Tuple[Tensor, Tensor, Tensor]:
    """xg: (G, R, C) f32 -> (y, mu (G, C), var (G, C)); differentiable
    w.r.t. xg, gamma and beta through all three outputs."""
    return _GBN.apply(xg, gamma, beta, eps)
