"""Adam, the adaptive baseline the paper contrasts with (the port of
``repro.optim.adam``): global-norm clipping, then L2 weight decay folded
into the gradient, then the bias-corrected moments, all in float32.

Functional like the reference: ``update`` returns new tensors and leaves
its arguments as they were.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree
from repro_torch.core.clipping import clip_by_global_norm

Params = Any


class AdamState(NamedTuple):
    mu: Params
    nu: Params
    step: torch.Tensor


def init(params: Params) -> AdamState:
    first = tree.leaves(params)[0]

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return AdamState(mu=tree.map(zeros, params), nu=tree.map(zeros, params),
                     step=torch.zeros((), dtype=torch.int32,
                                      device=first.device))


@torch.no_grad()
def update(grads: Params, state: AdamState, params: Params, *,
           lr: torch.Tensor, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8, weight_decay: float = 0.0,
           grad_clip: float = 0.0,
           ) -> Tuple[Params, AdamState, Dict[str, torch.Tensor]]:
    """One optimizer step. Returns (new_params, new_state, metrics)."""
    metrics: Dict[str, torch.Tensor] = {}
    if grad_clip and grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        metrics["grad_norm"] = gnorm
    t = state.step + 1
    tf = t.to(torch.float32)
    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu in zip(tree.leaves(params), tree.leaves(grads),
                            tree.leaves(state.mu), tree.leaves(state.nu)):
        gf = g.float()
        if weight_decay:
            gf = gf + weight_decay * p.float()
        mu2 = b1 * mu + (1 - b1) * gf
        nu2 = b2 * nu + (1 - b2) * gf.square()
        mu_hat = mu2 / (1 - b1 ** tf)
        nu_hat = nu2 / (1 - b2 ** tf)
        new_p.append((p.float() - lr * mu_hat / (torch.sqrt(nu_hat) + eps))
                     .to(p.dtype))
        new_mu.append(mu2)
        new_nu.append(nu2)
    return (tree.unflatten(params, new_p),
            AdamState(tree.unflatten(params, new_mu),
                      tree.unflatten(params, new_nu), t), metrics)
