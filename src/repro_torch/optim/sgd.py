"""Momentum SGD, the paper's optimizer, with the large-batch toolkit inside
``update``: global-norm clipping, then multiplicative gradient noise, then
weight decay on every leaf (gamma, beta and biases included), as
``repro.optim.sgd.update`` does. Momentum is kept in float32 (the int8
blockwise momentum of the reference is not ported yet).

Functional like the reference: ``update`` returns new tensors and leaves
its arguments as they were.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.core.clipping import clip_by_global_norm
from repro_torch.core.noise import multiplicative_noise_grads

Params = Any


class SGDState(NamedTuple):
    momentum: Params
    step: torch.Tensor


def init(params: Params) -> SGDState:
    first = tree.leaves(params)[0]
    return SGDState(
        momentum=tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params),
        step=torch.zeros((), dtype=torch.int32, device=first.device))


@torch.no_grad()
def update(grads: Params, state: SGDState, params: Params, *,
           lr: torch.Tensor, momentum: float = 0.9, nesterov: bool = False,
           weight_decay: float = 0.0, grad_clip: float = 0.0,
           noise_sigma: float = 0.0,
           generator: Optional[torch.Generator] = None,
           ) -> Tuple[Params, SGDState, Dict[str, torch.Tensor]]:
    """One optimizer step. Returns (new_params, new_state, metrics)."""
    metrics: Dict[str, torch.Tensor] = {}
    if grad_clip and grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        metrics["grad_norm"] = gnorm
    if noise_sigma and noise_sigma > 0:
        if generator is None:
            raise ValueError("gradient noise needs a generator")
        grads = multiplicative_noise_grads(generator, grads, noise_sigma)

    new_p, new_m = [], []
    for p, g, m in zip(tree.leaves(params), tree.leaves(grads),
                       tree.leaves(state.momentum)):
        gf = g.float()
        if weight_decay:
            gf = gf + weight_decay * p.float()
        mf = momentum * m.float() + gf
        step_dir = (gf + momentum * mf) if nesterov else mf
        new_p.append((p.float() - lr * step_dir).to(p.dtype))
        new_m.append(mf.to(m.dtype))
    return (tree.unflatten(params, new_p),
            SGDState(tree.unflatten(params, new_m), state.step + 1), metrics)
