"""Multiplicative gradient noise (paper §4): g_hat = g * z, z ~ N(1, sigma^2),
the alternative to LR scaling that matches the first and second moments of
the small-batch weight increments.

- ``multiplicative_noise_grads``: one z per element of each parameter
  tensor (the whole-batch limit, when only the mean gradient exists).
- ``ghost_noise_grads``: per-ghost-section gradients each scaled by an
  independent z_g ~ N(1, G sigma^2) and averaged.

Draws come from a ``torch.Generator``: they differ from ``jax.random``'s, so
the tests hand both packages the same standard normals
(:func:`apply_multiplicative_noise`) or compare moments.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree


def apply_multiplicative_noise(grads: Any, z: Any, sigma: float) -> Any:
    """g <- g * (1 + sigma z) for standard-normal draws z (same tree)."""
    return tree.map(lambda g, n: g * (1.0 + sigma * n).to(g.dtype), grads, z)


def multiplicative_noise_grads(generator: torch.Generator, grads: Any,
                               sigma: float) -> Any:
    """g <- g * z with z ~ N(1, sigma^2), independent per element."""
    z = [torch.randn(g.shape, generator=generator, device=g.device,
                     dtype=torch.float32) for g in tree.leaves(grads)]
    return apply_multiplicative_noise(grads, tree.unflatten(grads, z), sigma)


def ghost_noise_grads(generator: torch.Generator, section_grads: Any,
                      sigma: float) -> Any:
    """Leaves carry a leading ghost-section axis G: section g is scaled by
    z_g ~ N(1, G sigma^2), then the sections are averaged."""
    def one(g):
        G = g.shape[0]
        z = 1.0 + sigma * G ** 0.5 * torch.randn(
            (G,) + (1,) * (g.dim() - 1), generator=generator,
            device=g.device, dtype=torch.float32)
        return (g * z.to(g.dtype)).mean(dim=0)

    return tree.map(one, section_grads)
