"""Gradient clipping (paper §4: "for the first few iterations, we had to clip
or normalize the gradients to prevent divergence")."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree


def global_norm(t: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    return torch.stack([l.float().square().sum()
                        for l in tree.leaves(t)]).sum().sqrt()


def clip_by_global_norm(grads: Any, max_norm: float, *,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Any, torch.Tensor]:
    """Returns (clipped grads, pre-clip global norm)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree.map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
