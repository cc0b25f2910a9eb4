"""Learning-rate scaling rules for large-batch training.

The paper's rule (eq. 7): keep the update covariance
``cov(dw, dw) ~ eta^2 / M * (1/N sum g g^T)`` constant across batch size by

    eta_L = sqrt(|B_L| / |B_S|) * eta_S        (sqrt scaling)

The linear rule (Krizhevsky 2014; Goyal et al. 2017) is implemented as the
comparison baseline — the paper reports it "works less well on CIFAR10".
"""
from __future__ import annotations

import math


def scale_lr(base_lr: float, batch_size: int, base_batch_size: int,
             rule: str = "sqrt") -> float:
    """Scale ``base_lr`` (tuned for ``base_batch_size``) to ``batch_size``."""
    if batch_size <= 0 or base_batch_size <= 0:
        raise ValueError("batch sizes must be positive")
    ratio = batch_size / base_batch_size
    if rule == "sqrt":
        return base_lr * math.sqrt(ratio)
    if rule == "linear":
        return base_lr * ratio
    if rule == "none":
        return base_lr
    raise ValueError(f"unknown LR scaling rule {rule!r}")


def noise_sigma(batch_size: int, base_batch_size: int,
                base_sigma: float = 1.0) -> float:
    """Std of the multiplicative gradient noise z_n ~ N(1, sigma^2) that
    matches the small-batch increment covariance: sigma^2 ∝ M (paper §4)."""
    return base_sigma * math.sqrt(max(batch_size / base_batch_size - 1.0, 0.0))
