"""Ultra-slow diffusion instrumentation (paper §3, Figure 2); port of
``repro.core.diffusion`` (the Appendix-B random-potential probe is not
ported yet).

The paper models the initial high-LR phase as a random walk on a random
potential with ``||w_t - w_0|| ~ log t``. This module tracks the weight
distance from the initialization and fits the log-t law against a
power law.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.clipping import global_norm


def weight_distance(params: Any, params0: Any) -> torch.Tensor:
    """Euclidean distance ||w - w0|| over the whole parameter tree."""
    return global_norm(tree.map(lambda a, b: a.float() - b.float(),
                                params, params0))


def fit_log_diffusion(steps: Sequence[int], distances: Sequence[float],
                      burn_in: int = 1) -> Dict[str, float]:
    """Fit ``d(t) = slope * log(t) + intercept``; returns slope/intercept/R^2.

    A good fit (R^2 near 1, positive slope) over the initial high-LR phase is
    the paper's Figure-2 signature of ultra-slow diffusion with alpha = 2.
    """
    t = np.asarray(steps, dtype=np.float64)
    d = np.asarray(distances, dtype=np.float64)
    keep = t >= burn_in
    t, d = t[keep], d[keep]
    if t.size < 3:
        return {"slope": float("nan"), "intercept": float("nan"),
                "r2": float("nan")}
    x = np.log(t)
    A = np.stack([x, np.ones_like(x)], axis=1)
    (slope, intercept), res, *_ = np.linalg.lstsq(A, d, rcond=None)
    pred = A @ np.array([slope, intercept])
    ss_res = float(np.sum((d - pred) ** 2))
    ss_tot = float(np.sum((d - d.mean()) ** 2)) or 1e-12
    return {"slope": float(slope), "intercept": float(intercept),
            "r2": 1.0 - ss_res / ss_tot}


def fit_power_diffusion(steps: Sequence[int], distances: Sequence[float],
                        burn_in: int = 1) -> Dict[str, float]:
    """Fit standard diffusion d(t) = c * t^p (log-log regression) for
    comparison: flat-potential diffusion predicts p = 0.5; ultra-slow
    diffusion shows p << 0.5 with a worse fit than the log law."""
    t = np.asarray(steps, dtype=np.float64)
    d = np.asarray(distances, dtype=np.float64)
    keep = (t >= burn_in) & (d > 0)
    t, d = t[keep], d[keep]
    if t.size < 3:
        return {"power": float("nan"), "r2": float("nan")}
    x, y = np.log(t), np.log(d)
    A = np.stack([x, np.ones_like(x)], axis=1)
    (p, c), *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = A @ np.array([p, c])
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2)) or 1e-12
    return {"power": float(p), "r2": 1.0 - ss_res / ss_tot}


class DiffusionTracker:
    """Accumulates (step, ||w_t - w_0||) pairs during training.

    ``record`` leaves the distance on the device; the floats cross to the
    host in one transfer the first time ``distances`` is read.
    """

    def __init__(self, params0: Any):
        self.params0 = tree.map(lambda a: a.detach().float().clone(), params0)
        self.steps: List[int] = []
        self._pending: List[torch.Tensor] = []
        self._host: List[float] = []

    @torch.no_grad()
    def record(self, step: int, params: Any) -> torch.Tensor:
        d = weight_distance(params, self.params0)
        self.steps.append(step)
        self._pending.append(d)
        return d

    @property
    def distances(self) -> List[float]:
        if self._pending:
            self._host.extend(torch.stack(self._pending).cpu().tolist())
            self._pending.clear()
        return self._host

    def load(self, steps: Sequence[int], distances: Sequence[float]) -> None:
        """Restore a previously recorded series (checkpoint resume)."""
        _ = self.distances                            # flush pending first
        self.steps = list(steps)
        self._host = [float(d) for d in distances]

    def log_fit(self, burn_in: int = 1) -> Dict[str, float]:
        return fit_log_diffusion(self.steps, self.distances, burn_in)

    def power_fit(self, burn_in: int = 1) -> Dict[str, float]:
        return fit_power_diffusion(self.steps, self.distances, burn_in)
