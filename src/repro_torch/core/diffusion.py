"""Ultra-slow diffusion instrumentation (paper §3, Figure 2, and the
Appendix-B probe); port of ``repro.core.diffusion``.

The paper models the initial high-LR phase as a random walk on a random
potential with ``||w_t - w_0|| ~ log t``. This module tracks the weight
distance from the initialization, fits the log-t law against a power law,
and probes the loss's spread against the distance on random rays
(:func:`random_potential_probe`).
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

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

    ``norm`` computes the norm of a tree of differences (default: the
    global norm); a run whose parameters are sharded over a mesh passes
    one that sums the slices' squares over the mesh
    (:func:`repro_torch.train.parallel.sharded_global_norm`).

    ``record`` leaves the distance on the device; the floats cross to the
    host in one transfer the first time ``distances`` is read.
    """

    def __init__(self, params0: Any,
                 norm: Optional[Callable[[Any], torch.Tensor]] = None):
        self.params0 = tree.map(lambda a: a.detach().float().clone(), params0)
        self._norm = norm or global_norm
        self.steps: List[int] = []
        self._pending: List[torch.Tensor] = []
        self._host: List[float] = []

    @torch.no_grad()
    def record(self, step: int, params: Any) -> torch.Tensor:
        d = self._norm(tree.map(lambda a, b: a.float() - b, params,
                                self.params0))
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


# ---------------------------------------------------------------------------
# Appendix-B probe: loss std vs weight distance on random rays
# ---------------------------------------------------------------------------


def random_potential_probe(loss_fn: Callable[[Any], Any], params0: Any,
                           generator: torch.Generator, *,
                           n_samples: int = 200, max_radius: float = 10.0,
                           n_bins: int = 10) -> Dict[str, np.ndarray]:
    """Paper Appendix B: sample w = w0 + z*v (v a random unit direction, z
    ~ U[0, max_radius]); estimate std(L(w) - L(w0)) per distance bin.
    Under the alpha=2 random-potential model the std grows ~ linearly with
    distance. The draws come from ``generator`` (each sample a standard
    normal direction per leaf, then z), one sample at a time:
    :func:`_probe_from_draws` turns each into its loss change and drops it
    before the next is drawn, so the probe holds one direction (one copy of
    the parameters) at a time."""
    leaves = tree.leaves(params0)

    def draws():
        for _ in range(n_samples):
            yield ([torch.randn(l.shape, generator=generator, device=l.device)
                    for l in leaves],
                   float(torch.rand((), generator=generator,
                                    device=leaves[0].device)) * max_radius)

    return _probe_from_draws(loss_fn, params0, draws(),
                             max_radius=max_radius, n_bins=n_bins)


def _probe_from_draws(loss_fn: Callable[[Any], Any], params0: Any,
                      draws: Iterable[Tuple[Sequence[Any], float]], *,
                      max_radius: float = 10.0, n_bins: int = 10
                      ) -> Dict[str, np.ndarray]:
    """The probe from given draws: pairs (direction, z), the direction one
    tensor or numpy array per leaf of ``params0`` (:func:`tree.leaves`
    order), z its distance. Each pair is taken, evaluated and dropped
    before the next is taken. Bins with at least 3 samples report the RMS
    loss change at their center."""
    leaves = [l.detach().float() for l in tree.leaves(params0)]
    l0 = float(loss_fn(params0))
    dists, dlosses = [], []
    for draw, z in draws:
        d = [x.to(l.device, torch.float32) if isinstance(x, torch.Tensor)
             else torch.tensor(np.asarray(x, np.float32), device=l.device)
             for x, l in zip(draw, leaves)]
        nrm = float(torch.stack([x.square().sum() for x in d]).sum().sqrt())
        w = tree.unflatten(params0, [l + (z / nrm) * x
                                     for l, x in zip(leaves, d)])
        dists.append(z)
        dlosses.append(float(loss_fn(w)) - l0)
        del draw, d, w
    dists_a = np.asarray(dists)
    dl = np.asarray(dlosses)
    edges = np.linspace(0.0, max_radius, n_bins + 1)
    centers, stds = [], []
    for b in range(n_bins):
        m = (dists_a >= edges[b]) & (dists_a < edges[b + 1])
        if m.sum() >= 3:
            centers.append(0.5 * (edges[b] + edges[b + 1]))
            stds.append(float(np.sqrt(np.mean(dl[m] ** 2))))
    return {"distance": np.asarray(centers), "loss_std": np.asarray(stds)}
