"""Training regimes and Regime Adaptation (paper §5); port of
``repro.core.regime``.

A regime is a piecewise-constant learning-rate schedule: an initial
high-learning-rate phase followed by exponential decreases every
``drop_every`` steps (the He et al. 2016 style regime the paper uses).

**Regime Adaptation (RA)** stretches the time-frame of the schedule by
``|B_L| / |B_S|`` so the *number of weight updates* matches the small-batch
run — the paper's key intervention: "the generalization gap stems from the
relatively small number of updates rather than the batch size".
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.core.lr_scaling import scale_lr


@dataclass(frozen=True)
class Regime:
    """Piecewise exponential-decay LR regime, in units of optimizer steps."""

    base_lr: float
    total_steps: int
    drop_every: int                  # steps between LR drops
    drop_factor: float = 0.2         # gamma: lr *= gamma at each drop
    warmup_steps: int = 0            # optional linear warmup
    min_lr: float = 0.0

    def lr_at(self, step) -> torch.Tensor:
        """LR at integer step, as a 0-d float32 tensor (computed in float32,
        as the reference does)."""
        step = torch.as_tensor(step, dtype=torch.float32)
        n_drops = torch.floor(step / self.drop_every)
        lr = self.base_lr * torch.tensor(self.drop_factor) ** n_drops
        if self.warmup_steps > 0:
            warm = (step + 1.0) / self.warmup_steps
            lr = torch.where(step < self.warmup_steps, self.base_lr * warm, lr)
        return torch.clamp(lr, min=self.min_lr)

    def stretch(self, factor: float) -> "Regime":
        """Regime Adaptation: every phase of e steps becomes factor*e steps."""
        return dataclasses.replace(
            self,
            total_steps=int(round(self.total_steps * factor)),
            drop_every=max(1, int(round(self.drop_every * factor))),
            warmup_steps=int(round(self.warmup_steps * factor)),
        )


@dataclass(frozen=True)
class BatchSchedule:
    """"Don't decay the learning rate, increase the batch size" (Smith et
    al. 2018) — the comparison column from related work: keep the LR
    constant and grow the batch by ``1/drop_factor`` wherever the reference
    regime would have dropped the LR, so the gradient-noise scale follows
    the same trajectory.

    ``batch_at`` is host-side (plain int).
    """

    base_batch: int
    max_batch: int
    grow_every: int                  # steps between growths (= drop_every)
    grow_factor: float = 5.0         # = 1 / drop_factor of the LR regime
    round_to: int = 1                # keep ghost-batch divisibility

    def __post_init__(self):
        if self.round_to < 1:
            raise ValueError(f"round_to must be >= 1, got {self.round_to}")
        if self.max_batch < self.round_to:
            raise ValueError(
                f"max_batch={self.max_batch} < round_to={self.round_to}: "
                f"no batch size can satisfy both the cap and ghost-batch "
                f"divisibility")

    def batch_at(self, step: int) -> int:
        n = int(step) // self.grow_every
        b = self.base_batch * self.grow_factor ** n
        # the cap is rounded DOWN to round_to first, so the batch at the cap
        # stays a multiple of round_to
        cap = (self.max_batch // self.round_to) * self.round_to
        b = int(min(b, cap))
        return max(self.round_to, (b // self.round_to) * self.round_to)

    def phases(self, total_steps: int) -> Sequence[int]:
        """Distinct batch sizes reached within ``total_steps``."""
        seen, out = set(), []
        for s in range(0, total_steps, self.grow_every):
            b = self.batch_at(s)
            if b not in seen:
                seen.add(b)
                out.append(b)
        return out


def constant_lr(regime: Regime) -> Regime:
    """The regime with its LR decay removed (warmup kept) — the schedule a
    batch-growth run trains under. Both :func:`batch_size_increase` and
    ``RunSpec.regime()`` build it here so the mapping cannot drift."""
    return dataclasses.replace(regime, drop_factor=1.0)


def batch_size_increase(small_batch_regime: Regime, *, base_batch: int,
                        max_batch: int, round_to: int = 1
                        ) -> tuple[Regime, BatchSchedule]:
    """Map an LR-decay regime onto its Smith-et-al. equivalent: a constant-LR
    regime paired with a batch-growth schedule (grow where the LR dropped).
    """
    const = constant_lr(small_batch_regime)
    sched = BatchSchedule(
        base_batch=base_batch, max_batch=max_batch,
        grow_every=small_batch_regime.drop_every,
        grow_factor=1.0 / small_batch_regime.drop_factor,
        round_to=round_to)
    return const, sched


def adapt_regime(small_batch_regime: Regime, *, batch_size: int,
                 base_batch_size: int, lr_rule: str = "sqrt",
                 regime_adaptation: bool = True) -> Regime:
    """Build the large-batch regime from the small-batch reference.

    - ``lr_rule``: "sqrt" (paper), "linear" (Goyal baseline), or "none".
    - ``regime_adaptation=False`` keeps the *epoch budget* constant, meaning
      the large batch takes |B_S|/|B_L| as many steps (the conventional,
      gap-exhibiting setup). ``True`` keeps the *step budget* constant
      (paper's RA: epochs multiplied by |B_L|/|B_S|).
    """
    ratio = batch_size / base_batch_size
    lr = scale_lr(small_batch_regime.base_lr, batch_size, base_batch_size,
                  lr_rule)
    r = dataclasses.replace(small_batch_regime, base_lr=lr)
    if regime_adaptation:
        # same number of optimizer steps as the small-batch regime
        return r
    # same number of epochs: steps shrink by the batch ratio
    return r.stretch(1.0 / ratio)


def epochs_to_steps(n_epochs: int, dataset_size: int, batch_size: int) -> int:
    return max(1, (dataset_size // batch_size) * n_epochs)
