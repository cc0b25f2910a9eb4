"""The paper's sweeps, as named SweepSpec factories (the port of
``repro.experiments.registry``: the same factories, specs and ``run_id``s).

Each factory returns a reduced-scale configuration of a study from the
paper or its related work:

- ``generalization-gap`` — Table 1: the SB/LB/+LR/+GBN/+RA method columns.
- ``diffusion`` — Figure 2: constant-high-LR walks at several batch sizes,
  log-t vs power-law fits of ||w_t - w_0||.
- ``batch-size-increase`` — the Smith et al. 2018 comparison column
  ("don't decay the learning rate, increase the batch size") against SB and
  the paper's full recipe.
- ``lm-smoke`` — the recipe on a reduced assigned LM architecture (ghost
  gradient noise instead of GBN), exercising the LM runner path through the
  ``use_kernels=True`` hot path (the CUDA flash-attention / Mamba
  chunk-scan forward and backward kernels, and the norm and SwiGLU pairs).

Factories accept scale overrides so callers and tests can shrink them
(``steps=``, ``seeds=``, ...), and the vision sweeps keep
``use_kernels=False`` as registered (a caller sets it through
:func:`~repro_torch.experiments.spec.replace_path`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

from repro_torch.configs.paper_models import F1_MNIST
from repro_torch.core.large_batch import LargeBatchConfig, presets
from repro_torch.core.regime import batch_size_increase
from repro_torch.experiments.spec import DataSpec, RunSpec, SweepSpec


def _f1_reduced(hidden=(192, 192, 192), ghost=16):
    return dataclasses.replace(F1_MNIST, input_shape=(8, 8, 1),
                               hidden_sizes=tuple(hidden),
                               ghost_batch_size=ghost)


def _gap_base(steps: int, *, track_diffusion: bool = True) -> RunSpec:
    return RunSpec(
        name="generalization-gap", method="SB", model=_f1_reduced(),
        data=DataSpec(seed=7, n_train=6144, n_test=1024,
                      input_shape=(8, 8, 1), n_classes=10,
                      label_noise=0.05),
        lb=LargeBatchConfig(batch_size=32, base_batch_size=32),
        base_lr=0.08, total_steps=steps, drop_every=max(1, steps // 3),
        drop_factor=0.2, seed=5, track_diffusion=track_diffusion)


def generalization_gap(*, steps: int = 2400, large_batch: int = 1024,
                       small_batch: int = 32, ghost: int = 16,
                       seeds: Sequence[int] = (0,),
                       use_mesh=False) -> SweepSpec:
    """Table 1: the five method columns on the reduced F1 task."""
    cols = presets(large_batch, small_batch, ghost=ghost)
    base = dataclasses.replace(_gap_base(steps), use_mesh=use_mesh)
    return SweepSpec(
        name="generalization-gap", base=base,
        methods={name: {"lb": lb} for name, lb in cols.items()},
        seeds=tuple(seeds))


def diffusion(*, steps: int = 400, batches: Sequence[int] = (32, 128, 512),
              seeds: Sequence[int] = (0,), use_mesh=False
              ) -> SweepSpec:
    """Figure 2: constant high-LR random walk, one run per batch size."""
    base = RunSpec(
        name="diffusion", method="high-lr-walk",
        model=_f1_reduced(hidden=(128, 128)),
        data=DataSpec(seed=3, n_train=4096, n_test=512,
                      input_shape=(8, 8, 1), n_classes=10, label_noise=0.0),
        lb=LargeBatchConfig(batch_size=32, base_batch_size=32,
                            grad_clip=0.0),
        base_lr=0.08, total_steps=steps, drop_every=10 ** 9, seed=11,
        use_mesh=use_mesh)
    return SweepSpec(
        name="diffusion", base=base,
        grid={"lb": [LargeBatchConfig(batch_size=b, base_batch_size=b,
                                      grad_clip=0.0) for b in batches]},
        seeds=tuple(seeds))


def batch_size_increase_sweep(*, steps: int = 2400, large_batch: int = 1024,
                              small_batch: int = 32, ghost: int = 16,
                              seeds: Sequence[int] = (0,),
                              use_mesh=False) -> SweepSpec:
    """Smith et al. 2018 as a Table-1 column: constant LR with the batch
    grown where the SB regime would drop the LR, next to SB and the paper's
    full recipe."""
    base = dataclasses.replace(_gap_base(steps), use_mesh=use_mesh)
    cols = presets(large_batch, small_batch, ghost=ghost)
    _, sched = batch_size_increase(base.small_regime(),
                                   base_batch=small_batch,
                                   max_batch=large_batch, round_to=ghost)
    bs_inc_lb = LargeBatchConfig(
        batch_size=large_batch, base_batch_size=small_batch,
        lr_rule="none", use_gbn=True, regime_adaptation=False,
        ghost_batch_size=ghost, grad_clip=0.0)
    return SweepSpec(
        name="batch-size-increase", base=base,
        methods={
            "SB": {"lb": cols["SB"]},
            "LB+LR+GBN+RA": {"lb": cols["LB+LR+GBN+RA"]},
            "LB+BS-INC": {"lb": bs_inc_lb, "batch_schedule": sched},
        },
        seeds=tuple(seeds))


def lm_smoke(*, steps: int = 30, arch: str = "qwen3-1.7b",
             seeds: Sequence[int] = (0,), use_mesh=False
             ) -> SweepSpec:
    """The recipe on a reduced assigned LM arch: SB vs LB with ghost
    gradient noise (the norm-free GBN twin) — a runner smoke, not a paper
    table. Runs ``use_kernels=True``: training differentiates through the
    CUDA kernel pairs' autograd Functions. ``use_mesh`` is part of the
    run's identity: "2d" fans MoE-arch runs over the ``("data", "model")``
    mesh (expert weights over "model") when the ranks and the geometry
    allow; dense archs take the data mesh instead."""
    base = RunSpec(
        name="lm-smoke", method="SB", model=_f1_reduced(),
        data=DataSpec(seed=1), lm_arch=arch, lm_seq_len=32,
        lm_n_tokens=16384, lm_vocab_size=128,
        lb=LargeBatchConfig(batch_size=8, base_batch_size=8,
                            lr_rule="none", use_gbn=False),
        base_lr=0.02, total_steps=steps, drop_every=max(1, steps // 2),
        track_diffusion=False, weight_decay=0.0, use_kernels=True,
        eval_every=max(1, steps // 2), use_mesh=use_mesh)
    lb_large = LargeBatchConfig(batch_size=32, base_batch_size=8,
                                lr_rule="sqrt", use_gbn=False,
                                ghost_noise=1.0)
    return SweepSpec(name="lm-smoke", base=base,
                     methods={"SB": {}, "LB+LR+NOISE": {"lb": lb_large}},
                     seeds=tuple(seeds))


SWEEPS: Dict[str, Callable[..., SweepSpec]] = {
    "generalization-gap": generalization_gap,
    "diffusion": diffusion,
    "batch-size-increase": batch_size_increase_sweep,
    "lm-smoke": lm_smoke,
}


def get_sweep(name: str, **overrides) -> SweepSpec:
    """Build a registered sweep. Unknown override names raise TypeError —
    silently dropping them would let a typo'd or unsupported flag change
    what the user thinks they ran."""
    if name not in SWEEPS:
        raise KeyError(f"unknown sweep {name!r}; have {sorted(SWEEPS)}")
    return SWEEPS[name](**overrides)
