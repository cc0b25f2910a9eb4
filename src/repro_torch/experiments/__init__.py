"""Experiment subsystem (the port of ``repro.experiments``): declarative
sweeps, a resumable runner, and a structured metrics store for the paper's
Table-1 / Figure-2 studies.

- :mod:`repro_torch.experiments.spec` — ``RunSpec`` / ``SweepSpec``
  dataclasses with grid expansion and stable run IDs (equal to the JAX
  package's for the same spec).
- :mod:`repro_torch.experiments.metrics` — ``ResultsStore`` (append-only
  JSONL run records + Table-1 / diffusion aggregation) and the re-exported
  ``MetricsLogger`` (lives in :mod:`repro_torch.obs.metrics`, where the
  trainers log into it).
- :mod:`repro_torch.experiments.runner` — resumable sweep runner over
  ``train_vision`` / ``train_lm`` with :mod:`repro_torch.checkpoint` run
  state, on the card unless ``device="cpu"``.
- :mod:`repro_torch.experiments.registry` — the paper's sweeps
  (generalization-gap grid, diffusion study, batch-size-increase column,
  lm-smoke).
- :mod:`repro_torch.experiments.cli` — ``python -m
  repro_torch.experiments.cli``.
"""
from repro_torch.experiments.metrics import MetricsLogger, ResultsStore
from repro_torch.experiments.registry import SWEEPS, get_sweep
from repro_torch.experiments.runner import run_one, run_sweep
from repro_torch.experiments.spec import DataSpec, RunSpec, SweepSpec

__all__ = [
    "DataSpec", "RunSpec", "SweepSpec", "MetricsLogger", "ResultsStore",
    "run_sweep", "run_one", "get_sweep", "SWEEPS",
]
