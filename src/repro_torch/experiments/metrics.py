"""Sweep-level metrics: the results store + the paper's aggregation views
(the port of ``repro.experiments.metrics``; records and views are
interchangeable with the JAX package's).

``MetricsLogger`` (one implementation, in :mod:`repro_torch.obs.metrics`,
re-exported here) is the trainers' (step, name, value) series store that
serializes to/from JSON (so a checkpointed run resumes with its
already-logged metrics intact) and can mirror into the observability
:class:`~repro_torch.obs.metrics.Registry`.

``ResultsStore`` is the sweep-level artifact: one JSONL line per finished
run (append-only — a killed sweep never corrupts earlier records), plus the
aggregations the paper reports: the Table-1 method x batch view and the
Figure-2 log/power diffusion fits (re-fit from the stored distance series
via :func:`repro_torch.core.diffusion.fit_log_diffusion` so burn-in is an analysis
choice, not a training-time one).
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.diffusion import fit_log_diffusion, fit_power_diffusion
from repro_torch.obs.metrics import MetricsLogger

__all__ = ["MetricsLogger", "ResultsStore", "table1_view", "diffusion_view",
           "format_table1", "format_diffusion"]


# ---------------------------------------------------------------------------
# results store
# ---------------------------------------------------------------------------


class ResultsStore:
    """Append-only JSONL store of run records under ``<root>/records.jsonl``.

    A record is one finished run: spec identity (run_id/method/seed/batch),
    the summary numbers, and the logged series. Appends are flushed line by
    line, so interrupting a sweep leaves every completed record readable —
    that is what makes run-granular resume safe.
    """

    def __init__(self, root: str):
        self.root = root
        self.path = os.path.join(root, "records.jsonl")

    def append(self, record: Dict[str, Any]) -> None:
        os.makedirs(self.root, exist_ok=True)
        line = json.dumps(record, sort_keys=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def records(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    def completed_run_ids(self) -> set:
        return {r["run_id"] for r in self.records() if "run_id" in r}


# ---------------------------------------------------------------------------
# aggregation: the paper's views
# ---------------------------------------------------------------------------


def table1_view(records: Iterable[Dict[str, Any]]
                ) -> List[Dict[str, Any]]:
    """Aggregate run records into Table-1 rows: one row per
    (method, batch_size, step budget), validation accuracy mean/std over
    seeds. Grouping by the step budget keeps records from different-scale
    invocations of the same sweep (e.g. a --steps 120 debug run next to
    the full one) in separate rows instead of silently averaging them."""
    groups: Dict[Tuple[str, int, int],
                 List[Dict[str, Any]]] = defaultdict(list)
    for r in records:
        groups[(r["method"], int(r["batch_size"]),
                int(r.get("steps", 0)))].append(r)
    rows = []
    for (method, batch, _), rs in sorted(groups.items(),
                                         key=lambda kv: (kv[0][1], kv[0][0],
                                                         kv[0][2])):
        accs = np.asarray([r["final_acc"] for r in rs], dtype=np.float64)
        trains = np.asarray([r.get("train_acc", float("nan")) for r in rs],
                            dtype=np.float64)
        rows.append({
            "method": method,
            "batch_size": batch,
            "n_seeds": len(rs),
            "steps": int(rs[0]["steps"]),
            "val_acc_mean": float(accs.mean()),
            "val_acc_std": float(accs.std()),
            "train_acc_mean": float(np.nanmean(trains)),
        })
    return rows


def diffusion_view(records: Iterable[Dict[str, Any]], *, burn_in: int = 2
                   ) -> List[Dict[str, Any]]:
    """Figure-2 view: re-fit the log/power diffusion laws from each record's
    stored (dist_steps, distance) series at the requested burn-in."""
    rows = []
    for r in records:
        series = r.get("metrics", {}).get("distance")
        if not series or not series[0]:
            continue
        steps, dists = series
        rows.append({
            "method": r["method"],
            "batch_size": int(r["batch_size"]),
            "seed": r.get("seed", 0),
            "log_fit": fit_log_diffusion(steps, dists, burn_in=burn_in),
            "power_fit": fit_power_diffusion(steps, dists, burn_in=burn_in),
            "final_distance": float(dists[-1]) if dists else float("nan"),
        })
    rows.sort(key=lambda r: (r["batch_size"], r["method"], r["seed"]))
    return rows


def format_table1(rows: Sequence[Dict[str, Any]],
                  baseline: Optional[str] = "SB") -> str:
    """Render Table-1 rows as the examples' aligned text table."""
    lines = [f"{'method':>14s} {'batch':>6s} {'steps':>7s} {'val_acc':>8s} "
             f"{'+/-':>6s} {'train_acc':>9s}"]
    base = next((r["val_acc_mean"] for r in rows
                 if baseline and r["method"] == baseline), None)
    for r in rows:
        delta = ("" if base is None or r["method"] == baseline
                 else f"  ({r['val_acc_mean'] - base:+.4f} vs {baseline})")
        lines.append(
            f"{r['method']:>14s} {r['batch_size']:6d} {r['steps']:7d} "
            f"{r['val_acc_mean']:8.4f} {r['val_acc_std']:6.4f} "
            f"{r['train_acc_mean']:9.4f}{delta}")
    return "\n".join(lines)


def format_diffusion(rows: Sequence[Dict[str, Any]]) -> str:
    lines = [f"{'method':>14s} {'batch':>6s} {'slope':>7s} {'log R^2':>8s} "
             f"{'pow exp':>8s} {'pow R^2':>8s}"]
    for r in rows:
        lf, pf = r["log_fit"], r["power_fit"]
        lines.append(f"{r['method']:>14s} {r['batch_size']:6d} "
                     f"{lf['slope']:7.3f} {lf['r2']:8.4f} "
                     f"{pf['power']:8.3f} {pf['r2']:8.4f}")
    return "\n".join(lines)
