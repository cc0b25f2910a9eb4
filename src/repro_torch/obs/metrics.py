"""Metrics: counters, gauges, streaming histograms and the registry that
holds them (copies of ``repro.obs.metrics``'s), and the per-run scalar
series store of the trainers.

- :class:`Counter` / :class:`Gauge` — monotone totals and last-value
  signals (queue depth, slot occupancy).
- :class:`Histogram` — a log-bucketed streaming histogram: p50/p95/p99
  (and any quantile) to ~``growth``-relative accuracy without storing the
  samples.
- :class:`Registry` — the name -> metric table one process shares, with
  JSONL export and an aligned plain-text summary table.
- :class:`MetricsLogger` — the (step, name, value) series store of a
  training run, optionally mirrored into a :class:`Registry`.

Naming contract: ``<subsystem>/<signal>`` with unit suffixes —
``serve/ttft_s``, ``serve/queue_depth``.
"""
from __future__ import annotations

import json
import math
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "MetricsLogger"]


class Counter:
    """Monotonically increasing total."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def summary(self) -> Dict[str, Any]:
        return {"value": self.value}


class Gauge:
    """Last-value signal."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)

    def summary(self) -> Dict[str, Any]:
        return {"value": self.value}


class Histogram:
    """Streaming histogram over geometric buckets.

    A sample ``v`` lands in bucket ``floor(log(|v|) / log(growth))`` on the
    positive or negative side (zeros get their own bucket), so any quantile
    is reproducible to a relative error of ~``sqrt(growth) - 1`` (about 1%
    at the default ``growth=1.02``) from O(#occupied buckets) state. Exact
    count/sum/min/max/last ride along for the summary.
    """

    kind = "histogram"

    def __init__(self, growth: float = 1.02) -> None:
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = growth
        self._log_g = math.log(growth)
        self._pos: Dict[int, int] = defaultdict(int)
        self._neg: Dict[int, int] = defaultdict(int)
        self._zero = 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.last = float("nan")

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.last = v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v > 0.0:
            self._pos[int(math.floor(math.log(v) / self._log_g))] += 1
        elif v < 0.0:
            self._neg[int(math.floor(math.log(-v) / self._log_g))] += 1
        else:
            self._zero += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def _items(self) -> Iterable[Tuple[float, int]]:
        """(representative value, count) in ascending value order."""
        g = self.growth
        for i in sorted(self._neg, reverse=True):       # most negative first
            yield -(g ** (i + 0.5)), self._neg[i]
        if self._zero:
            yield 0.0, self._zero
        for i in sorted(self._pos):
            yield g ** (i + 0.5), self._pos[i]

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]); NaN when empty."""
        if not self.count:
            return float("nan")
        if q <= 0.0:
            return self.vmin
        if q >= 1.0:
            return self.vmax
        target = q * self.count
        seen = 0
        for value, n in self._items():
            seen += n
            if seen >= target:
                # clamp the bucket representative into the exact range
                return min(max(value, self.vmin), self.vmax)
        return self.vmax                                  # pragma: no cover

    def summary(self) -> Dict[str, Any]:
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin if self.count else float("nan"),
                "max": self.vmax if self.count else float("nan"),
                "last": self.last,
                "p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class Registry:
    """Shared name -> metric table. A name keeps the kind it was first
    created with; asking for the same name as a different kind raises
    (silent kind-mixing is how two loggers drift apart — the exact disease
    this layer removes)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(**kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not "
                            f"{cls.__name__.lower()}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, growth: float = 1.02) -> Histogram:
        return self._get(name, Histogram, growth=growth)

    # shorthands for hot call sites
    def inc(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def clear(self) -> None:
        self._metrics = {}

    def to_records(self, ts: Optional[float] = None) -> List[Dict[str, Any]]:
        """One JSON-ready record per metric: {ts, name, kind, **summary}."""
        ts = time.time() if ts is None else ts
        return [{"ts": ts, "name": name, "kind": m.kind, **m.summary()}
                for name, m in sorted(self._metrics.items())]

    def write_jsonl(self, path: str, append: bool = True) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a" if append else "w") as f:
            for rec in self.to_records():
                f.write(json.dumps(rec, sort_keys=True) + "\n")

    def summary_table(self) -> str:
        """Aligned plain-text table: one row per metric."""
        lines = [f"{'metric':<32s} {'kind':>9s} {'count':>8s} {'value/mean':>12s} "
                 f"{'p50':>10s} {'p95':>10s} {'p99':>10s} {'max':>10s}"]
        for name, m in sorted(self._metrics.items()):
            s = m.summary()
            if m.kind == "histogram":
                lines.append(
                    f"{name:<32s} {m.kind:>9s} {s['count']:8d} "
                    f"{s['mean']:12.4g} {s['p50']:10.4g} {s['p95']:10.4g} "
                    f"{s['p99']:10.4g} {s['max']:10.4g}")
            else:
                lines.append(f"{name:<32s} {m.kind:>9s} {'':>8s} "
                             f"{s['value']:12.4g}")
        return "\n".join(lines)


class MetricsLogger:
    """Append-only (step, name, value) scalar series for one run.

    ``attach_registry`` mirrors every subsequently logged scalar into the
    same-named (optionally prefixed) metric of the registry, so a run's
    series feed the shared observability sink without the trainers growing
    a second logging call: a :class:`Gauge` already there takes the value
    (the trainers' ``train/lr``, which the logged ``lr`` series repeats),
    else a :class:`Histogram` observes it. The JAX package's logger always
    observes, which raises TypeError on the gauge ``train/lr`` when a run
    with ``obs`` evaluates.
    """

    def __init__(self) -> None:
        self._steps: Dict[str, List[int]] = defaultdict(list)
        self._values: Dict[str, List[float]] = defaultdict(list)
        self._registry: Optional[Registry] = None
        self._prefix = ""

    def attach_registry(self, registry: Registry, prefix: str = "") -> None:
        self._registry = registry
        self._prefix = prefix

    def log(self, step: int, **scalars: float) -> None:
        for name, value in scalars.items():
            self._steps[name].append(int(step))
            self._values[name].append(float(value))
            if self._registry is not None:
                self._mirror(self._prefix + name, value)

    def _mirror(self, name: str, value: float) -> None:
        metric = self._registry.get(name)
        if isinstance(metric, Gauge):
            metric.set(value)
        else:
            self._registry.observe(name, value)

    def set_series(self, name: str, steps: Sequence[int],
                   values: Sequence[float]) -> None:
        """Replace one series wholesale (used for device-batched series like
        the diffusion distances, which are synced once at the end rather
        than logged float-by-float)."""
        self._steps[name] = [int(s) for s in steps]
        self._values[name] = [float(v) for v in values]
        if self._registry is not None:
            h = self._registry.histogram(self._prefix + name)
            for v in values:
                h.observe(v)

    def names(self) -> List[str]:
        return sorted(name for name in self._steps if self._steps[name])

    def series(self, name: str) -> Tuple[List[int], List[float]]:
        # .get, not [..]: reading a missing series must not create a
        # phantom empty one that would leak into to_json()/records
        return (list(self._steps.get(name, ())),
                list(self._values.get(name, ())))

    def last(self, name: str, default: float = float("nan")) -> float:
        vals = self._values.get(name)
        return vals[-1] if vals else default

    def max(self, name: str, default: float = 0.0) -> float:
        vals = self._values.get(name)
        return max(vals) if vals else default

    def to_json(self) -> Dict[str, Any]:
        return {name: [self._steps[name], self._values[name]]
                for name in self._steps if self._steps[name]}

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "MetricsLogger":
        lg = cls()
        for name, (steps, values) in obj.items():
            lg._steps[name] = [int(s) for s in steps]
            lg._values[name] = [float(v) for v in values]
        return lg

    def to_history(self) -> Dict[str, List[float]]:
        """The legacy ``train_vision`` history-dict view."""
        val_steps, val_acc = self.series("val_acc")
        _, train_loss = self.series("train_loss")
        dist_steps, distance = self.series("distance")
        return {"steps": val_steps, "val_acc": val_acc,
                "train_loss": train_loss,
                "dist_steps": dist_steps, "distance": distance}
