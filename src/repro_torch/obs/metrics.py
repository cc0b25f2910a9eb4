"""Per-run scalar series (a copy of ``repro.obs.metrics.MetricsLogger``,
without the registry mirror: the port has no observability registry yet)."""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Sequence, Tuple


class MetricsLogger:
    """Append-only (step, name, value) scalar series for one run."""

    def __init__(self) -> None:
        self._steps: Dict[str, List[int]] = defaultdict(list)
        self._values: Dict[str, List[float]] = defaultdict(list)

    def log(self, step: int, **scalars: float) -> None:
        for name, value in scalars.items():
            self._steps[name].append(int(step))
            self._values[name].append(float(value))

    def set_series(self, name: str, steps: Sequence[int],
                   values: Sequence[float]) -> None:
        """Replace one series wholesale (used for device-batched series like
        the diffusion distances, which are synced once at the end rather
        than logged float-by-float)."""
        self._steps[name] = [int(s) for s in steps]
        self._values[name] = [float(v) for v in values]

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
