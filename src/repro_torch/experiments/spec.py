"""Declarative experiment specs (the port of ``repro.experiments.spec``:
the same fields, the same canonical JSON and so the same ``run_id``s).

A ``RunSpec`` is everything one training run needs — model config, data
source, the ``LargeBatchConfig`` recipe, regime construction, seed, and
runner knobs — as a frozen dataclass that serializes to canonical JSON.
Its ``run_id`` is a content hash of that JSON, so identity is stable across
processes: the resumable runner uses it to skip already-recorded runs, and
two sweeps that share a run share its ID.

A ``SweepSpec`` is a base ``RunSpec`` crossed with method columns (named
field-override sets, e.g. Table 1's SB/LB/+LR/+GBN/+RA), a value grid over
dotted field paths (``"lb.batch_size"``, ``"model.ghost_batch_size"``), and
seeds. ``expand()`` materializes the grid in a deterministic order.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.configs.paper_models import PAPER_MODELS, VisionModelConfig
from repro_torch.core.large_batch import LargeBatchConfig
from repro_torch.core.regime import BatchSchedule, Regime, constant_lr


@dataclass(frozen=True)
class DataSpec:
    """Synthetic teacher-classification data source (the stand-in for
    MNIST/CIFAR — see :mod:`repro_torch.data.synthetic`)."""

    seed: int = 7
    n_train: int = 6144
    n_test: int = 1024
    input_shape: Tuple[int, int, int] = (8, 8, 1)
    n_classes: int = 10
    label_noise: float = 0.05

    def build(self):
        from repro_torch.data.synthetic import teacher_classification
        return teacher_classification(
            self.seed, n_train=self.n_train, n_test=self.n_test,
            input_shape=tuple(self.input_shape), n_classes=self.n_classes,
            label_noise=self.label_noise)


@dataclass(frozen=True)
class RunSpec:
    """One training run, fully specified."""

    name: str                         # sweep-local label, e.g. "gen-gap"
    method: str                       # Table-1 column label, e.g. "LB+LR"
    model: VisionModelConfig
    data: DataSpec
    lb: LargeBatchConfig
    # small-batch reference regime; the per-method regime comes from
    # lb.build_regime(small_regime()) unless a batch schedule overrides it
    base_lr: float = 0.08
    total_steps: int = 2400
    drop_every: int = 800
    drop_factor: float = 0.2
    warmup_steps: int = 0
    batch_schedule: Optional[BatchSchedule] = None
    # runner knobs
    seed: int = 0
    eval_every: int = 0
    track_diffusion: bool = True
    diffusion_every: int = 0          # 0 = auto cadence
    use_kernels: bool = False
    weight_decay: float = 5e-4
    # mesh-topology selector: False/"" = single device; True or "data" =
    # the 1-D ("data",) mesh; "2d" = the ("data", "model") mesh. Part of
    # the run's identity; it fans over the torch.distributed ranks when
    # there are several (see experiments.runner._mesh_for).
    use_mesh: Any = False
    # LM workload: set to a registry arch name to drive the LM trainer
    # instead of the vision one (model/data are then ignored)
    lm_arch: str = ""
    lm_seq_len: int = 64
    lm_n_tokens: int = 65536
    lm_vocab_size: int = 256

    # -- regime construction ------------------------------------------------

    def small_regime(self) -> Regime:
        return Regime(base_lr=self.base_lr, total_steps=self.total_steps,
                      drop_every=self.drop_every,
                      drop_factor=self.drop_factor,
                      warmup_steps=self.warmup_steps)

    def regime(self) -> Regime:
        if self.batch_schedule is not None:
            # Smith et al.: the LR stays constant; growth replaces decay
            return constant_lr(self.small_regime())
        return self.lb.build_regime(self.small_regime())

    # -- identity / serialization ------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        obj = _to_jsonable(dataclasses.asdict(self))
        # canonicalize the topology selector so equivalent requests hash to
        # the same run_id: "data" == True (preserving run_ids recorded when
        # the 1-D mesh was a boolean), any falsy == False.
        um = obj.get("use_mesh")
        obj["use_mesh"] = (True if um in (True, "data")
                           else str(um) if um else False)
        return obj

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "RunSpec":
        obj = dict(obj)
        obj["model"] = VisionModelConfig(**_detuple(
            obj["model"], ("input_shape", "hidden_sizes", "channels")))
        obj["data"] = DataSpec(**_detuple(obj["data"], ("input_shape",)))
        obj["lb"] = LargeBatchConfig(**obj["lb"])
        if obj.get("batch_schedule") is not None:
            obj["batch_schedule"] = BatchSchedule(**obj["batch_schedule"])
        return cls(**obj)

    @property
    def run_id(self) -> str:
        canon = json.dumps(self.to_json(), sort_keys=True)
        return hashlib.sha256(canon.encode()).hexdigest()[:12]

    @property
    def batch_size(self) -> int:
        return (self.batch_schedule.base_batch
                if self.batch_schedule is not None else self.lb.batch_size)


@dataclass(frozen=True)
class SweepSpec:
    """A grid of runs: base spec x method columns x field grid x seeds."""

    name: str
    base: RunSpec
    # method label -> field overrides (dotted paths allowed); the Table-1
    # columns are {"SB": {"lb": <cfg>}, ...}. Empty = just the base spec.
    methods: Mapping[str, Mapping[str, Any]] = field(default_factory=dict)
    # dotted field path -> values, crossed in insertion order
    grid: Mapping[str, Sequence[Any]] = field(default_factory=dict)
    seeds: Sequence[int] = (0,)

    def expand(self) -> List[RunSpec]:
        methods = dict(self.methods) or {self.base.method: {}}
        specs: List[RunSpec] = []
        for method, overrides in methods.items():
            spec = dataclasses.replace(self.base, name=self.name,
                                       method=method)
            for path, value in overrides.items():
                spec = replace_path(spec, path, value)
            for assignment in _grid_points(self.grid):
                s = spec
                for path, value in assignment:
                    s = replace_path(s, path, value)
                for seed in self.seeds:
                    specs.append(dataclasses.replace(s, seed=int(seed)))
        return specs


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def replace_path(spec: Any, path: str, value: Any) -> Any:
    """``dataclasses.replace`` through a dotted field path, e.g.
    ``replace_path(run, "lb.batch_size", 512)``."""
    head, _, rest = path.partition(".")
    if not rest:
        return dataclasses.replace(spec, **{head: value})
    inner = replace_path(getattr(spec, head), rest, value)
    return dataclasses.replace(spec, **{head: inner})


def _grid_points(grid: Mapping[str, Sequence[Any]]
                 ) -> List[Tuple[Tuple[str, Any], ...]]:
    points: List[Tuple[Tuple[str, Any], ...]] = [()]
    for path, values in grid.items():
        points = [p + ((path, v),) for p in points for v in values]
    return points


def _to_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def _detuple(obj: Dict[str, Any], keys: Sequence[str]) -> Dict[str, Any]:
    out = dict(obj)
    for k in keys:
        if k in out and out[k] is not None:
            out[k] = tuple(out[k])
    return out


def paper_model(name: str) -> VisionModelConfig:
    return PAPER_MODELS[name]
