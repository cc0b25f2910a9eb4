"""Resumable sweep runner (the port of ``repro.experiments.runner``).

``run_sweep`` expands a :class:`~repro_torch.experiments.spec.SweepSpec`
into its runs (deterministic order), skips every run whose ``run_id`` is
already in the sweep's :class:`~repro_torch.experiments.metrics.ResultsStore`,
and executes the rest. Each run trains with ``checkpoint_dir`` under the
sweep directory, so a sweep killed mid-run restarts at the first unfinished
run AND that run resumes from its last checkpointed (params, bn_state,
opt_state, epoch, cursor, metrics) — the restarted sweep produces the same
JSONL records as an uninterrupted one (initialization, noise and shuffling
are pure functions of the seed, the step and the epoch).

Runs go to ``device`` (the card unless ``device="cpu"``), which is not part
of a run's identity. ``use_mesh`` is: a mesh request runs on one device
until the parallel slice, with a one-time warning (``_mesh_for``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.device import DeviceLike, process_index_count
from repro_torch.experiments.metrics import MetricsLogger, ResultsStore
from repro_torch.experiments.spec import RunSpec, SweepSpec


def _lm_config(spec: RunSpec):
    """The reduced LM ModelConfig an LM run trains."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(spec.lm_arch).reduced(),
                               dtype="float32",
                               vocab_size=spec.lm_vocab_size)


_DEGRADE_WARNED: set = set()


def _warn_degraded(requested: str, actual: str) -> None:
    """One warning per (requested, actual) pair per process, so a sweep
    that asked for a mesh and ran on one device says so once."""
    key = (requested, actual)
    if key in _DEGRADE_WARNED:
        return
    _DEGRADE_WARNED.add(key)
    warnings.warn(
        f"mesh topology {requested!r} unavailable for this run's geometry/"
        f"devices; degrading to {actual!r}", RuntimeWarning, stacklevel=3)


def _mesh_for(spec: RunSpec) -> None:
    """The mesh this run's topology request allows: none yet.

    ``use_mesh`` is a topology selector: falsy -> None; True/"data" -> the
    1-D ``("data",)`` mesh; "2d" -> the ``("data", "model")`` mesh. Until
    the parallel slice every request takes the JAX package's one-device
    outcome: a one-time RuntimeWarning naming the requested topology and
    "single-device", and the run goes on on one device. An unknown
    topology raises ValueError.
    """
    if not spec.use_mesh:
        return None
    topo = "data" if spec.use_mesh is True else str(spec.use_mesh)
    if topo not in ("data", "2d"):
        raise ValueError(f"unknown mesh topology {spec.use_mesh!r}; "
                         "expected False, True, 'data', or '2d'")
    _warn_degraded(topo, "single-device")
    return None


def run_one(spec: RunSpec, *, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 0,
            log_fn: Optional[Callable[[str], None]] = None,
            obs=None, device: DeviceLike = None) -> Dict[str, Any]:
    """Execute one run and return its JSONL record (not yet stored).

    ``obs`` (a :class:`repro_torch.obs.Observability`) threads into the
    trainer: the run's ``MetricsLogger`` series mirror into the shared
    registry under ``train/`` and each step gets a ``train.step`` span —
    one observability sink across a whole sweep.
    """
    t0 = time.time()
    regime = spec.regime()
    run = _run_lm if spec.lm_arch else _run_vision
    out = run(spec, regime, checkpoint_dir=checkpoint_dir,
              checkpoint_every=checkpoint_every, log_fn=log_fn, obs=obs,
              device=device)
    logger: MetricsLogger = out["metrics"]
    record: Dict[str, Any] = {
        "run_id": spec.run_id,
        "sweep": spec.name,
        "method": spec.method,
        "seed": spec.seed,
        "batch_size": spec.batch_size,
        "steps": out["steps"],
        "wall_s": round(time.time() - t0, 3),
        "metrics": logger.to_json(),
        "spec": spec.to_json(),
    }
    for k in ("final_acc", "best_acc", "train_acc", "final_ce"):
        if k in out:
            record[k] = float(out[k])
    for k in ("log_fit", "power_fit"):
        if k in out:
            record[k] = out[k]
    return record


def _run_vision(spec: RunSpec, regime, *, checkpoint_dir, checkpoint_every,
                log_fn, obs=None, device: DeviceLike = None):
    from repro_torch.models.cnn import model_fns
    from repro_torch.train.trainer import train_vision
    _mesh_for(spec)
    data = spec.data.build()
    return train_vision(
        model_fns(spec.model), spec.model, data, spec.lb, regime,
        seed=spec.seed, eval_every=spec.eval_every,
        track_diffusion=spec.track_diffusion,
        diffusion_every=spec.diffusion_every, log_fn=log_fn,
        use_kernels=spec.use_kernels, weight_decay=spec.weight_decay,
        batch_schedule=spec.batch_schedule,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        obs=obs, device=device)


def _run_lm(spec: RunSpec, regime, *, checkpoint_dir, checkpoint_every,
            log_fn, obs=None, device: DeviceLike = None):
    from repro_torch.data.synthetic import lm_sequences, token_lm
    from repro_torch.train.trainer import train_lm
    _mesh_for(spec)
    stream = token_lm(spec.data.seed, vocab_size=spec.lm_vocab_size,
                      n_tokens=spec.lm_n_tokens)
    rows = lm_sequences(stream, spec.lm_seq_len)
    holdout = max(spec.lb.batch_size, rows.shape[0] // 10)
    return train_lm(
        _lm_config(spec), spec.lb, regime, rows, seed=spec.seed,
        eval_every=spec.eval_every, holdout=holdout,
        use_kernels=spec.use_kernels, weight_decay=spec.weight_decay,
        track_diffusion=spec.track_diffusion,
        diffusion_every=spec.diffusion_every, log_fn=log_fn,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        obs=obs, device=device)


def _shard_owns(run_id: str, index: int, count: int) -> bool:
    """Stable run -> host assignment: hash the content-addressed run_id, not
    the expansion order, so adding/removing runs from a sweep never
    reshuffles the survivors across hosts."""
    h = int(hashlib.sha1(run_id.encode()).hexdigest()[:8], 16)
    return h % count == index


def run_sweep(sweep: SweepSpec, out_dir: str, *, resume: bool = True,
              checkpoint_every: int = 0,
              keep_checkpoints: bool = False,
              log_fn: Optional[Callable[[str], None]] = None,
              obs=None,
              shard: Optional[Tuple[int, int]] = None,
              device: DeviceLike = None) -> List[Dict[str, Any]]:
    """Run (or resume) every run of ``sweep``; returns all its records.

    ``out_dir/<sweep.name>/records.jsonl`` accumulates one record per
    finished run; ``out_dir/<sweep.name>/ckpt/<run_id>/`` holds the
    in-flight run state (deleted on run completion unless
    ``keep_checkpoints``). With ``resume=False`` the store is cleared and
    every run re-executes.

    ``shard=(index, count)`` runs only the runs whose ``run_id`` hashes to
    ``index`` — one runner per process, all appending to the same shared
    ``out_dir`` store. ``shard=None`` takes the rank and world size of an
    initialised ``torch.distributed`` group of more than one process; the
    returned records cover THIS shard only (the JSONL store accumulates
    the union).
    """
    if shard is None:
        index, count = process_index_count()
        if count > 1:
            shard = (index, count)
    root = os.path.join(out_dir, sweep.name)
    store = ResultsStore(root)
    if not resume and os.path.exists(root):
        shutil.rmtree(root)
    specs = sweep.expand()
    if shard is not None:
        index, count = shard
        if not (0 <= index < count):
            raise ValueError(f"bad sweep shard {shard}")
        specs = [s for s in specs if _shard_owns(s.run_id, index, count)]
        if log_fn:
            log_fn(f"sweep shard {index}/{count}: {len(specs)} run(s)")
    done = store.completed_run_ids() if resume else set()
    for i, spec in enumerate(specs):
        tag = f"[{i + 1}/{len(specs)}] {spec.method} b={spec.batch_size} " \
              f"seed={spec.seed}"
        ckpt_dir = os.path.join(root, "ckpt", spec.run_id)
        if spec.run_id in done:
            if not keep_checkpoints and os.path.exists(ckpt_dir):
                # a kill between store.append and cleanup orphans the
                # checkpoint; reap it once the record exists
                shutil.rmtree(ckpt_dir)
            if log_fn:
                log_fn(f"{tag}: done ({spec.run_id}), skipping")
            continue
        if log_fn:
            log_fn(f"{tag}: running ({spec.run_id})")
        record = run_one(spec, checkpoint_dir=ckpt_dir if checkpoint_every
                         else None,
                         checkpoint_every=checkpoint_every, log_fn=log_fn,
                         obs=obs, device=device)
        store.append(record)
        if not keep_checkpoints and os.path.exists(ckpt_dir):
            shutil.rmtree(ckpt_dir)
    wanted = {s.run_id for s in specs}
    return [r for r in store.records() if r["run_id"] in wanted]
