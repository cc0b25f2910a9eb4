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
of a run's identity. ``use_mesh`` is: it selects the topology a run fans
over when the ``torch.distributed`` world has more than one rank and the
run's geometry shards evenly (:func:`repro_torch.train.parallel.
mesh_compatible`): ``True``/``"data"`` for the 1-D ``("data",)`` mesh,
``"2d"`` for the ``("data", "model")`` mesh (MoE expert weights over
"model"); ``_mesh_for`` walks down the ladder to the widest compatible
mesh, or one device.

A multi-rank world runs a sweep one of two ways. Without ``use_mesh``
each rank runs its own share of the runs (``shard``). When any run asks
for a mesh, every rank runs every run (a mesh run needs all of them, and
they must create the same process groups in the same order), and only
rank 0 appends records and removes finished runs' checkpoints.
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
from repro_torch.launch import collectives
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


_MESHES: Dict[Tuple[str, str], Any] = {}


def _cached_mesh(kind: str, device: DeviceLike):
    """One mesh of each kind a process and device: a mesh's groups are
    created once, on every rank, in the order the runs first ask."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_2d_mesh, make_data_mesh
    dev = resolve_device(device)
    key = (kind, str(dev))
    if key not in _MESHES:
        _MESHES[key] = (make_2d_mesh(device=dev) if kind == "2d"
                        else make_data_mesh(device=dev))
    return _MESHES[key]


def _mesh_for(spec: RunSpec, device: DeviceLike = None):
    """The widest mesh this run's topology request and geometry allow.

    ``use_mesh`` is a topology selector: falsy -> None; True/"data" -> the
    1-D ``("data",)`` mesh over the world's ranks; "2d" -> the ``("data",
    "model")`` mesh. A "2d" request degrades to the data mesh (and then to
    None) when the geometry (batch % dp size, experts % model size, see
    :func:`repro_torch.train.parallel.mesh_compatible`) doesn't fit, or
    when the run has nothing to shard over the model axis (vision or
    dense-LM runs). A world of one rank gives None. Degrading emits a
    one-time RuntimeWarning naming the requested and actual topology. An
    unknown topology raises ValueError.
    """
    if not spec.use_mesh:
        return None
    topo = "data" if spec.use_mesh is True else str(spec.use_mesh)
    if topo not in ("data", "2d"):
        raise ValueError(f"unknown mesh topology {spec.use_mesh!r}; "
                         "expected False, True, 'data', or '2d'")
    from repro_torch.launch.mesh import MODEL_AXIS
    from repro_torch.train.parallel import mesh_compatible
    if process_index_count()[1] < 2:
        _warn_degraded(topo, "single-device")
        return None
    cfg = _lm_config(spec) if spec.lm_arch else None
    sizes = (spec.batch_schedule.phases(spec.regime().total_steps)
             if spec.batch_schedule is not None else [spec.lb.batch_size])
    ladder = [("data", lambda: _cached_mesh("data", device))]
    if topo == "2d" and cfg is not None and cfg.moe is not None:
        mesh2d = _cached_mesh("2d", device)
        if mesh2d.shape[MODEL_AXIS] > 1:
            ladder.insert(0, ("2d", lambda: mesh2d))
    for name, make in ladder:
        mesh = make()
        if all(mesh_compatible(spec.lb, mesh, batch_size=b, cfg=cfg)
               for b in sizes):
            if name != topo:
                _warn_degraded(topo, name)
            return mesh
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
    mesh = _mesh_for(spec, device)
    data = spec.data.build()
    return train_vision(
        model_fns(spec.model), spec.model, data, spec.lb, regime,
        seed=spec.seed, eval_every=spec.eval_every,
        track_diffusion=spec.track_diffusion,
        diffusion_every=spec.diffusion_every, log_fn=log_fn,
        use_kernels=spec.use_kernels, weight_decay=spec.weight_decay,
        batch_schedule=spec.batch_schedule,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        obs=obs, mesh=mesh, device=device)


def _run_lm(spec: RunSpec, regime, *, checkpoint_dir, checkpoint_every,
            log_fn, obs=None, device: DeviceLike = None):
    from repro_torch.data.synthetic import lm_sequences, token_lm
    from repro_torch.train.trainer import train_lm
    mesh = _mesh_for(spec, device)
    stream = token_lm(spec.data.seed, vocab_size=spec.lm_vocab_size,
                      n_tokens=spec.lm_n_tokens)
    rows = lm_sequences(stream, spec.lm_seq_len)
    holdout = max(spec.lb.batch_size, rows.shape[0] // 10)
    return train_lm(
        _lm_config(spec), spec.lb, regime, rows, seed=spec.seed,
        eval_every=spec.eval_every, holdout=holdout,
        use_kernels=spec.use_kernels, weight_decay=spec.weight_decay,
        track_diffusion=spec.track_diffusion,
        diffusion_every=spec.diffusion_every, log_fn=log_fn, mesh=mesh,
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

    When any run asks for a mesh (``use_mesh``) in a world of more than
    one rank, every rank runs every run and only rank 0 writes the store
    and removes checkpoints (see the module docstring); all ranks return
    the same records.
    """
    specs = sweep.expand()
    rank, world = process_index_count()
    lockstep = world > 1 and any(s.use_mesh for s in specs)
    if shard is None and world > 1 and not lockstep:
        shard = (rank, world)
    writer = rank == 0 or not lockstep
    root = os.path.join(out_dir, sweep.name)
    store = ResultsStore(root)
    if not resume and os.path.exists(root) and writer:
        shutil.rmtree(root)
    if lockstep:
        collectives.barrier()             # the store is cleared ...
    done = store.completed_run_ids() if resume else set()
    if lockstep:
        collectives.barrier()             # ... and read by every rank
    if shard is not None:
        index, count = shard
        if not (0 <= index < count):
            raise ValueError(f"bad sweep shard {shard}")
        specs = [s for s in specs if _shard_owns(s.run_id, index, count)]
        if log_fn:
            log_fn(f"sweep shard {index}/{count}: {len(specs)} run(s)")
    for i, spec in enumerate(specs):
        tag = f"[{i + 1}/{len(specs)}] {spec.method} b={spec.batch_size} " \
              f"seed={spec.seed}"
        ckpt_dir = os.path.join(root, "ckpt", spec.run_id)
        if spec.run_id in done:
            if writer and not keep_checkpoints and os.path.exists(ckpt_dir):
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
        if lockstep:
            collectives.barrier()
        if writer:
            store.append(record)
            if not keep_checkpoints and os.path.exists(ckpt_dir):
                shutil.rmtree(ckpt_dir)
    if lockstep:
        collectives.barrier()
    wanted = {s.run_id for s in specs}
    return [r for r in store.records() if r["run_id"] in wanted]
