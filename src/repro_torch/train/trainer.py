"""Training loops (the port of ``repro.train.trainer``).

- ``make_vision_train_step`` / ``train_vision``: the paper's own
  experiments (Table 1): forward with (ghost) batch-norm state threading,
  backward, then momentum SGD with clipping, noise and the regime's LR.
- ``make_lm_train_step`` / ``make_lm_eval_step`` / ``train_lm``: next-token
  LM training of the dense decoders with the same recipe (or Adam),
  ``use_kernels=True`` through the differentiable kernels.

A step takes ``torch.autograd.grad`` over detached leaves of the parameter
tree and returns a new tree (the reference's functional update); its
metrics stay on the device until the loop fetches them in one transfer.
Gradient noise draws from an explicit ``torch.Generator``. Both loops
checkpoint and resume their run state (:mod:`repro_torch.checkpoint`) and
report into ``obs=``. With ``mesh=`` (:mod:`repro_torch.launch.mesh`, one
process a rank) both loops take each step on this rank's rows through the
sharded steps of :mod:`repro_torch.train.parallel`.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import checkpoint as ckpt
from repro_torch import tree
from repro_torch.configs.paper_models import VisionModelConfig
from repro_torch.core.diffusion import DiffusionTracker
from repro_torch.core.large_batch import LargeBatchConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core.regime import BatchSchedule, Regime
from repro_torch.data.pipeline import shard_batch
from repro_torch.device import (DeviceLike, process_index_count,
                                resolve_device)
from repro_torch.models import transformer as T
from repro_torch.obs.metrics import MetricsLogger
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.optim import adam, sgd

Params = Any


def make_vision_loss_fn(model_apply: Callable, cfg: VisionModelConfig,
                        lb: LargeBatchConfig, *,
                        use_kernels: bool = False) -> Callable:
    """(params, bn_state, x, y) -> (nll, (new_bn_state, acc))."""

    def loss_fn(p: Params, bn_state: Params, x: torch.Tensor,
                y: torch.Tensor):
        logits, new_state = model_apply(
            p, bn_state, cfg, x, training=True,
            ghost_batch_size=lb.ghost_batch_size,
            use_gbn=lb.use_gbn, use_kernels=use_kernels)
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(1, y.long()[:, None]).mean()
        acc = (logits.argmax(-1) == y).float().mean()
        return nll, (new_state, acc)

    return loss_fn


def make_vision_train_step(model_apply: Callable, cfg: VisionModelConfig,
                           lb: LargeBatchConfig, regime: Regime,
                           *, weight_decay: float = 5e-4,
                           use_kernels: bool = False) -> Callable:
    """(params, bn_state, opt_state, x, y, step, generator=None) ->
    (params, bn_state, opt_state, metrics). ``lb.use_gbn`` selects ghost
    vs full-batch statistics; ``generator`` feeds the gradient noise when
    the config has any."""
    sigma = lb.effective_noise_sigma()
    loss_fn = make_vision_loss_fn(model_apply, cfg, lb,
                                  use_kernels=use_kernels)

    def train_step(params: Params, bn_state: Params,
                   opt_state: sgd.SGDState, x: torch.Tensor,
                   y: torch.Tensor, step: int,
                   generator: Optional[torch.Generator] = None):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        loss, (new_state, acc) = loss_fn(tree.unflatten(params, leaves),
                                         bn_state, x, y)
        grads = torch.autograd.grad(loss, leaves)
        lr = regime.lr_at(step).to(x.device)
        params2, opt_state2, m = sgd.update(
            tree.unflatten(params, list(grads)), opt_state,
            tree.unflatten(params, [p.detach() for p in leaves]),
            lr=lr, momentum=lb.momentum, weight_decay=weight_decay,
            grad_clip=lb.grad_clip, noise_sigma=sigma, generator=generator)
        return params2, new_state, opt_state2, {
            "loss": loss.detach(), "acc": acc, "lr": lr, **m}

    return train_step


def make_vision_eval(model_apply: Callable, cfg: VisionModelConfig
                     ) -> Callable:
    """(params, bn_state, x, y, batch=512) -> accuracy with the running
    statistics; one host transfer at the end."""

    @torch.no_grad()
    def evaluate(params, bn_state, x: torch.Tensor, y: torch.Tensor,
                 batch: int = 512) -> float:
        correct = torch.zeros((), dtype=torch.long, device=x.device)
        for i in range(0, x.shape[0], batch):
            logits, _ = model_apply(params, bn_state, cfg, x[i:i + batch],
                                    training=False)
            correct += (logits.argmax(-1) == y[i:i + batch]).sum()
        return int(correct) / x.shape[0]

    return evaluate


def _stream_seed(seed: int, stream: int, i: int) -> int:
    """Independent seed per (run seed, stream, index): init, noise and
    shuffling never share a stream, and each step's draw is a pure function
    of its index."""
    return int(np.random.SeedSequence([seed, stream, i]).generate_state(1)[0])


_NOISE, _SHUFFLE = 1, 2


def _epoch_perm(seed: int, epoch: int, n: int, device: torch.device
                ) -> torch.Tensor:
    gen = torch.Generator().manual_seed(_stream_seed(seed, _SHUFFLE, epoch))
    return torch.randperm(n, generator=gen).to(device)


def _record_diffusion(step: int, total_steps: int, every: int) -> bool:
    if every > 0:
        return step % every == 0
    # auto cadence: dense early (the log-t regime), sparse after
    return step < 32 or step % max(1, total_steps // 64) == 0


def _host_metrics(m: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Every scalar metric of a step in one device-to-host transfer."""
    keys = list(m)
    vals: List[float] = torch.stack(
        [m[k].detach().float().reshape(()) for k in keys]).tolist()
    return dict(zip(keys, vals))


def _obs_step_metrics(reg, t0: float, mh: Dict[str, float],
                      batch_size: int) -> None:
    """Per-step training telemetry: step wall time (the caller fetched the
    step's metrics first, which waits for the step), grad norm, and the
    current schedule state (LR / batch size). ``mh`` is the step's metrics
    on the host, fetched in one transfer (:func:`_host_metrics`)."""
    reg.observe("train/step_time_s", time.perf_counter() - t0)
    reg.set("train/lr", mh["lr"])
    reg.set("train/batch_size", batch_size)
    if "grad_norm" in mh:
        reg.observe("train/grad_norm", mh["grad_norm"])
    reg.inc("train/steps")


def _save_run_state(checkpoint_dir: str, step: int, params, bn_state,
                    opt_state, *, epoch: int, cursor: int,
                    logger: MetricsLogger, tracker, layout=None) -> None:
    """``layout``: (mesh, param specs, optimizer specs) of sharded trees,
    whose slices then carry their global index in the checkpoint."""
    extra: Dict[str, Any] = {"epoch": epoch, "cursor": cursor,
                             "metrics": logger.to_json()}
    if tracker is not None:
        extra["tracker"] = {"steps": list(tracker.steps),
                            "distances": list(tracker.distances)}
    ckpt.save(checkpoint_dir, step, params, opt_state, extra=extra,
              bn_state=bn_state, sharded=process_index_count()[1] > 1,
              layout=layout)


def _restore_run_state(checkpoint_dir, params, opt_state, bn_state, tracker):
    """Shared resume path: restore trees + (step, epoch, cursor, logger)
    from the latest checkpoint, or the fresh-run defaults when none exists.
    ``bn_state=None`` (the LM loop) skips the BN-state tree."""
    if not checkpoint_dir or ckpt.latest_step(checkpoint_dir) is None:
        return params, opt_state, bn_state, 0, 0, 0, MetricsLogger()
    params, _ = ckpt.restore(checkpoint_dir, params)
    opt_state, _ = ckpt.restore(checkpoint_dir, opt_state, kind="opt")
    if bn_state is not None:
        bn_state, _ = ckpt.restore(checkpoint_dir, bn_state, kind="state")
    meta = ckpt.load_meta(checkpoint_dir)
    logger = MetricsLogger.from_json(meta["metrics"])
    if tracker is not None and "tracker" in meta:
        tracker.load(meta["tracker"]["steps"], meta["tracker"]["distances"])
    return (params, opt_state, bn_state, meta["step"], meta["epoch"],
            meta["cursor"], logger)


def train_vision(model_fns, cfg: VisionModelConfig, data,
                 lb: LargeBatchConfig, regime: Regime, *, seed: int = 0,
                 eval_every: int = 0, track_diffusion: bool = True,
                 diffusion_every: int = 0,
                 log_fn: Optional[Callable[[str], None]] = None,
                 use_kernels: bool = False,
                 weight_decay: float = 5e-4,
                 batch_schedule: Optional[BatchSchedule] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, resume: bool = True, obs=None,
                 mesh=None, device: DeviceLike = None) -> Dict[str, Any]:
    """Full training run; returns final/best accuracy + diffusion trace.

    Runs on the card unless ``device="cpu"``. The dataset moves to the
    device once and batches are gathered there. ``use_kernels=True`` trains
    through the CUDA GBN kernel pair (on the CPU: its plain version).

    Initialization, each step's gradient noise and each epoch's shuffle
    are pure functions of (seed, step) and (seed, epoch), which together
    with ``checkpoint_dir`` + ``checkpoint_every`` makes runs resumable:
    an interrupted run restarts from the last saved (params, bn_state,
    opt_state, epoch, cursor, metrics) and replays the identical batch
    sequence (``resume=False`` starts afresh).

    ``batch_schedule`` (a :class:`repro_torch.core.regime.BatchSchedule`)
    grows the batch size during training instead of decaying the LR
    (Smith et al. 2018).

    ``obs`` (a :class:`repro_torch.obs.Observability`) wraps every step in
    a ``train.step`` span and every evaluation in ``train.eval``, and emits
    ``train/step_time_s`` / ``train/grad_norm`` histograms, ``train/lr``
    and ``train/batch_size`` gauges, the ``train/steps`` counter and the
    logger's series mirrored under ``train/``. With ``obs`` the loop
    fetches each step's metrics in one transfer inside its span, which
    makes the step time real; without it nothing is added to the loop.

    ``mesh`` (a data mesh of the world's ranks, every rank calling
    ``train_vision`` alike): each step takes this rank's rows of the batch
    through the data-parallel step
    (:func:`repro_torch.train.data_parallel.make_dp_vision_train_step`);
    a batch larger than the dataset raises instead of being capped.
    """
    dev = resolve_device(device)
    init_fn, apply_fn = model_fns
    params, bn_state = init_fn(seed, cfg, dev)
    opt_state = sgd.init(params)
    tracker = DiffusionTracker(params) if track_diffusion else None
    params, opt_state, bn_state, step, epoch, cursor, logger = \
        _restore_run_state(checkpoint_dir if resume else None,
                           params, opt_state, bn_state, tracker)
    tracer = obs.tracer if obs is not None else NULL_TRACER
    reg = obs.registry if obs is not None else None
    if obs is not None:
        logger.attach_registry(obs.registry, prefix="train/")
    if mesh is not None:
        from repro_torch.train.data_parallel import make_dp_vision_train_step
        step_fn = make_dp_vision_train_step(apply_fn, cfg, lb, regime, mesh,
                                            use_kernels=use_kernels,
                                            weight_decay=weight_decay)
    else:
        step_fn = make_vision_train_step(apply_fn, cfg, lb, regime,
                                         use_kernels=use_kernels,
                                         weight_decay=weight_decay)
    evaluate = make_vision_eval(apply_fn, cfg)
    noise_gen = (torch.Generator(device=dev)
                 if lb.effective_noise_sigma() > 0 else None)

    x_tr = torch.as_tensor(data.x_train, device=dev)
    y_tr = torch.as_tensor(data.y_train, device=dev).long()
    x_te = torch.as_tensor(data.x_test, device=dev)
    y_te = torch.as_tensor(data.y_test, device=dev).long()
    n = x_tr.shape[0]
    perm = _epoch_perm(seed, epoch, n, dev)
    best = logger.max("val_acc")
    while step < regime.total_steps:
        b = (batch_schedule.batch_at(step) if batch_schedule is not None
             else lb.batch_size)
        if b > n:
            if mesh is not None:
                # capping would break the divisibility the mesh was
                # checked against at the configured batch size
                raise ValueError(f"batch {b} > dataset {n} on a mesh run")
            b = n
        if cursor + b > n:
            epoch += 1
            cursor = 0
            perm = _epoch_perm(seed, epoch, n, dev)
        idx = perm[cursor:cursor + b]
        cursor += b
        if noise_gen is not None:
            noise_gen.manual_seed(_stream_seed(seed, _NOISE, step))
        xy = {"x": x_tr[idx], "y": y_tr[idx]}
        if mesh is not None:
            xy = shard_batch(xy, mesh)
        t0, mh = time.perf_counter(), None
        with tracer.span("train.step", step=step, batch=b):
            params, bn_state, opt_state, m = step_fn(
                params, bn_state, opt_state, xy["x"], xy["y"], step,
                noise_gen)
            if reg is not None:
                mh = _host_metrics(m)
        if reg is not None:
            _obs_step_metrics(reg, t0, mh, b)
        if tracker is not None and _record_diffusion(
                step, regime.total_steps, diffusion_every):
            tracker.record(step + 1, params)
        if eval_every and step % eval_every == 0:
            with tracer.span("train.eval", step=step):
                acc = evaluate(params, bn_state, x_te, y_te)
            mh = mh or _host_metrics(m)
            logger.log(step, val_acc=acc, train_loss=mh["loss"], lr=mh["lr"])
            best = max(best, acc)
            if log_fn:
                log_fn(f"step {step:5d} loss {mh['loss']:.4f} "
                       f"val_acc {acc:.4f} lr {mh['lr']:.4f}")
        step += 1
        if (checkpoint_dir and checkpoint_every
                and step % checkpoint_every == 0
                and step < regime.total_steps):
            _save_run_state(checkpoint_dir, step, params, bn_state,
                            opt_state, epoch=epoch, cursor=cursor,
                            logger=logger, tracker=tracker)
    final = evaluate(params, bn_state, x_te, y_te)
    train_acc = evaluate(params, bn_state, x_tr[:2048], y_tr[:2048])
    if tracker is not None:
        logger.set_series("distance", tracker.steps, tracker.distances)
    out = {"final_acc": final, "best_acc": max(best, final),
           "train_acc": train_acc, "history": logger.to_history(),
           "metrics": logger, "steps": step}
    if tracker is not None:
        out["log_fit"] = tracker.log_fit(burn_in=2)
        out["power_fit"] = tracker.power_fit(burn_in=2)
    return out


# ---------------------------------------------------------------------------
# LM training (the dense decoders)
# ---------------------------------------------------------------------------


def _grads(loss: torch.Tensor, leaves: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def make_lm_train_step(cfg: ModelConfig, lb: LargeBatchConfig,
                       regime: Regime, *, weight_decay: float = 0.0,
                       use_kernels: bool = False,
                       momentum_dtype: str = "float32", remat: bool = False,
                       seq_parallel: bool = False, ce_chunk: int = 0,
                       mesh=None, params: Optional[Params] = None,
                       tp: bool = False, fsdp: bool = False,
                       optimizer: str = "sgd") -> Callable:
    """(params, opt_state, batch, step, generator=None) -> (params,
    opt_state, metrics): one step of the paper's recipe on an LM.
    ``batch`` holds ``tokens`` (B, T) and, for an encoder-decoder or
    vision-LM config, its memory's input (``frames`` or ``image_embeds``,
    which ``transformer.lm_loss`` reads).

    ``use_kernels=True`` runs the attention, norms and SwiGLU through the
    CUDA kernels and their backward kernels (autograd Functions);
    ``remat=True`` recomputes each block in the backward; ``ce_chunk``
    takes the vocab-chunked CE. ``optimizer`` is "sgd" (momentum, clipping,
    the config's gradient noise from ``generator``; momentum in
    ``momentum_dtype``, "int8" the blockwise quantized form) or "adam".

    With ``mesh`` the step runs sharded over the mesh's ranks
    (:func:`repro_torch.train.parallel.make_mesh_lm_train_step`: batch
    over the dp axes, MoE experts over "model", ``tp=True`` Megatron
    attention/MLP, ``fsdp=True`` parameters and moments over the dp axes)
    on this rank's slices; ``params`` (the whole tree the specs derive
    from) is required then. ``seq_parallel`` is the reference's layout
    hint and changes no value."""
    if mesh is not None:
        if params is None:
            raise ValueError("mesh-sharded LM step needs the params "
                             "tree to derive its specs")
        from repro_torch.train.parallel import make_mesh_lm_train_step
        return make_mesh_lm_train_step(
            cfg, lb, regime, mesh, params, weight_decay=weight_decay,
            use_kernels=use_kernels, momentum_dtype=momentum_dtype,
            remat=remat, seq_parallel=seq_parallel, ce_chunk=ce_chunk,
            tp=tp, fsdp=fsdp, optimizer=optimizer)
    if tp or fsdp:
        raise ValueError("tp/fsdp need a mesh")
    if optimizer not in ("sgd", "adam"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    sigma = lb.effective_noise_sigma()

    def train_step(params: Params, opt_state, batch: Dict[str, torch.Tensor],
                   step: int, generator: Optional[torch.Generator] = None):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        loss, metrics = T.lm_loss(tree.unflatten(params, leaves), cfg, batch,
                                  use_kernels=use_kernels, remat=remat,
                                  ce_chunk=ce_chunk)
        grads = tree.unflatten(params, _grads(loss, leaves))
        detached = tree.unflatten(params, [p.detach() for p in leaves])
        lr = regime.lr_at(step).to(loss.device)
        if optimizer == "adam":
            params2, opt_state2, m = adam.update(
                grads, opt_state, detached, lr=lr, weight_decay=weight_decay,
                grad_clip=lb.grad_clip)
        else:
            params2, opt_state2, m = sgd.update(
                grads, opt_state, detached, lr=lr, momentum=lb.momentum,
                nesterov=lb.nesterov, weight_decay=weight_decay,
                grad_clip=lb.grad_clip, noise_sigma=sigma,
                generator=generator, momentum_dtype=momentum_dtype)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params2, opt_state2, {"loss": loss.detach(), "lr": lr,
                                     **metrics, **m}

    return train_step


def make_lm_eval_step(cfg: ModelConfig, use_kernels: bool = False
                      ) -> Callable:
    """(params, batch) -> mean next-token CE (a 0-d tensor on the device)."""

    @torch.no_grad()
    def eval_step(params: Params, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
        _, metrics = T.lm_loss(params, cfg, batch, use_kernels=use_kernels)
        return metrics["ce"]

    return eval_step


def train_lm(cfg: ModelConfig, lb: LargeBatchConfig, regime: Regime,
             rows: np.ndarray, *, seed: int = 0, eval_every: int = 0,
             holdout: int = 0, use_kernels: bool = False,
             weight_decay: float = 0.0, track_diffusion: bool = False,
             diffusion_every: int = 0,
             log_fn: Optional[Callable[[str], None]] = None, mesh=None,
             checkpoint_dir: Optional[str] = None,
             checkpoint_every: int = 0, resume: bool = True, obs=None,
             params: Optional[Params] = None,
             device: DeviceLike = None) -> Dict[str, Any]:
    """LM twin of :func:`train_vision`: drives :func:`make_lm_train_step`
    (momentum SGD) over (N, seq_len) token rows with the same structured
    metrics, deterministic per-epoch shuffling, checkpoint/resume contract
    and ``obs`` telemetry.

    ``holdout`` rows from the end are held out for CE evaluation;
    ``eval_every`` logs ``train_loss``, ``eval_ce`` and ``lr`` (one host
    transfer of the step's metrics). ``params`` starts from a given tree
    (e.g. the reference's parameters carried across by
    :func:`repro_torch.convert.lm_to_torch`) instead of
    ``init_params(seed)``. Runs on the card unless ``device="cpu"``.

    ``mesh`` (every rank of the world calling ``train_lm`` alike): each
    step takes this rank's rows through the sharded step (MoE experts over
    "model", the rest replicated), evaluations run on this rank's slices
    with every holdout row, checkpoints are written a shard a rank, and
    ``out["params"]`` is this rank's slices."""
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(seed, cfg, dev)
    step_fn = make_lm_train_step(cfg, lb, regime, weight_decay=weight_decay,
                                 use_kernels=use_kernels, mesh=mesh,
                                 params=params if mesh is not None else None)
    opt_state = sgd.init(params)
    if mesh is None:
        layout = None
        eval_fn = make_lm_eval_step(cfg, use_kernels=use_kernels)
        tracker = DiffusionTracker(params) if track_diffusion else None
    else:
        from repro_torch.train import parallel as PAR
        pspecs, ospecs = step_fn.param_specs, step_fn.opt_specs
        layout = (mesh, pspecs, ospecs)
        eval_fn = PAR.make_mesh_lm_eval_step(cfg, mesh,
                                             use_kernels=use_kernels)
        tracker = (DiffusionTracker(
            PAR.shard_tree(mesh, params, pspecs),
            norm=lambda t: PAR.sharded_global_norm(t, pspecs, mesh))
            if track_diffusion else None)
    # restored whole, then sliced
    params, opt_state, _, step, epoch, cursor, logger = \
        _restore_run_state(checkpoint_dir if resume else None,
                           params, opt_state, None, tracker)
    if mesh is not None:
        params = PAR.shard_tree(mesh, params, pspecs)
        opt_state = PAR.shard_tree(mesh, opt_state, ospecs)
    tracer = obs.tracer if obs is not None else NULL_TRACER
    reg = obs.registry if obs is not None else None
    if obs is not None:
        logger.attach_registry(obs.registry, prefix="train/")
    noise_gen = (torch.Generator(device=dev)
                 if lb.effective_noise_sigma() > 0 else None)

    all_rows = torch.as_tensor(np.asarray(rows), device=dev).long()
    train_rows = all_rows[: all_rows.shape[0] - holdout] if holdout \
        else all_rows
    eval_rows = all_rows[all_rows.shape[0] - holdout:] if holdout \
        else all_rows[:0]
    n = train_rows.shape[0]
    b = lb.batch_size
    if n < b:
        raise ValueError(f"{n} rows < batch_size {b}")

    def eval_ce() -> float:
        """Row-weighted mean CE over the whole holdout, one transfer."""
        n_eval = eval_rows.shape[0]
        if n_eval == 0:
            return float("nan")
        total = torch.zeros((), device=dev)
        for i in range(0, n_eval, b):
            chunk = eval_rows[i:i + b]
            total = total + eval_fn(params, {"tokens": chunk}) * chunk.shape[0]
        return float(total) / n_eval

    perm = _epoch_perm(seed, epoch, n, dev)
    while step < regime.total_steps:
        if cursor + b > n:
            epoch += 1
            cursor = 0
            perm = _epoch_perm(seed, epoch, n, dev)
        idx = perm[cursor:cursor + b]
        cursor += b
        if noise_gen is not None:
            noise_gen.manual_seed(_stream_seed(seed, _NOISE, step))
        batch = {"tokens": train_rows[idx]}
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        t0, mh = time.perf_counter(), None
        with tracer.span("train.step", step=step, batch=b):
            params, opt_state, m = step_fn(params, opt_state, batch, step,
                                           noise_gen)
            if reg is not None:
                mh = _host_metrics(m)
        if reg is not None:
            _obs_step_metrics(reg, t0, mh, b)
        if tracker is not None and _record_diffusion(
                step, regime.total_steps, diffusion_every):
            tracker.record(step + 1, params)
        if eval_every and step % eval_every == 0:
            with tracer.span("train.eval", step=step):
                ce = eval_ce()
            mh = mh or _host_metrics(m)
            logger.log(step, eval_ce=ce, train_loss=mh["loss"], lr=mh["lr"])
            if log_fn:
                log_fn(f"step {step:5d} loss {mh['loss']:.4f} "
                       f"eval_ce {ce:.4f}")
        step += 1
        if (checkpoint_dir and checkpoint_every
                and step % checkpoint_every == 0
                and step < regime.total_steps):
            _save_run_state(checkpoint_dir, step, params, None, opt_state,
                            epoch=epoch, cursor=cursor, logger=logger,
                            tracker=tracker, layout=layout)
    final_ce = eval_ce()
    if tracker is not None:
        logger.set_series("distance", tracker.steps, tracker.distances)
    out = {"final_ce": final_ce, "metrics": logger,
           "history": logger.to_history(), "steps": step, "params": params}
    if tracker is not None:
        out["log_fit"] = tracker.log_fit(burn_in=2)
        out["power_fit"] = tracker.power_fit(burn_in=2)
    return out
