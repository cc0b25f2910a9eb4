"""Training launcher (the port of ``repro.launch.train``'s host mode): a
real LM training loop on this process's device, the end-to-end entry point.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-1.7b-reduced --steps 200 --batch 64 --seq-len 128 \
        --lr-rule sqrt --ra [--device cpu]

Each step draws ``--batch`` rows of the synthetic token stream
(:func:`build_batches`, numpy ``RandomState(1)`` indices, as the
reference), adds an encoder-decoder or vision config's memory inputs
(:func:`extra_inputs`), and runs :func:`repro_torch.train.trainer.
make_lm_train_step` (momentum SGD with the paper's recipe). Every
``--log-every`` steps it records ``|w - w0|`` (``DiffusionTracker``) and
prints the step's loss; at the end, the log-diffusion fit, and with
``--ckpt`` a checkpoint (``repro_torch.checkpoint.save``, the reference's
npz layout). ``--trace`` / ``--metrics-out`` write the obs sinks
(``train.step`` spans, ``train/*`` metrics).

``--parallel single`` (the default) is the single-device step, which is
what the reference's host mode computes on one device; ``--parallel
shard_map`` runs the port's mesh step (:mod:`repro_torch.train.parallel`)
on ``make_host_mesh()``. ``--parallel pjit`` (GSPMD auto-sharding) and
``--mesh single|multi`` (the reference's TPU pod meshes) have no
counterpart here and exit with a message that says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save as ckpt_save
from repro_torch.configs.registry import get_config
from repro_torch.core import LargeBatchConfig, Regime
from repro_torch.core.diffusion import DiffusionTracker
from repro_torch.data.synthetic import lm_sequences, token_lm
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.obs import NULL_TRACER, Observability
from repro_torch.optim import sgd
from repro_torch.train.trainer import make_lm_train_step

EXTRA_SEED = 10_000        # + step: the memory inputs' draws of a step

UNSUPPORTED = {
    "mesh": "--mesh single|multi builds the reference's TPU pod meshes "
            "(16x16 and 2x16x16 chips, repro.launch.mesh."
            "make_production_mesh); the port's meshes are processes over "
            "torch.distributed: run ranks with torchrun and the experiments "
            "runner, or use --parallel shard_map on this process",
    "pjit": "--parallel pjit places parameters by GSPMD auto-sharding, "
            "which has no PyTorch counterpart; use --parallel single (the "
            "same step on one device) or --parallel shard_map (the port's "
            "mesh step)",
}


def build_batches(cfg, *, batch: int, seq_len: int, n_tokens: int,
                  seed: int = 0) -> np.ndarray:
    """(N, seq_len) int rows of the synthetic Markov token stream, as the
    reference's ``build_batches`` (``batch`` is unused there too)."""
    stream = token_lm(seed, vocab_size=cfg.vocab_size, n_tokens=n_tokens)
    return lm_sequences(stream, seq_len)


def extra_inputs(cfg, batch: int, seq_len: int,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A step's memory inputs, 0.1 x normal draws from ``generator`` in
    the config's dtype: ``frames`` (batch, seq_len // frame_ratio,
    encoder d_model) for an encoder-decoder config, ``image_embeds``
    (batch, n_image_tokens, d_model) for a vision one; nothing else."""
    out = {}
    dev, dt = generator.device, T.compute_dtype(cfg)
    if cfg.encoder is not None:
        F = max(1, seq_len // cfg.encoder.frame_ratio)
        out["frames"] = (0.1 * torch.randn(
            (batch, F, cfg.encoder.d_model), generator=generator,
            device=dev)).to(dt)
    if cfg.vision is not None:
        out["image_embeds"] = (0.1 * torch.randn(
            (batch, cfg.vision.n_image_tokens, cfg.d_model),
            generator=generator, device=dev)).to(dt)
    return out


def train(args, params: Optional[Any] = None) -> Dict[str, Any]:
    """The loop of :func:`main` on parsed ``args``. ``params`` starts it
    from a given tree (on ``args.device``) instead of ``init_params(0)``.
    Returns {"losses": every step's loss, "steps"/"distances": the
    tracker's (step, |w - w0|) records}."""
    dev = resolve_device(args.device)
    obs = (Observability() if (args.trace or args.metrics_out) else None)
    tracer = obs.tracer if obs is not None else NULL_TRACER
    reg = obs.registry if obs is not None else None

    cfg = dataclasses.replace(get_config(args.arch), dtype=args.dtype)
    lb = LargeBatchConfig(
        batch_size=args.batch, base_batch_size=args.base_batch,
        lr_rule=args.lr_rule, regime_adaptation=args.ra,
        grad_clip=args.grad_clip, ghost_noise=args.ghost_noise)
    small = Regime(base_lr=args.base_lr, total_steps=args.steps,
                   drop_every=max(1, args.steps // 3))
    regime = lb.build_regime(small)

    if params is None:
        params = T.init_params(0, cfg, dev)
    opt_state = sgd.init(params)
    if args.parallel == "shard_map":
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.train import parallel as PAR
        mesh = make_host_mesh(dev)
        step_fn = make_lm_train_step(cfg, lb, regime, mesh=mesh,
                                     params=params)
        params = PAR.shard_tree(mesh, params, step_fn.param_specs)
        opt_state = PAR.shard_tree(mesh, opt_state, step_fn.opt_specs)
    else:
        step_fn = make_lm_train_step(cfg, lb, regime)

    seqs = build_batches(cfg, batch=args.batch, seq_len=args.seq_len,
                         n_tokens=args.batch * args.seq_len * 64)
    rows = torch.as_tensor(seqs, device=dev).long()
    nprng = np.random.RandomState(1)
    tracker = DiffusionTracker(params)
    noise_gen = torch.Generator(device=dev)
    extra_gen = torch.Generator(device=dev)
    losses = []
    t0 = time.time()
    for step in range(regime.total_steps):
        idx = nprng.randint(0, seqs.shape[0], size=args.batch)
        batch = {"tokens": rows[torch.as_tensor(idx, device=dev)]}
        extra_gen.manual_seed(EXTRA_SEED + step)
        batch.update(extra_inputs(cfg, args.batch, args.seq_len, extra_gen))
        noise_gen.manual_seed(step)
        ts = time.perf_counter()
        with tracer.span("train.step", step=step, batch=args.batch):
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step, noise_gen)
            if reg is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        losses.append(metrics["loss"])
        if reg is not None:
            reg.observe("train/step_time_s", time.perf_counter() - ts)
            reg.observe("train/loss", float(metrics["loss"]))
            reg.set("train/lr", float(metrics["lr"]))
            reg.set("train/batch_size", args.batch)
            if "grad_norm" in metrics:
                reg.observe("train/grad_norm", float(metrics["grad_norm"]))
            reg.inc("train/steps")
        if step % args.log_every == 0 or step == regime.total_steps - 1:
            d = float(tracker.record(step + 1, params))
            if reg is not None:
                reg.observe("train/weight_dist", d)
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"lr {float(metrics['lr']):.4f} |w-w0| {d:.3f}",
                  flush=True)
    dt = time.time() - t0
    fit = tracker.log_fit(burn_in=2)
    print(f"done in {dt:.1f}s; log-diffusion fit slope="
          f"{fit['slope']:.3f} r2={fit['r2']:.3f}")
    if args.ckpt:
        ckpt_save(args.ckpt, regime.total_steps, params, opt_state,
                  extra={"arch": args.arch})
        print(f"checkpoint written to {args.ckpt}")
    if obs is not None:
        obs.write(args.trace, args.metrics_out)
        table = obs.summary()
        if table:
            print(table)
    return {"losses": torch.stack(losses).cpu().tolist(),
            "steps": list(tracker.steps), "distances": tracker.distances}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b-reduced")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--base-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--base-lr", type=float, default=0.05)
    ap.add_argument("--lr-rule", default="sqrt",
                    choices=["sqrt", "linear", "none"])
    ap.add_argument("--ra", action="store_true", help="regime adaptation")
    ap.add_argument("--ghost-noise", type=float, default=0.0)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--parallel", default="single",
                    choices=["single", "pjit", "shard_map"],
                    help="single: the single-device step; shard_map: the "
                         "port's mesh step (train/parallel.py) on the host "
                         "mesh; pjit (GSPMD) has no counterpart and exits")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto span trace JSON here")
    ap.add_argument("--metrics-out", default="",
                    help="append the metrics registry as JSONL here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.mesh != "host":
        print(f"repro_torch.launch.train: {UNSUPPORTED['mesh']}",
              file=sys.stderr)
        return 2
    if args.parallel == "pjit":
        print(f"repro_torch.launch.train: {UNSUPPORTED['pjit']}",
              file=sys.stderr)
        return 2
    train(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
