#!/usr/bin/env python3
"""Time the full-width qwen3-1.7b training step of one or more trees of the
port on one NVIDIA GPU, in turn, so that two commits compare on one card in
one call.

    python3 scripts/lm_step_times.py src .archive/parent/src --rounds 2

Each argument is a directory that holds a ``repro_torch`` package. A tree
runs in a process of its own (two trees' ``repro_torch`` cannot share one):
it builds the kernels of its own ``csrc/`` (nvcc, into its own ``_build/``),
draws qwen3-1.7b in bf16 from seed 0 and takes ``chip_smoke.py`` phase 13's
step: ``make_lm_train_step(use_kernels=True)``, momentum SGD at lr 0.5 with
clip 1.0, on B=8 rows of T=512 ``token_lm`` tokens (seed 5), one warm step
and ``--steps`` timed steps on the repeated batch, each timed on the host
around a synchronised call as phase 13 does, and each also by CUDA events
around the call. The trees run in the order A B B A (``--rounds`` 2), A B
B A A B B A (4), ...; each process prints one JSON line (its tree, the
steps' host and event ms, their medians, the losses), and the last line
gives each tree's median over its rounds' medians, beside the card's name
and power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from ab_rounds import run_rounds, smi_line

B, T, LR, SEED, DATA_SEED = 8, 512, 0.5, 0, 5
ARCH = "qwen3-1.7b"


def worker(src: str, steps: int) -> dict:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core import LargeBatchConfig, Regime
    from repro_torch.data import lm_sequences, token_lm
    from repro_torch.kernels import build
    from repro_torch.models import transformer as TT
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import make_lm_train_step
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    cfg = get_config(ARCH)
    params = TT.init_params(SEED, cfg)
    rows = lm_sequences(token_lm(DATA_SEED, vocab_size=cfg.vocab_size,
                                 n_tokens=B * T), T)
    batch = {"tokens": torch.as_tensor(rows, device="cuda").long()}
    lb = LargeBatchConfig(batch_size=B, base_batch_size=B, grad_clip=1.0)
    regime = Regime(base_lr=LR, total_steps=100, drop_every=100)
    step_fn = make_lm_train_step(cfg, lb, regime, use_kernels=True)
    state = (params, sgd.init(params))
    del params
    host, events, losses = [], [], []
    for i in range(1 + steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        p2, o2, m = step_fn(*state, batch, i)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        state = (p2, o2)
    return {"src": src, "package": str(Path(repro_torch.__file__).parent),
            "build_s": round(build_s, 1), "host_ms": host,
            "event_ms": events, "median_host_ms": statistics.median(host[1:]),
            "median_event_ms": statistics.median(events[1:]),
            "losses": losses}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="+", help="directories holding repro_torch")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.srcs[0], args.steps)), flush=True)
        return 0
    runs = run_rounds(__file__, args.srcs, args.rounds,
                      ["--steps", str(args.steps)], timeout=1800)
    summary = {s: {"median_host_ms": statistics.median(
                       x["median_host_ms"] for x in rs),
                   "median_event_ms": statistics.median(
                       x["median_event_ms"] for x in rs),
                   "rounds": len(rs)} for s, rs in runs.items()}
    print(smi_line())
    print(json.dumps({"arch": ARCH, "B": B, "T": T, "steps": args.steps,
                      "trees": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
