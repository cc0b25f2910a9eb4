#!/usr/bin/env python3
"""Does a ResNet44 training run repeat bit for bit on one NVIDIA GPU?

    python3 scripts/vision_determinism.py [--steps 8]    # from the repo root

RESNET44_CIFAR10 at full width, B=4096, ghost 128, the LB+LR+GBN+RA
recipe, through the CUDA GBN pair: ``--steps`` steps of
``make_vision_train_step`` from the same parameters on the same batches,
twice with ``torch.backends.cudnn.deterministic`` False (cuDNN's default
algorithms) and twice with it True, in the order False, True, True, False.
For each setting it prints one JSON line: whether its two runs' losses,
parameters, BN state and momentum are bit-equal, the largest difference,
and each run's median host ms a warm step (a synchronized step on the host
clock, as ``chip_smoke.phase_step_time`` times it). Then the card's name
and power limit. A resumed sweep run equals an uninterrupted one only if
every step repeats bit for bit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def run(deterministic: bool, steps: int, batches):
    import torch
    from chip_smoke import BATCH, GHOST
    from repro_torch import tree
    from repro_torch.configs import RESNET44_CIFAR10 as cfg
    from repro_torch.core import Regime, presets
    from repro_torch.models.cnn import model_fns
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import make_vision_train_step
    lb = presets(BATCH, 128, GHOST)["LB+LR+GBN+RA"]
    regime = lb.build_regime(Regime(base_lr=0.1, total_steps=steps,
                                    drop_every=max(1, steps // 2)))
    init, apply = model_fns(cfg)
    params, state = init(0, cfg, "cuda")      # resolve_device sets precision
    torch.backends.cudnn.deterministic = deterministic
    opt = sgd.init(params)
    step_fn = make_vision_train_step(apply, cfg, lb, regime,
                                     use_kernels=True)
    losses, times = [], []
    for i in range(steps):
        x, y = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, opt, m = step_fn(params, state, opt, x, y, i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    warm = sorted(times[1:])
    leaves = ([torch.stack(losses)] + tree.leaves(params) + tree.leaves(state)
              + tree.leaves(opt.momentum))
    return leaves, warm[len(warm) // 2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("vision_determinism: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import BATCH, smi_line
    from repro_torch.data import teacher_classification
    data = teacher_classification(0, n_train=2 * BATCH, n_test=16,
                                  input_shape=(32, 32, 3))
    batches = [(torch.as_tensor(data.x_train[i:i + BATCH], device="cuda"),
                torch.as_tensor(data.y_train[i:i + BATCH],
                                device="cuda").long())
               for i in range(0, 2 * BATCH, BATCH)]
    runs = {False: [], True: []}
    for flag in (False, True, True, False):
        runs[flag].append(run(flag, args.steps, batches))
    for flag, ((a, ms_a), (b, ms_b)) in runs.items():
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        diff = max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))
        print(json.dumps({"cudnn_deterministic": flag, "steps": args.steps,
                          "bit_equal": equal, "max_abs_diff": diff,
                          "step_ms": [ms_a, ms_b]}), flush=True)
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
