#!/usr/bin/env python3
"""Time the fused RMSNorm kernels (B3 forward, B4 backward) of one or more
trees of the port on one NVIDIA GPU, in turn, so that two commits (or two
team sizes) compare on one card in one call.

    python3 scripts/norm_times.py src .archive/parent/src --rounds 2
    python3 scripts/norm_times.py src src@8,2 src@4,4

Each argument is a directory that holds a ``repro_torch`` package, with an
optional ``@F,B``: the largest chunks a thread of the forward (F) and the
backward (B) may hold (``fused_norm.KMAX``; trees with a plan only). A
tree runs in a process of its own: it builds its own
``csrc/rmsnorm_residual.cu`` (nvcc, into its own ``_build/``) and times
each shape of ``SHAPES`` from inputs drawn from seed 0, each call going
round copies of its inputs past the L2 (``chip_smoke.input_copies``): CUDA
events around 50 calls queued behind a sleep kernel
(``chip_smoke.queued_ms``: ``events_ms``, a call, the device's time, not
the host's), and the device time of the kernels of 20 calls under
``torch.profiler`` (``chip_smoke.profile_device_ms``: ``device_ms``, a
call, and ``kernels``, by kernel name). The trees run in the order A B B
A (``--rounds`` 2), ... (``ab_rounds.run_rounds``); each process prints
one JSON line, and the last line gives each tree's median over its rounds,
beside the card's name and power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
from pathlib import Path

from ab_rounds import run_rounds, smi_line
from chip_smoke import input_copies, profile_device_ms, queued_ms, rotating

WIDTHS = (1024, 2048, 3840, 4096, 5120, 5376, 7168, 8192)
# (direction, N, d, dtype, residual)
SHAPES = ([(dr, 4096, d, "bf16", True) for dr in ("fwd", "bwd")
           for d in WIDTHS]
          + [(dr, 4096, 2048, "bf16", False) for dr in ("fwd", "bwd")]
          + [(dr, 8, 2048, "bf16", res) for dr in ("fwd", "bwd")
             for res in (True, False)]
          + [("fwd", 1, 128, "bf16", True), ("bwd", 4096, 8192, "f32", True),
             ("fwd", 4096, 8192, "f32", True)]
          + [(y, 4096, d, "bf16", True) for y in ("copy", "addcmul")
             for d in (2048, 4096, 8192)])
# Yardsticks of the card's rate on the kernels' bytes (not ports of
# anything): "copy" moves what B3 moves with the residual (reads 2 N d,
# writes 2 N d: an (N, 2d) clone), "addcmul" what B4 moves (reads 3 N d,
# writes N d).


def device_ms(fn) -> tuple:
    """Device ms a call of 20 calls (profiler), and the ms a call by kernel
    name without its template arguments."""
    total, kernels = profile_device_ms(fn, reps=20, host=False)
    by_name = {}
    for ms, _, name in kernels:
        name = name.replace("(anonymous namespace)::", "")
        m = re.search(r"([A-Za-z_]\w*)\s*[<(]", name)
        name = m.group(1) if m else name[:40]
        by_name[name] = by_name.get(name, 0) + ms
    return total, by_name


def worker(spec: str) -> dict:
    src, _, kmax = spec.partition("@")
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import launch as L
    build.build(["rmsnorm_residual.cu"])
    if kmax:        # before any plan is made (plans are cached)
        FN.KMAX = dict(zip((False, True), (int(v) for v in kmax.split(","))))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dr, N, d, dt, res in SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        a, b, c = (torch.randn(N, d, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        scale = torch.linspace(0.5, 1.5, d, device="cuda")
        if dr == "copy":
            fn = rotating(torch.clone,
                          input_copies(a.new_empty(N, 2 * d).normal_()))
        elif dr == "addcmul":
            fn = rotating(torch.addcmul, input_copies(a, b, c))
        elif dr == "fwd":
            fn = rotating(lambda x, r=None: FN.rmsnorm_residual(x, r, scale),
                          input_copies(*((a, b) if res else (a,))))
        else:
            fn = rotating(lambda s_, dy, ds=None: FN.rmsnorm_residual_backward(
                s_, scale, dy, ds), input_copies(*((a, b, c) if res
                                                   else (a, b))))
        dev, kernels = device_ms(fn)
        row = {"shape": [dr, N, d, dt, res], "events_ms": queued_ms(fn),
               "device_ms": dev, "kernels": kernels}
        if hasattr(FN, "plan") and dr in ("fwd", "bwd"):
            p = FN.plan(N, d, L.sm_count(0), backward=dr == "bwd",
                        itemsize=a.element_size())
            row["plan"] = [p.body, p.warps, p.per_lane, p.teams_per_block,
                           p.blocks]
        rows.append(row)
        del a, b, c
    return {"tree": spec, "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+",
                    help="directories holding repro_torch, each with an "
                         "optional @F,B")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.trees[0])), flush=True)
        return 0
    runs = run_rounds(__file__, args.trees, args.rounds)
    summary = {}
    for tree, rs in runs.items():
        summary[tree] = [
            {"shape": row["shape"], "plan": row.get("plan"),
             **{k: statistics.median(r["rows"][i][k] for r in rs)
                for k in ("events_ms", "device_ms")},
             "kernels": {n: statistics.median(r["rows"][i]["kernels"].get(n, 0)
                                              for r in rs)
                         for n in row["kernels"]}}
            for i, row in enumerate(rs[0]["rows"])]
    print(smi_line())
    print(json.dumps({"rounds": args.rounds, "trees": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
