#!/usr/bin/env python3
"""Time the Ghost-BatchNorm kernel pair per shape on one NVIDIA GPU.

    python3 scripts/gbn_times.py                 # from the repo root
    python3 scripts/gbn_times.py --sweep         # the persistent body's constants

At each (G, R, C) of the ResNet44/F1 path (B=4096, ghost 128:
``chip_smoke.RESNET_SHAPES`` and ``chip_smoke.F1_SHAPE``) it prints, for
the forward and the backward, one JSON line a body (the plan's, and the
two-pass body at the same shape) with

- ``events_ms``: CUDA events around 20 calls issued back to back
  (``chip_smoke.time_ms``, as phase 3 times the kernels);
- ``device_ms``: the device time a call of everything the wrapper launches,
  from ``torch.profiler`` (``chip_smoke.profile_device_ms``, 10 calls);
- ``kernels``: the device kernels (and memsets) one call launches, by name.

``--sweep`` times the persistent body under other constants of
``kernels/gbn.py:plan`` (blocks an SM, the depth a block's ring aims at,
the bytes of a sub-chunk), each a plan of its own at the same shape: the
variants in turn for ``--rounds`` rounds, each time the median of its
rounds' profiler device ms a call. Then the card's name and power limit.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SWEEP = {"blocks_per_sm": (1, 2), "depth": (1, 3),
         "sub_bytes": (16384, 32768, 65536)}


def per_call(fn):
    """(events ms, profiler device ms, [(ms, launches, name)]) of a call."""
    import chip_smoke as CS
    events = CS.time_ms(fn)
    device, kernels = CS.profile_device_ms(fn, reps=10)
    return events, device, kernels


def path_shapes():
    import chip_smoke as CS
    return [s for s, _ in CS.RESNET_SHAPES] + [CS.F1_SHAPE]


def calls(plan_f, plan_b, ins):
    """The forward and backward calls through the given plans."""
    from repro_torch.kernels import gbn as K
    x, gamma, beta, mu, var, dy, dmu, dvar = ins
    return {"forward": lambda: K.forward_with(plan_f, x, gamma, beta),
            "backward": lambda: K.backward_with(plan_b, x, gamma, mu, var,
                                                dy, dmu, dvar)}


def inputs(shape, seed=0):
    import chip_smoke as CS
    from repro_torch.kernels import ref
    x, gamma, beta, (dy, dmu, dvar) = CS.gbn_inputs(shape, seed)
    _, mu, var = ref.gbn_ref(x, gamma, beta)
    return x, gamma, beta, mu, var, dy, dmu, dvar


def bodies(shape):
    """One JSON row a (direction, body) at ``shape``."""
    import torch
    from repro_torch.kernels import gbn as K
    G, R, C = shape
    sms = K.sm_count(torch.cuda.current_device())
    ins = inputs(shape)
    rows = []
    for body, pf, pb in (
            ("plan", K.plan(G, R, C, sms, backward=False),
             K.plan(G, R, C, sms, backward=True)),
            ("two_pass", K.two_pass(G, R, C), K.two_pass(G, R, C))):
        for name, fn in calls(pf, pb, ins).items():
            p = pf if name == "forward" else pb
            events, device, kernels = per_call(fn)
            rows.append({
                "shape": shape, "wrapper": name, "body": p.body,
                "plan": plan_fields(p), "events_ms": events,
                "device_ms": device,
                "kernels_a_call": sum(n for _, n, _ in kernels),
                "kernels": [{"name": k[:80], "ms": ms, "n": n}
                            for ms, n, k in sorted(kernels, reverse=True)]})
    return rows


def plan_fields(p):
    return {k: getattr(p, k) for k in ("body", "blocks_per_sm", "P",
                                       "ngroups", "slice_rows", "sub_rows",
                                       "nsub", "nslot", "smem_bytes")}


def sweep(shape, rounds):
    """Profiler device ms a call of each variant of the persistent body."""
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import gbn as K
    G, R, C = shape
    sms = K.sm_count(torch.cuda.current_device())
    ins = inputs(shape)
    variants = [dict(zip(SWEEP, v)) for v in itertools.product(*SWEEP.values())]
    times = {}
    for _ in range(rounds):
        for i, v in enumerate(variants):
            pf = K.plan(G, R, C, sms, backward=False, **v)
            pb = K.plan(G, R, C, sms, backward=True, **v)
            for name, fn in calls(pf, pb, ins).items():
                key = (i, name)
                try:
                    ms, _ = CS.profile_device_ms(fn, reps=10)
                except RuntimeError as e:       # the grid does not fit
                    ms = None
                    times.setdefault(("error", key), str(e)[:120])
                times.setdefault(key, []).append(ms)
    out = []
    for i, v in enumerate(variants):
        for name in ("forward", "backward"):
            ts = times[(i, name)]
            p = K.plan(G, R, C, sms, backward=name == "backward", **v)
            out.append({"shape": shape, "wrapper": name, **v,
                        "plan": plan_fields(p),
                        "device_ms": (None if None in ts
                                      else statistics.median(ts)),
                        "rounds": ts,
                        "error": times.get(("error", (i, name)))})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gbn_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    for shape in path_shapes():
        rows = sweep(shape, args.rounds) if args.sweep else bodies(shape)
        for row in rows:
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(CS.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
