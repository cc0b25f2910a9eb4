#!/usr/bin/env python3
"""Time the Mamba chunk-scan kernel pair (B10 ``mamba_chunk``, B11
``mamba_chunk_backward``) on one NVIDIA GPU.

    python3 scripts/mamba_times.py              # from the repo root
    python3 scripts/mamba_times.py --sweep      # the kernels' constants

At the path shape of every B10/B11 call of a falcon-mamba-7b ``generate``
and train step, (B, c, di, ds) = (8, 256, 8192, 16) in f32
(``chip_smoke.mamba_full_shape``), and at a solo row (1, 256, 8192, 16), it
prints one JSON line a wrapper with

- ``plan``: the launch the built kernels pick (``mamba_scan.plan``);
- ``events_ms``: CUDA events around 20 calls issued back to back
  (``chip_smoke.time_ms``);
- ``device_ms``: the device time a call of everything the wrapper launches,
  from one ``torch.profiler`` window of 10 calls
  (``chip_smoke.profile_device_ms``);
- ``kernels``: the device kernels of the window, by name, with their ms and
  launches a call (a kernel whose events the window lost shows fewer);

then the card's name and power limit. ``chip_smoke.py`` phase 15 runs it in
a process of its own and gates the kernels a call.

``--sweep`` builds copies of ``csrc/mamba_scan.cu`` with other values of
its constants (states a forward and a backward thread ``kQFwd``,
``kQBwd``, steps a backward segment ``kSeg``, steps a forward tile
``kTile``, depth of the copy ring ``kStages``, threads a block
``kFwdThreads``, ``kBwdThreads``, the blocks an SM holds ``kFwdBlocks``,
``kBwdBlocks``) and, where a variant ends in ``:ex2``, with ``decay()``
taking ``ex2.approx.ftz`` of dt * (A log2 e) in place of ``expf``; each in
a temporary directory, one nvcc a variant, all started together. For each
variant it prints ptxas's registers and spills, how far each output strays
from the plain version at two small shapes (the largest |kernel - plain| /
(tol + tol |plain|), tol = 1e-4: above 1 fails the card tests' check) and
dA's error against float64 autograd at (2, 256, 1024, 16); then it times
each variant at both shapes, in turn for ``--rounds`` rounds (each time the
median of its rounds' profiler device ms a call). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOLO = 1                     # rows of the solo-prefill shape
SOURCE = "mamba_scan.cu"
# a variant is QFWD:QBWD:SEG:TILE:STAGES:FWDTHREADS:BWDTHREADS:FWDBLOCKS:
# BWDBLOCKS, the values of these lines, and an optional ":ex2"
CONSTANTS = ("constexpr int kQFwd = {};", "constexpr int kQBwd = {};",
             "constexpr int kSeg = {};", "constexpr int kTile = {};",
             "constexpr int kStages = {};", "constexpr int kFwdThreads = {};",
             "constexpr int kBwdThreads = {};",
             "constexpr int kFwdBlocks = {};",
             "constexpr int kBwdBlocks = {};")
EXPF = "  return expf(dt * a);\n"
EX2 = ("  float r;\n"
       "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(r)\n"
       "      : \"f\"(dt * (a * 1.44269504088896341f)));\n"
       "  return r;\n")
VARIANTS = ("4:4:16:16:2:256:256:6:1,4:4:16:16:3:256:256:6:1,"
            "4:4:16:16:4:256:256:6:1,4:4:16:16:3:128:256:8:1,"
            "4:4:16:16:3:128:256:12:1,4:4:16:16:3:64:256:16:1,"
            "4:4:16:32:3:128:256:8:1")
CHECK_SHAPES = ((2, 40, 320, 16), (3, 300, 200, 5))
F64_SHAPE = (2, 256, 1024, 16)


def shapes():
    import chip_smoke as CS
    full = CS.mamba_full_shape()
    return [full, (SOLO,) + tuple(full[1:])]


def inputs(shape, seed=0):
    import torch
    import chip_smoke as CS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ins, dy, dhl = CS.mamba_inputs(gen, *shape, torch.float32)
    return ins, dy, dhl


def calls(ins, dy, dhl):
    """(wrapper, call, backward) of both wrappers on these inputs."""
    from repro_torch.kernels import mamba_scan as MS
    return (("mamba_chunk", lambda: MS.mamba_chunk(*ins), False),
            ("mamba_chunk_backward",
             lambda: MS.mamba_chunk_backward(*ins, dy, dhl), True))


def wrappers(shape):
    """One JSON row a wrapper at ``shape``."""
    import chip_smoke as CS
    from repro_torch.kernels import mamba_scan as MS
    ins, dy, dhl = inputs(shape)
    rows = []
    for name, fn, backward in calls(ins, dy, dhl):
        events = CS.time_ms(fn)
        device, kernels = CS.profile_device_ms(fn, reps=10)
        rows.append({
            "shape": shape, "wrapper": name,
            "plan": dataclasses.asdict(MS.plan(*shape, backward=backward)),
            "events_ms": events, "device_ms": device,
            "kernels_a_call": sum(n for _, n, _ in kernels),
            "kernels": [{"name": k[:80], "ms": ms, "n": n}
                        for ms, n, k in sorted(kernels, reverse=True)]})
    return rows


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def parse(v: str):
    """(the constants' values, ex2) of variant ``v``."""
    parts = v.split(":")
    ex2 = parts[-1] == "ex2"
    if ex2:
        parts = parts[:-1]
    if len(parts) != len(CONSTANTS):
        raise ValueError(f"variant {v!r}: give {len(CONSTANTS)} values and "
                         f"an optional ':ex2'")
    return [int(x) for x in parts], ex2


def build_all(variants, root: Path):
    """One library a variant in ``root``: {variant: path}; prints ptxas's
    registers and spills of each."""
    import chip_smoke as CS
    from repro_torch.kernels import build
    nvcc = build.find_nvcc()
    procs, libs = [], {}
    for n, v in enumerate(variants):
        values, ex2 = parse(v)
        tmp = root / str(n)
        shutil.copytree(build.CSRC, tmp)
        body = (tmp / SOURCE).read_text()
        for line, value in zip(CONSTANTS, values):
            pattern = re.escape(line.format("@")).replace("@", r"\w+")
            body, hits = re.subn(pattern, line.format(value), body)
            if hits != 1:
                raise RuntimeError(f"{SOURCE} has no {line!r}")
        if ex2:
            if body.count(EXPF) != 1:
                raise RuntimeError(f"{SOURCE} has no {EXPF!r}")
            body = body.replace(EXPF, EX2)
        (tmp / SOURCE).write_text(body)
        out = tmp / "mamba_scan.so"
        libs[v] = out
        procs.append((v, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(out), str(tmp / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for v, p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{v}: nvcc exited {p.returncode}\n{out}{err}")
        entry = "?"
        for line in (out + err).splitlines():
            if "Compiling entry function" in line:
                entry = CS.kernel_label(line)
            elif "registers" in line or "spill" in line:
                print(f"ptxas {v} {entry}: {line.strip()}")
    return libs


def use(libs, v: str) -> None:
    """Points the wrappers at variant ``v``'s library."""
    from repro_torch.kernels import build
    from repro_torch.kernels import launch as L
    build._loaded[SOURCE] = ctypes.CDLL(str(libs[v]))
    L._bound.pop(SOURCE, None)


def strays(got, want, tol=1e-4):
    """The largest |got - want| / (tol + tol |want|): above 1 fails an
    allclose(rtol=atol=tol)."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (tol + tol * w.abs())).max())


def check(v):
    """One JSON line a check shape of the loaded variant ``v``, and dA
    against float64 autograd."""
    import torch
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import ref
    for shape in CHECK_SHAPES:
        ins, dy, dhl = inputs(shape, seed=1)
        out = dict(zip(("y", "h_last"), (
            strays(g, w) for g, w in zip(MS.mamba_chunk(*ins),
                                         ref.mamba_chunk_ref(*ins)))))
        out.update(zip(("dxc", "ddt", "dB", "dC", "dA", "dh0"), (
            strays(g, w) for g, w in zip(
                MS.mamba_chunk_backward(*ins, dy, dhl),
                ref.mamba_chunk_backward_ref(*ins, dy, dhl)))))
        print(json.dumps({"variant": v, "shape": shape,
                          "ckpt": MS.plan(*shape, backward=True).ckpt,
                          "strays": out}), flush=True)
    ins, dy, dhl = inputs(F64_SHAPE, seed=2)
    got = MS.mamba_chunk_backward(*ins, dy, dhl)[4]
    want = ref.mamba_chunk_backward_ref(*ins, dy, dhl)[4]
    x, dt, Bm, Cm, A, h = (t.double() for t in ins)
    A = A.requires_grad_(True)
    loss = 0.0
    with torch.enable_grad():
        for t in range(x.shape[1]):
            h = torch.exp(dt[:, t, :, None] * A) * h \
                + (dt[:, t] * x[:, t])[:, :, None] * Bm[:, t, None, :]
            loss = loss + (torch.einsum("bds,bs->bd", h, Cm[:, t])
                           * dy[:, t].double()).sum()
        loss = loss + (h * dhl.double()).sum()
        da, = torch.autograd.grad(loss, A)
    print(json.dumps({
        "variant": v, "shape": F64_SHAPE,
        "dA_vs_f64": float((got.double() - da).abs().max()),
        "plain_dA_vs_f64": float((want.double() - da).abs().max()),
        "largest_dA": float(da.abs().max())}), flush=True)


def sweep(variants, libs, rounds):
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import mamba_scan as MS
    for v in variants:
        use(libs, v)
        print(json.dumps({"variant": v, "built": MS.built_constants()}))
        check(v)
    times = {}
    for shape in shapes():
        ins, dy, dhl = inputs(shape)
        for _ in range(rounds):
            for v in variants:
                use(libs, v)
                for name, fn, _ in calls(ins, dy, dhl):
                    ms, _ = CS.profile_device_ms(fn, reps=10)
                    times.setdefault((shape, v, name), []).append(ms)
        del ins, dy, dhl
        torch.cuda.empty_cache()
    for (shape, v, name), ts in times.items():
        use(libs, v)
        p = MS.plan(*shape, backward=name != "mamba_chunk")
        print(json.dumps({
            "shape": shape, "variant": v, "wrapper": name,
            "plan": dataclasses.asdict(p),
            "device_ms": None if None in ts else statistics.median(ts),
            "rounds": ts}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--variants", default=VARIANTS)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mamba_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    if args.sweep:
        variants = args.variants.split(",")
        for v in variants:
            parse(v)
        with tempfile.TemporaryDirectory() as root:
            sweep(variants, build_all(variants, Path(root)), args.rounds)
    else:
        for shape in shapes():
            for row in wrappers(shape):
                print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    print(CS.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
