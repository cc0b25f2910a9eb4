#!/usr/bin/env python3
"""Time the flash decode kernels built with other chunk, cluster, stage and
scale-copy constants against the package's defaults, on one NVIDIA GPU.

    python3 scripts/decode_chunk_sweep.py            # from the repo root
    python3 scripts/decode_chunk_sweep.py --variants 8192:8:2:16,8192:8:2:4

A variant is CHUNK_BYTES:CLUSTER:STAGES:SCALE_COPY, the constants
``kChunkBytes``, ``CL``, ``STAGES`` and ``kScaleCopy`` of
``src/repro_torch/kernels/csrc/flash_decode.cuh`` (the package builds
8192:8:2:16; SCALE_COPY 4 copies an int8 pool's scales a slot at a time,
16 four slots a copy). Each variant's copy of the sources (those lines
rewritten, in a temporary directory) is compiled at once with the others
(one nvcc a source) and checked against the plain versions, then timed
(device time from the profiler, ``chip_smoke.kernel_ms``):

- ``flash_decode`` at the shapes of a qwen3-1.7b ``generate`` decode step
  (B=8, H=16, KV=8, hd 128, S=544, bf16, the ragged offsets of
  ``chip_smoke.PROMPT_LENS``, RoPE) at positions 512 and 542, each call on
  the next of ``chip_smoke.DECODE_CACHES`` caches (16 x 17.8 MB, several
  times the 50 MB L2), and on one cache over and over (L2-warm);
- ``flash_decode_paged`` at the engine's shapes (16 rows, pools of 1,025
  pages of 16, bf16 and int8) at rows of depths 128, 184, ..., 968, each
  call on the next of ``POOLS`` pools.

The variants are timed in turn for ``ROUNDS`` rounds and a time is the
median of its rounds. Prints one JSON line a variant, then the card's name
and power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
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

POOLS, ROUNDS = 4, 3
SOURCES = ("flash_decode.cu", "flash_decode_paged.cu")
CONSTANTS = ("constexpr int kChunkBytes = {};", "constexpr int CL = {};",
             "constexpr int STAGES = {};", "constexpr int kScaleCopy = {};")


def build_all(variants, root: Path):
    """One library a (variant, source) in ``root``: {(v, source): path}."""
    from repro_torch.kernels import build
    nvcc = build.find_nvcc()
    procs, libs = [], {}
    for n, v in enumerate(variants):
        tmp = root / str(n)
        shutil.copytree(build.CSRC, tmp)
        body = (tmp / "flash_decode.cuh").read_text()
        if len(v.split(":")) != len(CONSTANTS):
            raise ValueError(f"variant {v!r}: give {len(CONSTANTS)} values")
        for line, value in zip(CONSTANTS, v.split(":")):
            pattern = re.escape(line.format("@")).replace("@", r"\d+")
            body, hits = re.subn(pattern, line.format(int(value)), body)
            if hits != 1:
                raise RuntimeError(f"flash_decode.cuh has no {line!r}")
        (tmp / "flash_decode.cuh").write_text(body)
        for s in SOURCES:
            out = tmp / f"{Path(s).stem}.so"
            libs[(v, s)] = out
            procs.append((v, s, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-o", str(out), str(tmp / s)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for v, s, p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{v} {s}: nvcc exited {p.returncode}\n{out}"
                               f"{err}")
        for line in (out + err).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {v} {s}: {line.strip()}")
    return libs


def use(libs, v: str) -> None:
    """Points the wrappers at variant ``v``'s libraries."""
    from repro_torch.kernels import build
    from repro_torch.kernels import launch as L
    for s in SOURCES:
        build._loaded[s] = ctypes.CDLL(str(libs[(v, s)]))
        L._bound.pop(s, None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants",
                    default="8192:8:2:16,8192:8:2:4,16384:8:2:16,"
                            "4096:8:4:16,8192:4:2:16")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_chunk_sweep: no CUDA device", file=sys.stderr)
        return 2
    variants = args.variants.split(",")
    with tempfile.TemporaryDirectory() as root:
        return sweep(variants, build_all(variants, Path(root)))


def sweep(variants, libs) -> int:
    import torch
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ref

    cfg = get_config(CS.SERVE_ARCH)
    H, KV, hd, theta = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.rope_theta)
    gen = torch.Generator(device="cuda").manual_seed(23)
    randn = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                   device="cuda").bfloat16()
    # generate shapes: B=8 rows of width 512 + 32 new tokens
    B, S = CS.SERVE_B, CS.SERVE_P + CS.SERVE_NEW
    q = randn(B, H, hd)
    caches = [(randn(B, KV, S, hd), randn(B, KV, S, hd))
              for _ in range(CS.DECODE_CACHES)]
    off = CS.serve_offsets(CS.PROMPT_LENS, CS.SERVE_P)
    # engine shapes
    Be, Se, ps = CS.ENGINE_SLOTS, CS.ENGINE_MAX_LEN, CS.ENGINE_PAGE
    qe = randn(Be, H, hd)
    epos = torch.arange(Be, device="cuda", dtype=torch.int32) * 56 + 128
    pools = []
    for i in range(POOLS):
        k, v = randn(Be, KV, Se, hd), randn(Be, KV, Se, hd)
        kp, vp, pt = CS.paged_from_contiguous(k, v, ps, seed=5 + i)
        del k, v
        (kq, ks), (vq, vs) = ref.quantize_slots(kp), ref.quantize_slots(vp)
        pools.append((kp, vp, pt, kq, ks, vq, vs))

    def rotating(items, fn):
        turn = itertools.cycle(items)
        return lambda: fn(*next(turn))

    fns = {}
    for pos in (CS.SERVE_P, S - 2):
        fns[f"b12_cold_{pos}"] = rotating(caches, lambda k, v, p=pos:
                                          FD.flash_decode(q, k, v, p,
                                                          offsets=off,
                                                          rope_theta=theta))
        k0, v0 = caches[0]
        fns[f"b12_warm_{pos}"] = (lambda p=pos: FD.flash_decode(
            q, k0, v0, p, offsets=off, rope_theta=theta))
    fns["b13_bf16"] = rotating(pools, lambda kp, vp, pt, *_:
                               FD.flash_decode_paged(qe, kp, vp, pt, epos,
                                                     rope_theta=theta))
    fns["b13_int8"] = rotating(pools, lambda kp, vp, pt, kq, ks, vq, vs:
                               FD.flash_decode_paged(qe, kq, vq, pt, epos,
                                                     k_scale=ks, v_scale=vs,
                                                     rope_theta=theta))

    errs = {}
    for v in variants:
        use(libs, v)
        k, vv = caches[0]
        kp, vp, pt, kq, ks, vq, vs = pools[0]
        e = [CS.max_err(FD.flash_decode(q, k, vv, S - 2, offsets=off,
                                        rope_theta=theta).float(),
                        ref.flash_decode_ref(q, k, vv, S - 2, offsets=off,
                                             rope_theta=theta).float()),
             CS.max_err(FD.flash_decode_paged(qe, kp, vp, pt, epos,
                                              rope_theta=theta).float(),
                        ref.flash_decode_paged_ref(qe, kp, vp, pt, epos,
                                                   rope_theta=theta).float()),
             CS.max_err(FD.flash_decode_paged(qe, kq, vq, pt, epos,
                                              k_scale=ks, v_scale=vs,
                                              rope_theta=theta).float(),
                        ref.flash_decode_paged_ref(
                            qe, kq, vq, pt, epos, k_scale=ks, v_scale=vs,
                            rope_theta=theta).float())]
        errs[v] = max(e)
        if errs[v] > CS.BF16_TOL:
            raise AssertionError(f"variant {v}: max abs err {errs[v]}")
    times = {v: {k: [] for k in fns} for v in variants}
    for _ in range(ROUNDS):
        for v in variants:
            use(libs, v)
            for key, fn in fns.items():
                times[v][key].append(CS.kernel_ms(fn, reps=20))
    for v in variants:
        row = {k: statistics.median(t) for k, t in times[v].items()}
        print(json.dumps({"variant": v, "max_abs_err": errs[v],
                          "median_ms": row,
                          "rounds": {k: [round(x, 5) for x in t]
                                     for k, t in times[v].items()}}))
    print(CS.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
