#!/usr/bin/env python3
"""Time the RoPE flash attention kernels (B7 forward, B8 backward) of one or
more trees of the port on one NVIDIA GPU, in turn, and compare their
outputs bit for bit, so that two commits compare on one card in one call.

    python3 scripts/attn_times.py .archive/parent/src src --rounds 2

Each argument is a directory that holds a ``repro_torch`` package. A tree
runs in a process of its own: it builds its own ``csrc/flash_attention.cu``
and ``csrc/flash_attention_bwd.cu`` (nvcc, into its own ``_build/``) and
reports what ``-Xptxas -v`` says of each kernel (registers, spill stores
and loads), then runs each shape of ``SHAPES`` on inputs drawn from seed 0:
``flash_attention_rope_fwd`` (with lse) and ``flash_attention_rope_backward``
(o and lse from the plain version in f32, so that every tree gets the same
inputs). Each call goes round copies of its inputs past the L2
(``chip_smoke.input_copies``) and is timed two ways: CUDA events around 50
calls queued behind a sleep kernel (``chip_smoke.queued_ms``:
``events_ms``) and the device time of the kernels of 20 calls under
``torch.profiler`` (``chip_smoke.profile_device_ms``: ``device_ms``, and
``kernels`` by name). Each output's sha256 is kept: the last line says for
each shape whether every tree that takes it gave the same bits. A width a
tree does not take is reported as such. The trees run in the order A B B A
(``--rounds`` 2), ... (``ab_rounds.run_rounds``); the last line gives each
tree's medians over its rounds, beside the card's name and power limit.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import sys
from pathlib import Path

from ab_rounds import run_rounds, smi_line
from chip_smoke import input_copies, profile_device_ms, queued_ms, rotating

THETA = 10000.0
# (label, B, H, KV, T, hd, window, dtype): qwen3-1.7b's and h2o-danube-3-4b's
# train-step attention (chip_smoke phases 13 and 37), then qwen3's heads at
# every width the kernels take
SHAPES = ([("qwen3-1.7b", 8, 16, 8, 512, 128, None, "bf16"),
           ("h2o-danube-3-4b", 8, 32, 8, 512, 120, 4096, "bf16")]
          + [("width", 8, 16, 8, 512, hd, None, "bf16")
             for hd in (32, 64, 112, 120)]
          + [("width f32", 2, 16, 8, 512, hd, None, "f32")
             for hd in (64, 120, 128)])


def ptxas_report(log: str) -> dict:
    """{kernel<template values>: [registers, spill store bytes, spill load
    bytes]} from nvcc's ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            k = re.search(r"(flash_\w+?_kernel)I(.*)", mangled)
            if k is None:
                name = None
                continue
            args = re.findall(r"L([ib])(\d+)E", k.group(2))
            name = f"{k.group(1)}<{','.join(v for _, v in args)}>"
            out[name] = [None, None, None]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return out


def digest(*tensors) -> str:
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def device_ms(fn) -> tuple:
    """Device ms a call of 20 calls (profiler), and ms a call by kernel
    name without its template arguments."""
    total, kernels = profile_device_ms(fn, reps=20, host=False)
    by_name = {}
    for ms, _, name in kernels:
        m = re.search(r"([A-Za-z_]\w*)\s*[<(]", name.replace(
            "(anonymous namespace)::", ""))
        key = m.group(1) if m else name[:40]
        by_name[key] = by_name.get(key, 0) + ms
    return total, by_name


def worker(src: str) -> dict:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    sources = ["flash_attention.cu", "flash_attention_bwd.cu"]
    build.build(sources)
    ptxas = {s: ptxas_report(build.build_logs.get(s, "")) for s in sources}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, B, H, KV, T, hd, window, dt in SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v, do = (torch.randn(B, h, T, hd, generator=gen,
                                   device="cuda").to(dtype)
                       for h in (H, KV, KV, H))
        pos = torch.arange(T, device="cuda", dtype=torch.float32)[None] \
            .expand(B, T).contiguous()
        kw = dict(theta=THETA, window=window)
        o, lse = ref.attention_rope_ref(q.float(), k.float(), v.float(), pos,
                                        return_lse=True, **kw)
        o = o.to(dtype)
        shape = [label, B, H, KV, T, hd, window, dt]
        for direction in ("fwd", "bwd"):
            if direction == "fwd":
                def fn(a, b, c):
                    return FA.flash_attention_rope_fwd(a, b, c, pos,
                                                       return_lse=True, **kw)
                ins = (q, k, v)
            else:
                def fn(a, b, c, d, e, f):
                    return FA.flash_attention_rope_backward(a, b, c, pos, d,
                                                            e, f, **kw)
                ins = (q, k, v, o, lse, do)
            try:
                out = fn(*ins)
            except ValueError as e:
                rows.append({"shape": shape, "dir": direction,
                             "unsupported": str(e)})
                continue
            torch.cuda.synchronize()
            call = rotating(fn, input_copies(*ins))
            dev, kernels = device_ms(call)
            rows.append({"shape": shape, "dir": direction,
                         "events_ms": queued_ms(call), "device_ms": dev,
                         "kernels": kernels, "sha": digest(*out)})
            del call, out
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return {"tree": src, "ptxas": ptxas, "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="+", help="directories holding repro_torch")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.srcs[0])), flush=True)
        return 0
    runs = run_rounds(__file__, args.srcs, args.rounds, timeout=1200)
    summary, bits = {}, {}
    for tree, rs in runs.items():
        rows = []
        for i, row in enumerate(rs[0]["rows"]):
            key = " ".join(map(str, row["shape"] + [row["dir"]]))
            if "unsupported" in row:
                rows.append({"shape": row["shape"], "dir": row["dir"],
                             "unsupported": row["unsupported"]})
                continue
            shas = {r["rows"][i]["sha"] for r in rs}
            bits.setdefault(key, set()).update(shas)
            rows.append({
                "shape": row["shape"], "dir": row["dir"],
                **{m: statistics.median(r["rows"][i][m] for r in rs)
                   for m in ("events_ms", "device_ms")},
                "kernels": {n: statistics.median(
                    r["rows"][i]["kernels"].get(n, 0) for r in rs)
                    for n in row["kernels"]},
                "same_bits_every_round": len(shas) == 1})
        ptxas = next((r["ptxas"] for r in rs
                      if any(r["ptxas"].values())), rs[0]["ptxas"])
        summary[tree] = {"rows": rows, "ptxas": ptxas}
    print(smi_line())
    print(json.dumps({"rounds": args.rounds, "trees": summary,
                      "same_bits_across_trees": {k: len(v) == 1
                                                 for k, v in bits.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
