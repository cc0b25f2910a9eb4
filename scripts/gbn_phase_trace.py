#!/usr/bin/env python3
"""Per-block phase times of the persistent GBN body on one NVIDIA GPU.

    python3 scripts/gbn_phase_trace.py
    python3 scripts/gbn_phase_trace.py --variant 1:1:32768   # bps:depth:sub

Builds an instrumented copy of ``src/repro_torch/kernels/csrc`` into a
temporary directory (thread 0 of every block writes ``%globaltimer`` at six
edges of each ghost of its walk; the package's sources are not changed)
and runs it through the wrappers at the ResNet44/F1 path's shapes, with the
package's plan or the variant's. Edges of a ghost: 0 its reduction starts,
1 its slice is summed by each thread (every sub-chunk landed), 2 the
block's partial is stored and the block has arrived, 3 the group's
barrier is passed, 4 the partials are merged, 5 the slice is normalized
and its stores issued. Prints one JSON line a (shape, direction): the
kernel's span, the plan, and each phase's median, 90th percentile and
maximum over blocks and ghosts, in microseconds; ``round`` is the time
from one ghost's edge 5 to the next's. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MAX_BLOCKS, MAX_GHOSTS, EDGES = 1024, 64, 6
PROBE = """
__device__ unsigned long long g_trace[%d][%d][%d];
#define TRACE(j, e) do { if (threadIdx.x == 0 && (j) < %d) { \\
  unsigned long long t_; \\
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); \\
  g_trace[blockIdx.x][j][e] = t_; } } while (0)
""" % (MAX_BLOCKS, MAX_GHOSTS, EDGES, MAX_GHOSTS)
READER = """
extern "C" int gbn_trace_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace,
                                               sizeof(g_trace)));
}
"""
# (text of the persistent kernels, the same with TRACE marks); every
# occurrence is marked
MARKS = [
    ("    float shift[VEC], s1[VEC], s2[VEC];\n",
     "    float shift[VEC], s1[VEC], s2[VEC];\n    TRACE(j, 0);\n"),
    ("    float m[VEC], rs[VEC], sdy[VEC], sdyxh[VEC];\n",
     "    float m[VEC], rs[VEC], sdy[VEC], sdyxh[VEC];\n    TRACE(j, 0);\n"),
    ("    block_sums<VEC, NT>(ln, sm.red, s1, s2, C);\n",
     "    TRACE(j, 1);\n    block_sums<VEC, NT>(ln, sm.red, s1, s2, C);\n"),
    ("    block_sums<VEC, NT>(ln, sm.red, sdy, sdyxh, C);\n",
     "    TRACE(j, 1);\n    block_sums<VEC, NT>(ln, sm.red, sdy, sdyxh, C);\n"),
    ("    group_arrive(counters + g);\n",
     "    group_arrive(counters + g);\n    TRACE(j, 2);\n"),
    ("    group_wait(counters + g, pl.P);\n",
     "    group_wait(counters + g, pl.P);\n    TRACE(j, 3);\n"),
    ("        sm.tmp, sm.coef, sm.coef + C, sm.coef + 2 * C);\n",
     "        sm.tmp, sm.coef, sm.coef + C, sm.coef + 2 * C);\n"
     "    TRACE(j, 4);\n"),
    ("        sm.tmp, nullptr, sm.coef, sm.coef + C);\n",
     "        sm.tmp, nullptr, sm.coef, sm.coef + C);\n    TRACE(j, 4);\n"),
    ("issued++);\n    }\n  };\n", "issued++);\n    }\n    TRACE(j, 5);\n  };\n"),
]


def build_traced(root: Path) -> Path:
    from repro_torch.kernels import build
    src = root / "csrc"
    shutil.copytree(build.CSRC, src)
    text = (src / "gbn.cu").read_text()
    text = text.replace("namespace {\n", PROBE + "\nnamespace {\n", 1)
    for old, new in MARKS:
        if old not in text:
            raise RuntimeError(f"gbn.cu has no {old!r}")
        text = text.replace(old, new)
    (src / "gbn.cu").write_text(text + READER)
    out = root / "libgbn_traced.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src / "gbn.cu")], check=True, capture_output=True,
                   text=True)
    return out


def stats(xs):
    xs = sorted(xs)
    return [round(statistics.median(xs), 3),
            round(xs[int(0.9 * (len(xs) - 1))], 3), round(xs[-1], 3)]


def trace(lib, fn, p, G):
    """Runs ``fn`` once warm and once traced; phase times in us."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    buf = np.zeros((MAX_BLOCKS, MAX_GHOSTS, EDGES), np.uint64)
    fn()
    torch.cuda.synchronize()
    if lib.gbn_trace_read(buf.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise RuntimeError("gbn_trace_read failed")
    nj = -(-G // p.ngroups)
    t = buf[:p.grid, :nj].astype(np.float64) / 1e3      # us
    k = np.arange(p.grid) // p.P
    valid = np.array([[k[b] + j * p.ngroups < G for j in range(nj)]
                      for b in range(p.grid)])
    t0 = t[:, :, 0][valid].min()
    phases = {}
    names = ["sum", "partial", "barrier", "merge", "write"]
    for e, name in enumerate(names):
        phases[name] = stats((t[:, :, e + 1] - t[:, :, e])[valid])
    rounds = [t[b, j + 1, 5] - t[b, j, 5] for b in range(p.grid)
              for j in range(nj - 1) if valid[b, j + 1]]
    if rounds:
        phases["round"] = stats(rounds)
    phases["span"] = round(float(t[:, :, 5][valid].max() - t0), 3)
    return phases


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default=None,
                    help="BLOCKS_PER_SM:DEPTH:SUB_BYTES (default: the "
                         "package's plan)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gbn_phase_trace: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.kernels import gbn as K
    from repro_torch.kernels import launch as L
    from scripts.gbn_times import calls, inputs, path_shapes, plan_fields
    kw = {}
    if args.variant:
        b, d, s = (int(v) for v in args.variant.split(":"))
        kw = dict(blocks_per_sm=b, depth=d, sub_bytes=s)
    with tempfile.TemporaryDirectory() as root:
        lib = ctypes.CDLL(str(build_traced(Path(root))))
        lib.gbn_trace_read.argtypes = [ctypes.c_void_p]
        build._loaded["gbn.cu"] = lib
        L._bound.pop("gbn.cu", None)
        sms = K.sm_count(torch.cuda.current_device())
        for shape in path_shapes():
            G, R, C = shape
            pf = K.plan(G, R, C, sms, backward=False, **kw)
            pb = K.plan(G, R, C, sms, backward=True, **kw)
            for name, fn in calls(pf, pb, inputs(shape)).items():
                p = pf if name == "forward" else pb
                if p.body != "persistent":
                    continue
                print(json.dumps({"shape": shape, "wrapper": name,
                                  "plan": plan_fields(p),
                                  "us": trace(lib, fn, p, G)}), flush=True)
            torch.cuda.empty_cache()
    print(CS.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
