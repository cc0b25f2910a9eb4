#!/usr/bin/env python3
"""Per-block phase times of the Mamba chunk-scan pair on one NVIDIA GPU.

    python3 scripts/mamba_phase_trace.py

Builds an instrumented copy of ``src/repro_torch/kernels/csrc`` into a
temporary directory (thread 0 of every block reads ``clock64`` at the
edges of each ring item; the package's sources are not changed) and runs
it through the wrappers at the falcon-mamba path's shape (8, 256, 8192, 16)
and its solo row, in f32.

Edges of a backward item (a segment of the checkpoint pass or of the
reverse pass): 0 the loop's top, 1 the item's boxes have landed and the
block has met (the slot's mbarrier and ``__syncthreads``), 2 the previous
reverse segment's dB/dC row, dx and ddt are stored and the next item's
boxes asked for, 3 the item's steps are done. Edges of a forward tile: 0
the loop's top, 1 boxes landed and the block met, 2 the previous tile's y
stored and the next tile's boxes asked for, 3 the tile's steps done.
Prints one JSON line a (shape, kernel): the median, 90th percentile and
largest time of a block's run and of each phase over blocks and items, in
SM clock cycles.
Raises if a mark's text is gone from the source. Imports nothing of JAX.
"""
from __future__ import annotations

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

SOURCE = "mamba_scan.cu"
MAX_BLOCKS, MAX_ITEMS = 1024, 64
PROBE = """
__device__ long long g_bwd[%(B)d][%(I)d][4];
__device__ long long g_fwd[%(B)d][%(I)d][4];
#define TRACE(arr, i, e) do { \\
  const int blk_ = blockIdx.y * gridDim.x + blockIdx.x; \\
  if (threadIdx.x == 0 && blk_ < %(B)d && (i) < %(I)d) \\
    arr[blk_][i][e] = clock64(); } while (0)
""" % {"B": MAX_BLOCKS, "I": MAX_ITEMS}
READER = """
extern "C" int mamba_trace_read(long long* bwd, long long* fwd) {
  int e = static_cast<int>(cudaMemcpyFromSymbol(bwd, g_bwd, sizeof(g_bwd)));
  if (e) return e;
  return static_cast<int>(cudaMemcpyFromSymbol(fwd, g_fwd, sizeof(g_fwd)));
}
"""
# (text of csrc/mamba_scan.cu, the same with TRACE marks)
MARKS = [
    ("    if (vec) hp::mbar_wait(&bar[i % kStages], (i / kStages) & 1);\n"
     "    __syncthreads();  // item i has landed; item i - 1 is done with\n"
     "    if (i > nseg) finish(i - 1);\n"
     "    if (i + kStages - 1 < items) issue(i + kStages - 1);\n",
     "    TRACE(g_bwd, i, 0);\n"
     "    if (vec) hp::mbar_wait(&bar[i % kStages], (i / kStages) & 1);\n"
     "    __syncthreads();  // item i has landed; item i - 1 is done with\n"
     "    TRACE(g_bwd, i, 1);\n"
     "    if (i > nseg) finish(i - 1);\n"
     "    if (i + kStages - 1 < items) issue(i + kStages - 1);\n"
     "    TRACE(g_bwd, i, 2);\n"),
    ("      continue;\n    }\n",
     "      TRACE(g_bwd, i, 3);\n      continue;\n    }\n"),
    ("      reverse(std::false_type{});\n  }\n",
     "      reverse(std::false_type{});\n    TRACE(g_bwd, i, 3);\n  }\n"),
    ("    if (vec) hp::mbar_wait(&bar[j % kStages], (j / kStages) & 1);\n"
     "    __syncthreads();  // tile j has landed; tile j - 1's slot and y are "
     "done\n",
     "    TRACE(g_fwd, j, 0);\n"
     "    if (vec) hp::mbar_wait(&bar[j % kStages], (j / kStages) & 1);\n"
     "    __syncthreads();  // tile j has landed; tile j - 1's slot and y are "
     "done\n"
     "    TRACE(g_fwd, j, 1);\n"),
    ("    if (j + kStages - 1 < ntiles) issue(j + kStages - 1);\n",
     "    if (j + kStages - 1 < ntiles) issue(j + kStages - 1);\n"
     "    TRACE(g_fwd, j, 2);\n"),
    ("      tile(std::false_type{});\n  }\n",
     "      tile(std::false_type{});\n    TRACE(g_fwd, j, 3);\n  }\n"),
]


def build(root: Path) -> Path:
    """The instrumented library, built in ``root``."""
    from repro_torch.kernels import build as B
    shutil.copytree(B.CSRC, root / "csrc")
    src = root / "csrc" / SOURCE
    text = src.read_text()
    for old, new in MARKS:
        if old not in text:
            raise RuntimeError(f"{SOURCE} has lost the mark {old[:60]!r}")
        text = text.replace(old, new)
    text = text.replace('#include "common.cuh"\n',
                        '#include "common.cuh"\n' + PROBE, 1) + READER
    src.write_text(text)
    out = root / "libmamba_trace.so"
    subprocess.run([B.find_nvcc(), *B.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    return out


def stats(xs):
    xs = sorted(xs)
    return {"median": statistics.median(xs),
            "p90": xs[int(0.9 * (len(xs) - 1))], "max": xs[-1]}


def phases(tr, nblocks, nitems, names):
    """{phase: stats} over blocks and items; a phase is the time between two
    edges of an item (None where an edge was not reached)."""
    out = {}
    for name, a, e in names:
        xs = [tr[b][i][e] - tr[b][i][a] for b in range(nblocks)
              for i in nitems if tr[b][i][e] and tr[b][i][a]]
        if xs:
            out[name] = stats(xs)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mamba_phase_trace: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import build as B
    from repro_torch.kernels import launch as L
    from repro_torch.kernels import mamba_scan as MS
    full = CS.mamba_full_shape()
    with tempfile.TemporaryDirectory() as root:
        lib = ctypes.CDLL(str(build(Path(root))))
        B._loaded[SOURCE] = lib
        L._bound.pop(SOURCE, None)
        lib.mamba_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        for shape in (full, (1,) + tuple(full[1:])):
            gen = torch.Generator(device="cuda").manual_seed(0)
            ins, dy, dhl = CS.mamba_inputs(gen, *shape, torch.float32)
            for name, fn, backward in (
                    ("mamba_chunk", lambda: MS.mamba_chunk(*ins), False),
                    ("mamba_chunk_backward",
                     lambda: MS.mamba_chunk_backward(*ins, dy, dhl), True)):
                p = MS.plan(*shape, backward=backward)
                fn()                   # warm; the second call's edges are read
                fn()
                torch.cuda.synchronize()
                bwd = (ctypes.c_longlong * (MAX_BLOCKS * MAX_ITEMS * 4))()
                fwd = (ctypes.c_longlong * (MAX_BLOCKS * MAX_ITEMS * 4))()
                if lib.mamba_trace_read(ctypes.addressof(bwd),
                                        ctypes.addressof(fwd)):
                    raise RuntimeError("could not read the traces")
                nblocks = min(MAX_BLOCKS, p.grid[0] * p.grid[1])
                flat = bwd if backward else fwd
                tr = [[flat[(b * MAX_ITEMS + i) * 4:(b * MAX_ITEMS + i + 1) * 4]
                       for i in range(MAX_ITEMS)] for b in range(nblocks)]
                n = min(MAX_ITEMS, 2 * p.nseg if backward else p.nseg)
                edges = [("wait", 0, 1), ("store and issue", 1, 2),
                         ("steps", 2, 3)]
                if backward:
                    rows = {
                        "checkpoint pass": phases(tr, nblocks, range(p.nseg),
                                                  edges),
                        "reverse pass": phases(tr, nblocks,
                                               range(p.nseg, n), edges)}
                else:
                    rows = {"tiles": phases(tr, nblocks, range(n), edges)}
                last = 3
                spans = [tr[b][n - 1][last] - tr[b][0][0]
                         for b in range(nblocks)
                         if tr[b][0][0] and tr[b][n - 1][last]]
                print(json.dumps({"shape": shape, "kernel": name,
                                  "plan": {"threads": p.threads,
                                           "grid": p.grid, "ckpt": p.ckpt},
                                  "block_cycles": stats(spans),
                                  "phases_cycles": rows}), flush=True)
            del ins, dy, dhl
            torch.cuda.empty_cache()
    print(CS.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
