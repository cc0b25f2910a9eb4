#!/usr/bin/env python3
"""Per-block phase times of the split-KV decode body on one NVIDIA GPU.

    python3 scripts/decode_phase_trace.py

Builds an instrumented copy of ``src/repro_torch/kernels/csrc`` into a
temporary directory (thread 0 of every block writes ``clock64`` at eight
edges of ``decode_cluster`` and ``%globaltimer`` at the first and last;
the package's sources are not changed) and runs it through the wrappers at
the shapes of ``scripts/decode_chunk_sweep.py``: B12 at a qwen3-1.7b
generate step (position 542, ``chip_smoke.DECODE_CACHES`` caches in turn)
and B13 at the engine's shapes (bf16 and int8 pools). Edges: 0 start, 1 first chunks issued, 2 query rows ready,
3 first chunk landed, 4 chunks done, 5 partial stored into rank 0's
inbox, 6 cluster barrier passed, 7 output written. Prints one JSON line
a case: the kernel's span (globaltimer), the blocks' start times, and
each phase's median, 90th percentile and maximum over the blocks of five
calls, in microseconds at the measured clock. Imports nothing of JAX.
"""
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

SOURCES = ("flash_decode.cu", "flash_decode_paged.cu")
NT = 10   # a block's record: clock64 at edges 0..7, globaltimer at 0 and 7
PROBE = """
__device__ unsigned long long g_trace[1 << 16][%d];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE(i) do { if (threadIdx.x == 0) { \\
  const int bid_ = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x \\
                   + blockIdx.x; \\
  g_trace[bid_][i] = clock64(); \\
  if ((i) == 0) g_trace[bid_][8] = gtimer(); \\
  if ((i) == 7) g_trace[bid_][9] = gtimer(); } } while (0)
""" % NT
# (text in decode_cluster, the same text with a TRACE before or after it)
MARKS = [
    ("  // every block of the cluster has started",
     "  TRACE(0);\n  // every block of the cluster has started"),
    ("  // the query rows, while the first chunks are in flight\n",
     "  TRACE(1);\n"
     "  // the query rows, while the first chunks are in flight\n"),
    ("  float acc[CPT];\n", "  TRACE(2);\n  float acc[CPT];\n"),
    ("    cp_async_wait<STAGES - 1>();\n    __syncthreads();\n",
     "    cp_async_wait<STAGES - 1>();\n    __syncthreads();\n"
     "    if (j == 0) TRACE(3);\n"),
    ("  // the block's partial: the slot groups'",
     "  TRACE(4);\n  // the block's partial: the slot groups'"),
    ("  cluster_sync();  // rank 0's inbox is complete\n",
     "  TRACE(5);\n  cluster_sync();  // rank 0's inbox is complete\n"
     "  TRACE(6);\n"),
    ("      o[q_base + i] = from_f<Q>(lsum > 0.f ? a / lsum : 0.f);\n    }\n"
     "  }\n}",
     "      o[q_base + i] = from_f<Q>(lsum > 0.f ? a / lsum : 0.f);\n    }\n"
     "  }\n  TRACE(7);\n}"),
]
READ = """
extern "C" int trace_read(void* dst, size_t n) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, n);
}
extern "C" int trace_clear() {
  static char zero[sizeof(g_trace)];
  return (int)cudaMemcpyToSymbol(g_trace, zero, sizeof(zero));
}
"""
PHASES = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (0, 4),
          (0, 7)]


def patched(tmp: Path) -> None:
    """An instrumented copy of the kernel sources in ``tmp``."""
    from repro_torch.kernels import build
    for f in build.CSRC.iterdir():
        shutil.copy(f, tmp / f.name)
    body = tmp / "flash_decode.cuh"
    text = body.read_text().replace('#include "common.cuh"',
                                    '#include "common.cuh"\n' + PROBE)
    for plain, traced in MARKS:
        if plain not in text:
            raise RuntimeError(f"decode_cluster has changed: {plain!r}")
        text = text.replace(plain, traced)
    body.write_text(text)
    for src in SOURCES:
        (tmp / src).write_text((tmp / src).read_text() + READ)


def summary(calls, blocks):
    """Span, start times and phase times (us) over the blocks of calls."""
    spans, starts, rate = [], [], []
    for call in calls:
        g0 = min(r[8] for r in call)
        spans.append((max(r[9] for r in call) - g0) / 1e3)
        starts = sorted((r[8] - g0) / 1e3 for r in call)
        rate += [(r[7] - r[0]) / (r[9] - r[8]) for r in call
                 if r[9] > r[8] and r[7] > r[0]]
    ghz = statistics.median(rate)          # clock64 cycles a nanosecond
    phases = {}
    for a, b in PHASES:
        ts = sorted((r[b] - r[a]) / ghz / 1e3 for call in calls for r in call
                    if r[a] and r[b] and r[b] >= r[a])
        if ts:
            phases[f"{a}-{b}"] = [round(statistics.median(ts), 2),
                                  round(ts[int(0.9 * (len(ts) - 1))], 2),
                                  round(ts[-1], 2)]
    return {"blocks": blocks, "span_us": [round(x, 2) for x in spans],
            "clock_ghz": round(ghz, 3),
            "start_us_quantiles": [round(starts[int(f * (len(starts) - 1))],
                                         2)
                                   for f in (0, .25, .5, .75, .9, 1)],
            "phase_us_median_p90_max": phases}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_phase_trace: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import launch as L
    from repro_torch.kernels import ref
    nvcc = build.find_nvcc()
    with tempfile.TemporaryDirectory() as root:
        tmp = Path(root)
        patched(tmp)
        libs, procs = {}, []
        for src in SOURCES:
            out = tmp / f"{src}.so"
            procs.append((src, out, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-o", str(out), str(tmp / src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for src, out, p in procs:
            _, err = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"{src}: {err[-3000:]}")
            libs[src] = out

        cfg = get_config(CS.SERVE_ARCH)
        H, KV, hd, theta = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                            cfg.rope_theta)
        gen = torch.Generator(device="cuda").manual_seed(1)

        def randn(*shape):
            return torch.randn(*shape, generator=gen,
                               device="cuda").bfloat16()

        B, S = CS.SERVE_B, CS.SERVE_P + CS.SERVE_NEW
        q = randn(B, H, hd)
        n_caches = CS.DECODE_CACHES
        caches = [(randn(B, KV, S, hd), randn(B, KV, S, hd))
                  for _ in range(n_caches)]
        off = CS.serve_offsets(CS.PROMPT_LENS, CS.SERVE_P)
        Be = CS.ENGINE_SLOTS
        qe = randn(Be, H, hd)
        epos = torch.arange(Be, device="cuda", dtype=torch.int32) * 56 + 128
        pools = []
        for i in range(4):
            k, v = (randn(Be, KV, CS.ENGINE_MAX_LEN, hd) for _ in range(2))
            kp, vp, pt = CS.paged_from_contiguous(k, v, CS.ENGINE_PAGE,
                                                  seed=5 + i)
            (kq, ks), (vq, vs) = (ref.quantize_slots(kp),
                                  ref.quantize_slots(vp))
            pools.append((kp, vp, pt, kq, ks, vq, vs))
        cases = {
            "b12": ("flash_decode.cu", B * KV, lambda i: FD.flash_decode(
                q, *caches[i % n_caches], S - 2, offsets=off, rope_theta=theta)),
            "b13_bf16": ("flash_decode_paged.cu", Be * KV,
                         lambda i: FD.flash_decode_paged(
                             qe, *pools[i % 4][:3], epos,
                             rope_theta=theta)),
            "b13_int8": ("flash_decode_paged.cu", Be * KV,
                         lambda i: FD.flash_decode_paged(
                             qe, pools[i % 4][3], pools[i % 4][5],
                             pools[i % 4][2], epos, k_scale=pools[i % 4][4],
                             v_scale=pools[i % 4][6], rope_theta=theta)),
        }
        for name, (src, clusters, fn) in cases.items():
            lib = ctypes.CDLL(str(libs[src]))
            build._loaded[src] = lib
            L._bound.pop(src, None)
            for i in range(5):
                fn(i)
            torch.cuda.synchronize()
            blocks = clusters * 8
            calls = []
            for i in range(5, 10):
                lib.trace_clear()
                fn(i)
                torch.cuda.synchronize()
                buf = (ctypes.c_uint64 * (blocks * NT))()
                if lib.trace_read(buf, ctypes.sizeof(buf)) != 0:
                    raise RuntimeError("trace_read failed")
                calls.append([list(buf[b * NT:(b + 1) * NT])
                              for b in range(blocks)])
            print(json.dumps({"case": name, **summary(calls, blocks)}))
    print(CS.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
