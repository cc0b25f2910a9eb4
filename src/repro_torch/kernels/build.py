"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with :mod:`ctypes`. Libraries are named by
a hash of their source, the shared headers (``*.cuh``) and the flags, and
written into ``_build/`` beside this file (ignored by git), so a changed
source is rebuilt and an unchanged one is built once per checkout. Sources
are compiled in parallel, one ``nvcc`` each. A missing ``nvcc`` or a failed
compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
SOURCES = ("gbn.cu", "rmsnorm_residual.cu", "swiglu.cu", "swiglu_bwd.cu",
           "flash_attention.cu", "flash_attention_bwd.cu", "flash_decode.cu",
           "flash_decode_paged.cu", "mamba_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}        # source -> ptxas report of its build
build_seconds: Dict[str, float] = {}   # source -> seconds its nvcc ran


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       f"{DEFAULT_CUDA_HOME}/bin); the CUDA kernels cannot "
                       "be built")


def library_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # included by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing; returns the paths."""
    todo = [s for s in sources if not library_path(s).exists()]
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        t0 = time.perf_counter()
        for s in todo:
            out = library_path(s)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
            procs.append((s, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        outputs = {}

        def drain(s, p):            # each nvcc's output and its seconds
            outputs[s] = p.communicate()
            build_seconds[s] = time.perf_counter() - t0

        threads = [threading.Thread(target=drain, args=(s, p))
                   for s, _, _, p in procs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = []
        for s, out, tmp, p in procs:
            stdout, stderr = outputs[s]
            if p.returncode != 0:
                failed.append(f"{s}: nvcc exited {p.returncode}\n"
                              f"{stdout}{stderr}")
                continue
            build_logs[s] = stdout + stderr
            os.replace(tmp, out)     # atomic: concurrent builders agree
        if failed:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return {s: library_path(s) for s in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build([source])[source]))
    return _loaded[source]
