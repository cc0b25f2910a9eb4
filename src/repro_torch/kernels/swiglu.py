"""Wrapper of the Hopper fused SwiGLU kernel (``csrc/swiglu.cu``).

``swiglu`` replaces ``src/repro/kernels/swiglu.py:swiglu_pallas``
(forward): both GEMMs ``x @ wg`` and ``x @ wu`` and the ``silu(g) * u``
gate in one kernel, writing ``h`` and the gate pre-activation ``g`` (the
one hidden residual the training slice's backward keeps). Bound by
arithmetic at prefill (many rows) and by the weight bytes at decode (a
few rows).

On a CPU tensor it computes its plain version
(:func:`repro_torch.kernels.ref.swiglu_ref`); on a CUDA tensor it launches
the kernel or raises. The kernel's limits: x, wg, wu of one dtype (f32 or
bf16), contiguous, at most ``MAX_ROWS`` rows.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"swiglu": 0}
MAX_ROWS = 64 * 65535           # 64-row tiles on gridDim.y

_SIGNATURES = {"swiglu_fwd": [L.P] * 5 + [L.I] * 4 + [L.P]}


def reset_launches() -> None:
    launches["swiglu"] = 0


def swiglu(x: Tensor, wg: Tensor, wu: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (N, d); wg, wu: (d, F). Returns (h = silu(x @ wg) * (x @ wu),
    g = x @ wg), both (N, F) in x.dtype."""
    if not x.is_cuda:
        return ref.swiglu_ref(x, wg, wu)
    if x.dim() != 2 or wg.dim() != 2:
        raise ValueError(f"x must be (N, d) and wg (d, F), got "
                         f"{tuple(x.shape)} and {tuple(wg.shape)}")
    N, d = x.shape
    F = wg.shape[1]
    dev = x.device
    code = L.dtype_code("x", x)
    L.check("x", x, (N, d), dev)
    L.check("wg", wg, (d, F), dev, x.dtype)
    L.check("wu", wu, (d, F), dev, x.dtype)
    if not 1 <= N <= MAX_ROWS:
        raise ValueError(f"N={N}: the kernel takes 1 <= N <= {MAX_ROWS}")
    h = torch.empty((N, F), device=dev, dtype=x.dtype)
    g = torch.empty_like(h)
    lib = L.bind("swiglu.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.swiglu_fwd, x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
               h.data_ptr(), g.data_ptr(), N, d, F, code, L.stream(dev))
    launches["swiglu"] += 1
    return h, g
