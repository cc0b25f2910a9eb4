"""Wrappers of the Hopper fused SwiGLU kernels (``csrc/swiglu.cu``,
``csrc/swiglu_bwd.cu``).

``swiglu`` replaces ``src/repro/kernels/swiglu.py:swiglu_pallas``
(forward): both GEMMs ``x @ wg`` and ``x @ wu`` and the ``silu(g) * u``
gate in one kernel, writing ``h`` and the gate pre-activation ``g`` (the
one hidden residual the backward keeps). Bound by
arithmetic at prefill (many rows) and by the weight bytes at decode (a
few rows).

``swiglu_backward`` replaces
``src/repro/kernels/swiglu.py:swiglu_backward_pallas``: from the saved
gate ``g`` and the cotangent ``dh`` it recomputes ``u = x @ wu`` and
writes ``dg``, ``du`` and the f32 ``dx = dg @ wg^T + du @ wu^T``, the
recompute and both products in the kernel's own body. Bound by arithmetic.
The weight gradients ``x^T @ dg`` and ``x^T @ du`` are plain GEMMs of the
caller (:mod:`repro_torch.kernels.ops`), as in the reference.

On a CPU tensor each computes its plain version
(:func:`repro_torch.kernels.ref.swiglu_ref`,
:func:`~repro_torch.kernels.ref.swiglu_backward_ref`); on a CUDA tensor it
launches the kernel or raises. The kernels' limits: every operand of one
dtype (f32 or bf16), contiguous, at most ``MAX_ROWS`` rows.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"swiglu": 0, "swiglu_backward": 0}
MAX_ROWS = 64 * 65535           # 64-row tiles on gridDim.y

_SIGNATURES = {"swiglu_fwd": [L.P] * 5 + [L.I] * 4 + [L.P]}
_BWD_SIGNATURES = {"swiglu_bwd": [L.P] * 10 + [L.I] * 4 + [L.P]}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(x: Tensor, wg: Tensor, wu: Tensor) -> Tuple[int, int, int, int]:
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
    return N, d, F, code


def swiglu(x: Tensor, wg: Tensor, wu: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (N, d); wg, wu: (d, F). Returns (h = silu(x @ wg) * (x @ wu),
    g = x @ wg), both (N, F) in x.dtype."""
    if not x.is_cuda:
        return ref.swiglu_ref(x, wg, wu)
    N, d, F, code = _check(x, wg, wu)
    dev = x.device
    h = torch.empty((N, F), device=dev, dtype=x.dtype)
    g = torch.empty_like(h)
    lib = L.bind("swiglu.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.swiglu_fwd, x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
               h.data_ptr(), g.data_ptr(), N, d, F, code, L.stream(dev))
    launches["swiglu"] += 1
    return h, g


def swiglu_backward(x: Tensor, wg: Tensor, wu: Tensor, g: Tensor,
                    dh: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """x: (N, d); wg, wu: (d, F); g, dh: (N, F). Returns (dx (N, d) f32,
    dg, du (N, F) in x.dtype)."""
    if not x.is_cuda:
        return ref.swiglu_backward_ref(x, wg, wu, g, dh)
    N, d, F, code = _check(x, wg, wu)
    dev = x.device
    L.check("g", g, (N, F), dev, x.dtype)
    L.check("dh", dh, (N, F), dev, x.dtype)
    dg = torch.empty((N, F), device=dev, dtype=x.dtype)
    du = torch.empty_like(dg)
    dx = torch.empty((N, d), device=dev, dtype=torch.float32)
    # a bf16 x: dx is formed from f32 copies of dg and du (scratch)
    f32 = x.dtype == torch.float32
    dgf = None if f32 else torch.empty((N, F), device=dev,
                                       dtype=torch.float32)
    duf = None if f32 else torch.empty_like(dgf)
    lib = L.bind("swiglu_bwd.cu", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.swiglu_bwd, x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
               g.data_ptr(), dh.data_ptr(), dg.data_ptr(), du.data_ptr(),
               L.ptr(dgf), L.ptr(duf), dx.data_ptr(), N, d, F, code,
               L.stream(dev))
    launches["swiglu_backward"] += 1
    return dx, dg, du
