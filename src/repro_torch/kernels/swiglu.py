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
writes ``dg``, ``du`` and the f32 ``dx = dg @ wg^T + du @ wu^T`` (from dg
and du as written, in x's dtype), the recompute and both products in the
kernels' own bodies (two launches). Bound by arithmetic.
The weight gradients ``x^T @ dg`` and ``x^T @ du`` are plain GEMMs of the
caller (:mod:`repro_torch.kernels.ops`), as in the reference.

Each kernel has two bodies, and :func:`_body` picks one from (d, F,
dtype) alone, never from N, so a row gives the same bits whatever rows
share its call:

- ``"wgmma"``: bf16 with d and F multiples of 8 (TMA describes rows
  only at 16-byte strides). Hopper's tensor cores (``wgmma`` with f32
  accumulators) on tiles that TMA brings into a ring of shared-memory
  stages (``csrc/hopper.cuh``). The backward forms dx from the bf16 dg
  and du it writes.
- ``"fma"``: f32, and bf16 at any other d or F. f32 FMAs on shared tiles.

On a CPU tensor each computes its plain version
(:func:`repro_torch.kernels.ref.swiglu_ref`,
:func:`~repro_torch.kernels.ref.swiglu_backward_ref`); on a CUDA tensor it
launches the kernel or raises. The kernels' limits: every operand of one
dtype (f32 or bf16), contiguous, at most ``MAX_ROWS`` rows; on the
``"wgmma"`` body every operand 16-byte aligned (TMA's base addresses).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"swiglu": 0, "swiglu_backward": 0}
MAX_ROWS = 64 * 65535   # the FMA body's 64-row tiles on gridDim.y; both
                        # bodies take it, since N picks no body

_SIGNATURES = {"swiglu_fwd": [L.P] * 5 + [L.I] * 4 + [L.P],
               "swiglu_fwd_wgmma": [L.P] * 5 + [L.I] * 3 + [L.P]}
_BWD_SIGNATURES = {"swiglu_bwd": [L.P] * 8 + [L.I] * 4 + [L.P],
                   "swiglu_bwd_wgmma": [L.P] * 8 + [L.I] * 3 + [L.P]}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _body(d: int, F: int, dtype: torch.dtype) -> str:
    """The kernel body for hidden width d, SwiGLU width F and dtype:
    ``"wgmma"`` (tensor cores, TMA) or ``"fma"``. N plays no part."""
    if dtype == torch.bfloat16 and d % 8 == 0 and F % 8 == 0:
        return "wgmma"
    return "fma"


def _check_aligned(*ts: Tensor) -> None:
    if not L.aligned(*ts):
        raise ValueError("bf16 operands of the wgmma body must be 16-byte "
                         "aligned")


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
    ptrs = (x.data_ptr(), wg.data_ptr(), wu.data_ptr(), h.data_ptr(),
            g.data_ptr())
    with torch.cuda.device(dev):
        if _body(d, F, x.dtype) == "wgmma":
            _check_aligned(x, wg, wu, h, g)
            L.call(lib.swiglu_fwd_wgmma, *ptrs, N, d, F, L.stream(dev))
        else:
            L.call(lib.swiglu_fwd, *ptrs, N, d, F, code, L.stream(dev))
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
    lib = L.bind("swiglu_bwd.cu", _BWD_SIGNATURES)
    ptrs = (x.data_ptr(), wg.data_ptr(), wu.data_ptr(), g.data_ptr(),
            dh.data_ptr(), dg.data_ptr(), du.data_ptr(), dx.data_ptr())
    with torch.cuda.device(dev):
        if _body(d, F, x.dtype) == "wgmma":
            _check_aligned(x, wg, wu, g, dh, dg, du, dx)
            L.call(lib.swiglu_bwd_wgmma, *ptrs, N, d, F, L.stream(dev))
        else:
            L.call(lib.swiglu_bwd, *ptrs, N, d, F, code, L.stream(dev))
    launches["swiglu_backward"] += 1
    return dx, dg, du
