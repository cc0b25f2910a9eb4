"""Wrappers of the Hopper fused residual-add + RMSNorm kernels
(``csrc/rmsnorm_residual.cu``).

``rmsnorm_residual`` replaces
``src/repro/kernels/fused_norm.py:rmsnorm_residual_pallas`` (forward): one
pass over x and r writes the new residual stream ``s = x + r`` and the
normed ``y = rmsnorm(s) * scale``. It is bound by device-memory bytes
(read x and r, write s and y). With ``r=None`` it is a plain RMSNorm of x:
the kernel reads x and writes y only, and s is x itself.

``rmsnorm_residual_backward`` replaces
``src/repro/kernels/fused_norm.py:rmsnorm_residual_backward_pallas``: from
the saved ``(s, scale)`` and the cotangents of y and s it writes ``dx``
(which is also ``dr``) and the f32 ``dscale``, reduced over rows in two
fixed-order stages (no atomics). ``ds=None`` is a zero cotangent on s (the
norms with no residual): the kernel then reads no ``ds``. Bound by bytes.

On a CPU tensor each computes its plain version
(:func:`repro_torch.kernels.ref.rmsnorm_residual_ref`,
:func:`~repro_torch.kernels.ref.rmsnorm_residual_backward_ref`); on a CUDA
tensor it launches the kernel or raises. The kernels' limits: f32 or bf16
rows of ``d <= MAX_D`` features (a row is staged in shared memory).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"rmsnorm_residual": 0,
                            "rmsnorm_residual_backward": 0}
MAX_D = 8192
BWD_BLOCKS = 256         # row runs of the backward (partials of dscale)

_SIGNATURES = {
    "rmsnorm_residual_fwd": [L.P] * 5 + [L.I, L.I, L.F, L.I, L.I, L.P],
    "rmsnorm_residual_bwd": [L.P] * 7 + [L.I] * 4 + [L.F, L.I, L.I, L.P],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_rows(x: Tensor, name: str = "x") -> Tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"{name} must be (N, d), got {tuple(x.shape)}")
    N, d = x.shape
    L.dtype_code(name, x)
    L.check(name, x, (N, d), x.device)
    if not 1 <= d <= MAX_D:
        raise ValueError(f"d={d}: the kernel takes 1 <= d <= {MAX_D}")
    L.check_index("N", N)
    return N, d


def rmsnorm_residual(x: Tensor, r: Optional[Tensor], scale: Tensor, *,
                     eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """x, r: (N, d); scale: (d,). Returns (y = rmsnorm(x + r) * scale,
    s = x + r), both (N, d) in x.dtype. ``r=None`` is a zero residual:
    y = rmsnorm(x) * scale and s is x."""
    if not x.is_cuda:
        return ref.rmsnorm_residual_ref(x, r, scale, eps)
    N, d = _check_rows(x)
    dev = x.device
    code = L.dtype_code("x", x)
    if r is not None:
        L.check("r", r, (N, d), dev, x.dtype)
    L.check("scale", scale, (d,), dev)
    scale32 = scale.float().contiguous()
    y = torch.empty_like(x)
    s = x if r is None else torch.empty_like(x)
    vec = int(d % (16 // x.element_size()) == 0
              and L.aligned(*(t for t in (x, r, y, s) if t is not None)))
    lib = L.bind("rmsnorm_residual.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.rmsnorm_residual_fwd, x.data_ptr(), L.ptr(r),
               scale32.data_ptr(), y.data_ptr(),
               None if r is None else s.data_ptr(), N, d, float(eps), code,
               vec, L.stream(dev))
    launches["rmsnorm_residual"] += 1
    return y, s


def rmsnorm_residual_backward(s: Tensor, scale: Tensor, dy: Tensor,
                              ds: Optional[Tensor], *, eps: float = 1e-6
                              ) -> Tuple[Tensor, Tensor]:
    """s, dy, ds: (N, d) of one dtype; scale: (d,). Returns (dx (N, d) in
    s.dtype, which is also dr, and dscale (d,) f32). ``ds=None`` is a zero
    cotangent on s."""
    if not s.is_cuda:
        return ref.rmsnorm_residual_backward_ref(s, scale, dy, ds, eps)
    N, d = _check_rows(s, "s")
    dev = s.device
    code = L.dtype_code("s", s)
    L.check("dy", dy, (N, d), dev, s.dtype)
    if ds is not None:
        L.check("ds", ds, (N, d), dev, s.dtype)
    L.check("scale", scale, (d,), dev)
    scale32 = scale.float().contiguous()
    rows_per_block = -(-N // min(N, BWD_BLOCKS))
    nblk = -(-N // rows_per_block)
    dx = torch.empty_like(s)
    partial = torch.empty((nblk, d), device=dev, dtype=torch.float32)
    dscale = torch.empty((d,), device=dev, dtype=torch.float32)
    vec = int(d % (16 // s.element_size()) == 0
              and L.aligned(*(t for t in (s, dy, ds, dx) if t is not None)))
    lib = L.bind("rmsnorm_residual.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.rmsnorm_residual_bwd, s.data_ptr(), scale32.data_ptr(),
               dy.data_ptr(), L.ptr(ds), dx.data_ptr(), partial.data_ptr(),
               dscale.data_ptr(), N, d, nblk, rows_per_block, float(eps),
               code, vec, L.stream(dev))
    launches["rmsnorm_residual_backward"] += 1
    return dx, dscale
