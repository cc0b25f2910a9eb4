"""Wrapper of the Hopper fused residual-add + RMSNorm kernel
(``csrc/rmsnorm_residual.cu``).

``rmsnorm_residual`` replaces
``src/repro/kernels/fused_norm.py:rmsnorm_residual_pallas`` (forward): one
pass over x and r writes the new residual stream ``s = x + r`` and the
normed ``y = rmsnorm(s) * scale``. It is bound by device-memory bytes
(read x and r, write s and y). With ``r=None`` it is a plain RMSNorm of x:
the kernel reads x and writes y only, and s is x itself.

On a CPU tensor it computes its plain version
(:func:`repro_torch.kernels.ref.rmsnorm_residual_ref`); on a CUDA tensor it
launches the kernel or raises. The kernel's limits: f32 or bf16 rows of
``d <= MAX_D`` features (a row is staged in shared memory).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"rmsnorm_residual": 0}
MAX_D = 8192

_SIGNATURES = {"rmsnorm_residual_fwd": [L.P] * 5 + [L.I, L.I, L.F, L.I, L.I,
                                                    L.P]}


def reset_launches() -> None:
    launches["rmsnorm_residual"] = 0


def rmsnorm_residual(x: Tensor, r: Optional[Tensor], scale: Tensor, *,
                     eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """x, r: (N, d); scale: (d,). Returns (y = rmsnorm(x + r) * scale,
    s = x + r), both (N, d) in x.dtype. ``r=None`` is a zero residual:
    y = rmsnorm(x) * scale and s is x."""
    if not x.is_cuda:
        return ref.rmsnorm_residual_ref(x, r, scale, eps)
    if x.dim() != 2:
        raise ValueError(f"x must be (N, d), got {tuple(x.shape)}")
    N, d = x.shape
    dev = x.device
    code = L.dtype_code("x", x)
    L.check("x", x, (N, d), dev)
    if r is not None:
        L.check("r", r, (N, d), dev, x.dtype)
    L.check("scale", scale, (d,), dev)
    if not 1 <= d <= MAX_D:
        raise ValueError(f"d={d}: the kernel takes 1 <= d <= {MAX_D}")
    L.check_index("N", N)
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
