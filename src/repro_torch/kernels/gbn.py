"""Wrappers of the Hopper Ghost-BatchNorm kernels (``csrc/gbn.cu``).

``gbn_forward`` replaces ``src/repro/kernels/gbn.py:gbn_forward_pallas``
(``_stats_kernel`` + ``_normalize_kernel``); ``gbn_backward`` replaces
``gbn_backward_pallas`` (``_bwd_stats_kernel`` + ``_bwd_dx_kernel``).

Both take f32 ``(G, R, C)`` activations and are bound by device-memory
bytes. The least they must move is 8·G·R·C bytes for the forward (read x,
write y) and 12·G·R·C for the backward (read x and dy, write dx); the kernels
read x (and dy) once more for the statistics pass, as the Pallas kernels do.
Unlike the Pallas kernels they pad nothing: C stays at its width (16/32/64
on ResNet44, where padding to 128 lanes would move 8x the bytes) and the
ragged row edge is masked inside the kernel.

On a CPU tensor each wrapper computes its plain version
(:mod:`repro_torch.kernels.ref`); on a CUDA tensor it launches the kernels
or raises. ``launches`` counts the kernel launches of each wrapper.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"gbn_forward": 0, "gbn_backward": 0}

# enough blocks to fill 132 SMs several times over; at most this many row
# steps per thread, so small ghosts still spread over many blocks
TARGET_BLOCKS = 1056
MAX_ITERS = 64
MAX_GHOSTS = 65535            # gridDim.y
MAX_CHANNEL_GROUPS = 1024     # one thread per channel group in a block


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@dataclass(frozen=True)
class Geometry:
    vec: int          # channels per thread: 4 (16-byte loads) or 1
    threads: int      # threads per block
    chunk_rows: int   # rows per block
    nchunks: int      # blocks per ghost


def geometry(G: int, R: int, C: int, *, aligned: bool = True) -> Geometry:
    """Launch shape shared by all GBN kernels; raises past their limits."""
    if G < 1 or R < 1 or C < 1:
        raise ValueError(f"empty GBN input (G, R, C) = {(G, R, C)}")
    if G > MAX_GHOSTS:
        raise ValueError(f"G={G} ghosts exceeds the grid limit {MAX_GHOSTS}")
    if R >= 2 ** 31 or G * C >= 2 ** 31:
        raise ValueError(f"GBN input {(G, R, C)} exceeds 32-bit row or "
                         f"(ghost, channel) indexing")
    vec = 4 if (C % 4 == 0 and aligned) else 1
    cv = C // vec
    if cv > MAX_CHANNEL_GROUPS:
        raise ValueError(f"C={C} needs {cv} channel groups per block; the "
                         f"kernels take at most {MAX_CHANNEL_GROUPS}")
    threads = 256 if cv <= 256 else (512 if cv <= 512 else 1024)
    lanes = threads // cv
    want_chunks = -(-TARGET_BLOCKS // G)
    iters = max(1, min(MAX_ITERS, -(-R // (lanes * want_chunks))))
    chunk_rows = lanes * iters
    return Geometry(vec, threads, chunk_rows, -(-R // chunk_rows))


_GEOM = [L.I] * 7 + [L.P]    # G, R, C, chunk_rows, nchunks, vec, threads, stream
_SIGNATURES = {
    "gbn_fwd_stats": [L.P] * 5 + _GEOM,
    "gbn_normalize": [L.P] * 5 + [L.F, L.P] + _GEOM,
    "gbn_bwd_stats": [L.P] * 8 + _GEOM,
    "gbn_bwd_dx": [L.P] * 7 + _GEOM,
}


def _lib():
    return L.bind("gbn.cu", _SIGNATURES)


def _check(name: str, t: Tensor, shape: Tuple[int, ...],
           device: torch.device) -> None:
    L.check(name, t, shape, device, torch.float32)


def _launch_args(g: Geometry, G: int, R: int, C: int, device: torch.device):
    return (G, R, C, g.chunk_rows, g.nchunks, g.vec, g.threads,
            L.stream(device))


def gbn_forward(xg: Tensor, gamma: Tensor, beta: Tensor, *,
                eps: float = 1e-5) -> Tuple[Tensor, Tensor, Tensor]:
    """xg (G, R, C) -> (y (G, R, C), mu (G, C), biased var (G, C))."""
    if not xg.is_cuda:
        return ref.gbn_ref(xg, gamma, beta, eps=eps)
    G, R, C = xg.shape
    dev = xg.device
    _check("xg", xg, (G, R, C), dev)
    _check("gamma", gamma, (C,), dev)
    _check("beta", beta, (C,), dev)
    g = geometry(G, R, C, aligned=L.aligned(xg))
    y = torch.empty_like(xg)
    mu = torch.empty((G, C), device=dev, dtype=torch.float32)
    var = torch.empty_like(mu)
    pmean = torch.empty((G, g.nchunks, C), device=dev, dtype=torch.float32)
    pm2 = torch.empty_like(pmean)
    lib = _lib()
    with torch.cuda.device(dev):
        tail = _launch_args(g, G, R, C, dev)
        L.call(lib.gbn_fwd_stats, xg.data_ptr(), pmean.data_ptr(),
              pm2.data_ptr(), mu.data_ptr(), var.data_ptr(), *tail)
        L.call(lib.gbn_normalize, xg.data_ptr(), mu.data_ptr(),
              var.data_ptr(), gamma.data_ptr(), beta.data_ptr(), eps,
              y.data_ptr(), *tail)
    launches["gbn_forward"] += 1
    return y, mu, var


def gbn_backward(xg: Tensor, gamma: Tensor, mu: Tensor, var: Tensor,
                 dy: Tensor, dmu: Tensor, dvar: Tensor, *,
                 eps: float = 1e-5) -> Tuple[Tensor, Tensor, Tensor]:
    """VJP of :func:`gbn_forward` w.r.t. (xg, gamma, beta), given the saved
    (mu, var) and the cotangents of all three outputs. Returns
    (dx (G, R, C), dgamma (C,), dbeta (C,))."""
    if not xg.is_cuda:
        return ref.gbn_backward_ref(xg, gamma, mu, var, dy, dmu, dvar,
                                    eps=eps)
    G, R, C = xg.shape
    dev = xg.device
    _check("xg", xg, (G, R, C), dev)
    _check("dy", dy, (G, R, C), dev)
    _check("gamma", gamma, (C,), dev)
    for name, t in (("mu", mu), ("var", var), ("dmu", dmu), ("dvar", dvar)):
        _check(name, t, (G, C), dev)
    g = geometry(G, R, C, aligned=L.aligned(xg, dy))
    rstd = torch.rsqrt(var + eps)
    sdy = torch.empty((G, C), device=dev, dtype=torch.float32)
    sdyxh = torch.empty_like(sdy)
    psdy = torch.empty((G, g.nchunks, C), device=dev, dtype=torch.float32)
    psdyxh = torch.empty_like(psdy)
    dx = torch.empty_like(xg)
    lib = _lib()
    with torch.cuda.device(dev):
        tail = _launch_args(g, G, R, C, dev)
        L.call(lib.gbn_bwd_stats, xg.data_ptr(), dy.data_ptr(), mu.data_ptr(),
              rstd.data_ptr(), psdy.data_ptr(), psdyxh.data_ptr(),
              sdy.data_ptr(), sdyxh.data_ptr(), *tail)
        # (G, C) glue, as the JAX package keeps it outside Pallas: fold the
        # sums and the live mu/var cotangents into the dx coefficients
        gvar = dvar - 0.5 * gamma * rstd * rstd * sdyxh
        gmu = dmu - gamma * rstd * sdy
        c1 = (gamma * rstd).contiguous()
        c2 = (2.0 * gvar / R).contiguous()
        c3 = (gmu / R).contiguous()
        L.call(lib.gbn_bwd_dx, xg.data_ptr(), dy.data_ptr(), mu.data_ptr(),
              c1.data_ptr(), c2.data_ptr(), c3.data_ptr(), dx.data_ptr(),
              *tail)
    launches["gbn_backward"] += 1
    return dx, sdyxh.sum(dim=0), sdy.sum(dim=0)
