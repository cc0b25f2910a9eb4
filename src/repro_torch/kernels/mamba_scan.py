"""Wrappers of the Hopper Mamba chunk-scan kernels (``csrc/mamba_scan.cu``).

``mamba_chunk`` replaces ``src/repro/kernels/mamba_scan.py:
mamba_chunk_pallas``: one chunk of the selective scan, one thread a
channel with its states in registers, walking the chunk in time order from
``h0``; it writes y and the last state, so chunks chain. Bound by the bytes
of x, dt and y and by one exp a (t, channel, state).

``mamba_chunk_backward`` replaces ``src/repro/kernels/mamba_scan.py:
mamba_chunk_backward_pallas``: the VJP w.r.t. all six inputs from the
cotangents of y and h_last. It recomputes the chunk's states on chip in
segments of 16 steps from checkpoints kept in shared memory (the
(B, c, di, ds) trajectory never reaches device memory) and sweeps each
segment in reverse; dB and dC are summed over channels in two fixed-order
stages through an f32 scratch (no atomics), and dA comes per batch row and
is summed over it here, as in the reference. Bound by bytes.

On a CPU tensor each computes its plain version
(:func:`repro_torch.kernels.ref.mamba_chunk_ref`,
:func:`~repro_torch.kernels.ref.mamba_chunk_backward_ref`); on a CUDA tensor
it launches the kernel or raises. The kernels' limits: xc, dt, Bm, Cm of
one dtype (f32 or bf16), A, h0 and the cotangents f32, every operand
contiguous, ``d_state <= MAX_D_STATE``, ``batch <= MAX_BATCH`` and, for the
backward, a chunk of at most ``MAX_BWD_CHUNK`` steps (its checkpoints live
in shared memory).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"mamba_chunk": 0, "mamba_chunk_backward": 0}
MAX_D_STATE = 16           # states of a channel held in registers
MAX_BATCH = 65535          # batch rows on gridDim.y
MAX_BWD_CHUNK = 2048       # ceil(c / 16) checkpoints a thread, shared memory
BWD_THREADS, BWD_GROUPS = 256, 8   # of csrc/mamba_scan.cu: a backward tile

_SIGNATURES = {
    "mamba_chunk_fwd": [L.P] * 8 + [L.I] * 5 + [L.P],
    "mamba_chunk_bwd": [L.P] * 15 + [L.I] * 6 + [L.P],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(xc: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor, A: Tensor,
           h0: Tensor) -> Tuple[int, int, int, int, int]:
    if xc.dim() != 3 or Bm.dim() != 3:
        raise ValueError(f"xc must be (B, c, di) and Bm (B, c, ds), got "
                         f"{tuple(xc.shape)} and {tuple(Bm.shape)}")
    B, c, di = xc.shape
    ds = Bm.shape[2]
    dev = xc.device
    code = L.dtype_code("xc", xc)
    L.check("xc", xc, (B, c, di), dev)
    L.check("dt", dt, (B, c, di), dev, xc.dtype)
    L.check("Bm", Bm, (B, c, ds), dev, xc.dtype)
    L.check("Cm", Cm, (B, c, ds), dev, xc.dtype)
    L.check("A", A, (di, ds), dev, torch.float32)
    L.check("h0", h0, (B, di, ds), dev, torch.float32)
    if not 1 <= ds <= MAX_D_STATE:
        raise ValueError(f"d_state={ds}: the kernels take 1 <= d_state <= "
                         f"{MAX_D_STATE}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"batch={B}: the kernels take 1 <= batch <= "
                         f"{MAX_BATCH}")
    if c < 1 or di < 1:
        raise ValueError(f"empty chunk: c={c}, d_inner={di}")
    L.check_index("c * d_inner", c * di)
    return B, c, di, ds, code


def mamba_chunk(xc: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor, A: Tensor,
                h0: Tensor) -> Tuple[Tensor, Tensor]:
    """xc, dt: (B, c, di); Bm, Cm: (B, c, ds); A: (di, ds); h0: (B, di, ds).
    Returns (y (B, c, di) f32, h_last (B, di, ds) f32)."""
    if not xc.is_cuda:
        return ref.mamba_chunk_ref(xc, dt, Bm, Cm, A, h0)
    B, c, di, ds, code = _check(xc, dt, Bm, Cm, A, h0)
    dev = xc.device
    y = torch.empty((B, c, di), device=dev, dtype=torch.float32)
    h_last = torch.empty((B, di, ds), device=dev, dtype=torch.float32)
    lib = L.bind("mamba_scan.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.mamba_chunk_fwd, xc.data_ptr(), dt.data_ptr(),
               Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(), h0.data_ptr(),
               y.data_ptr(), h_last.data_ptr(), B, c, di, ds, code,
               L.stream(dev))
    launches["mamba_chunk"] += 1
    return y, h_last


def bwd_tiles(di: int, ds: int) -> int:
    """Channel tiles of the backward (each writes a dB/dC partial row)."""
    per_tile = BWD_THREADS // (8 if ds <= 8 else 16) * BWD_GROUPS
    return -(-di // per_tile)


def mamba_chunk_backward(xc: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor,
                         A: Tensor, h0: Tensor, dy: Tensor, dh_last: Tensor
                         ) -> Tuple[Tensor, ...]:
    """VJP of :func:`mamba_chunk` w.r.t. all six inputs, from dy (B, c, di)
    and dh_last (B, di, ds), both f32. Returns (dxc, ddt, dB, dC, dA, dh0):
    dxc, ddt, dB, dC in the inputs' dtype, dA (di, ds) and dh0 f32."""
    if not xc.is_cuda:
        return ref.mamba_chunk_backward_ref(xc, dt, Bm, Cm, A, h0, dy,
                                            dh_last)
    B, c, di, ds, code = _check(xc, dt, Bm, Cm, A, h0)
    dev = xc.device
    L.check("dy", dy, (B, c, di), dev, torch.float32)
    L.check("dh_last", dh_last, (B, di, ds), dev, torch.float32)
    if c > MAX_BWD_CHUNK:
        raise ValueError(f"chunk {c}: the backward takes at most "
                         f"{MAX_BWD_CHUNK} steps")
    ntiles = bwd_tiles(di, ds)
    dxc = torch.empty_like(xc)
    ddt = torch.empty_like(dt)
    dB = torch.empty_like(Bm)
    dC = torch.empty_like(Cm)
    part = torch.empty((B, ntiles, c, 2, ds), device=dev,
                       dtype=torch.float32)
    dA_b = torch.empty((B, di, ds), device=dev, dtype=torch.float32)
    dh0 = torch.empty_like(h0)
    lib = L.bind("mamba_scan.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.mamba_chunk_bwd, xc.data_ptr(), dt.data_ptr(),
               Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(), h0.data_ptr(),
               dy.data_ptr(), dh_last.data_ptr(), dxc.data_ptr(),
               ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), part.data_ptr(),
               dA_b.data_ptr(), dh0.data_ptr(), B, c, di, ds, ntiles, code,
               L.stream(dev))
    launches["mamba_chunk_backward"] += 1
    # dA: each batch row's slice summed over the rows, as the reference
    return dxc, ddt, dB, dC, dA_b.sum(dim=0), dh0
