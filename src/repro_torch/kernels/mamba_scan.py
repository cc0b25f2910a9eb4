"""Wrappers of the Hopper Mamba chunk-scan kernels (``csrc/mamba_scan.cu``).

``mamba_chunk`` replaces ``src/repro/kernels/mamba_scan.py:
mamba_chunk_pallas``: one chunk of the selective scan, walking the chunk in
time order from ``h0`` with Q states of a channel a thread; it writes y and
the last state, so chunks chain. Bound by one exp a (t, channel, state) and
by the bytes of x, dt and y. One kernel a call.

``mamba_chunk_backward`` replaces ``src/repro/kernels/mamba_scan.py:
mamba_chunk_backward_pallas``: the VJP w.r.t. all six inputs from the
cotangents of y and h_last. It recomputes the chunk's states on chip in
segments from checkpoints (the (B, c, di, ds) trajectory never reaches
device memory) and sweeps each segment in reverse; dB and dC are summed
over channels in fixed orders (a butterfly within a warp, warps in order,
then the channel tiles in order by a second kernel; no atomics), and dA
comes per batch row and is summed over it here, as in the reference. Bound
by bytes. Two kernels and the dA sum a call.

The kernels work out a call's launch from the shape and their built
constants alone (``csrc/mamba_scan.cu:Plan``); :func:`plan` reports it. On a
CPU tensor each wrapper computes its plain version
(:func:`repro_torch.kernels.ref.mamba_chunk_ref`,
:func:`~repro_torch.kernels.ref.mamba_chunk_backward_ref`); on a CUDA tensor
it launches the kernels or raises. The kernels' limits: xc, dt, Bm, Cm of
one dtype (f32 or bf16), A, h0 and the cotangents f32, every operand
contiguous, ``d_state <= MAX_D_STATE``, ``batch <= MAX_BATCH`` and, for the
backward, a chunk of at most ``MAX_BWD_CHUNK`` steps.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"mamba_chunk": 0, "mamba_chunk_backward": 0}
MAX_D_STATE = 16           # states of a channel, padded to 8 or 16
MAX_BATCH = 65535          # batch rows on gridDim.y
MAX_BWD_CHUNK = 2048       # steps of a backward chunk

_CONSTANTS = ("kQFwd", "kQBwd", "kSeg", "kTile", "kStages", "kFwdThreads",
              "kBwdThreads", "kFwdBlocks", "kBwdBlocks", "kSmemBudget")
_PLAN = ("DS", "q", "lanes", "threads", "channels", "tiles", "steps", "nseg",
         "stages", "ckpt_smem", "smem_bytes")
_SIGNATURES = {
    "mamba_scan_constants": [ctypes.POINTER(ctypes.c_int)],
    "mamba_scan_plan": [L.I] * 6 + [ctypes.POINTER(ctypes.c_int)],
    "mamba_chunk_fwd": [L.P] * 8 + [L.I] * 5 + [L.P],
    "mamba_chunk_bwd": [L.P] * 16 + [L.I] * 5 + [L.P],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclass(frozen=True)
class Plan:
    """One call's launch: a grid of (tiles, batch) blocks of ``threads``
    threads; a thread owns ``q`` of a channel's ``DS`` (padded) states, so
    a channel spans ``lanes`` lanes and a block ``channels`` channels. The
    chunk is walked in ``nseg`` tiles (forward) or segments (backward) of
    ``steps`` steps through a ring of ``stages`` slots; the backward keeps
    its checkpoints in shared memory (``ckpt == "smem"``) or in a device
    scratch (``"scratch"``); a block takes ``smem_bytes``."""
    backward: bool
    DS: int
    q: int
    lanes: int
    threads: int
    channels: int
    grid: Tuple[int, int]
    steps: int
    nseg: int
    stages: int
    ckpt: str
    smem_bytes: int


def check_shape(B: int, c: int, di: int, ds: int, backward: bool) -> None:
    if not 1 <= ds <= MAX_D_STATE:
        raise ValueError(f"d_state={ds}: the kernels take 1 <= d_state <= "
                         f"{MAX_D_STATE}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"batch={B}: the kernels take 1 <= batch <= "
                         f"{MAX_BATCH}")
    if c < 1 or di < 1:
        raise ValueError(f"empty chunk: c={c}, d_inner={di}")
    L.check_index("c * d_inner", c * di)
    if backward and c > MAX_BWD_CHUNK:
        raise ValueError(f"chunk {c}: the backward takes at most "
                         f"{MAX_BWD_CHUNK} steps")


def plan(B: int, c: int, di: int, ds: int, *, backward: bool,
         dtype: torch.dtype = torch.float32) -> Plan:
    """The launch the built kernels pick for a call on (B, c, di, ds)
    inputs of ``dtype``; raises past the kernels' limits. Asked of the
    library, which builds it from the shape and its constants only."""
    check_shape(B, c, di, ds, backward)
    out = (ctypes.c_int * len(_PLAN))()
    L.call(_lib().mamba_scan_plan, B, c, di, ds,
           L.DTYPES[dtype], int(backward), out)
    f = dict(zip(_PLAN, out))
    in_smem, tiles = f.pop("ckpt_smem"), f.pop("tiles")
    ckpt = ("smem" if in_smem else "scratch") if backward else ""
    return Plan(backward=backward, grid=(tiles, B), ckpt=ckpt, **f)


def built_constants() -> Dict[str, int]:
    """The constants of the loaded library."""
    out = (ctypes.c_int * len(_CONSTANTS))()
    L.call(_lib().mamba_scan_constants, out)
    return dict(zip(_CONSTANTS, out))


def _lib():
    return L.bind("mamba_scan.cu", _SIGNATURES)


def _check(xc: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor, A: Tensor,
           h0: Tensor, backward: bool = False
           ) -> Tuple[int, int, int, int, int]:
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
    check_shape(B, c, di, ds, backward)
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
    with torch.cuda.device(dev):
        L.call(_lib().mamba_chunk_fwd, xc.data_ptr(), dt.data_ptr(),
               Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(), h0.data_ptr(),
               y.data_ptr(), h_last.data_ptr(), B, c, di, ds, code,
               L.stream(dev))
    launches["mamba_chunk"] += 1
    return y, h_last


def mamba_chunk_backward(xc: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor,
                         A: Tensor, h0: Tensor, dy: Tensor, dh_last: Tensor
                         ) -> Tuple[Tensor, ...]:
    """VJP of :func:`mamba_chunk` w.r.t. all six inputs, from dy (B, c, di)
    and dh_last (B, di, ds), both f32. Returns (dxc, ddt, dB, dC, dA, dh0):
    dxc, ddt, dB, dC in the inputs' dtype, dA (di, ds) and dh0 f32."""
    if not xc.is_cuda:
        return ref.mamba_chunk_backward_ref(xc, dt, Bm, Cm, A, h0, dy,
                                            dh_last)
    B, c, di, ds, code = _check(xc, dt, Bm, Cm, A, h0, backward=True)
    dev = xc.device
    L.check("dy", dy, (B, c, di), dev, torch.float32)
    L.check("dh_last", dh_last, (B, di, ds), dev, torch.float32)
    # the scratch the kernels' plan needs: a partial dB/dC row a channel
    # tile, and the checkpoints where they do not fit shared memory
    p = plan(B, c, di, ds, backward=True, dtype=xc.dtype)
    ntiles = p.grid[0]
    dxc = torch.empty_like(xc)
    ddt = torch.empty_like(dt)
    dB = torch.empty_like(Bm)
    dC = torch.empty_like(Cm)
    part = torch.empty((B, ntiles, c, 2, ds), device=dev,
                       dtype=torch.float32)
    ckpt = None if p.ckpt == "smem" else torch.empty(
        (B, p.nseg, di, ds), device=dev, dtype=torch.float32)
    dA_b = torch.empty((B, di, ds), device=dev, dtype=torch.float32)
    dh0 = torch.empty_like(h0)
    with torch.cuda.device(dev):
        L.call(_lib().mamba_chunk_bwd, xc.data_ptr(), dt.data_ptr(),
               Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(), h0.data_ptr(),
               dy.data_ptr(), dh_last.data_ptr(), dxc.data_ptr(),
               ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), part.data_ptr(),
               L.ptr(ckpt), dA_b.data_ptr(), dh0.data_ptr(), B, c, di, ds,
               code, L.stream(dev))
    launches["mamba_chunk_backward"] += 1
    # dA: each batch row's slice summed over the rows, as the reference
    return dxc, ddt, dB, dC, dA_b.sum(dim=0), dh0
