"""Wrappers of the Hopper Ghost-BatchNorm kernels (``csrc/gbn.cu``).

``gbn_forward`` replaces ``src/repro/kernels/gbn.py:gbn_forward_pallas``
(``_stats_kernel`` + ``_normalize_kernel``); ``gbn_backward`` replaces
``gbn_backward_pallas`` (``_bwd_stats_kernel`` + ``_bwd_dx_kernel``).

Both take f32 ``(G, R, C)`` activations and are bound by device-memory
bytes. The least they must move is 8·G·R·C bytes for the forward (read x,
write y) and 12·G·R·C for the backward (read x and dy, write dx). Each has
two bodies, and :func:`plan` picks one from (G, R, C), the SM count and the
shared-memory budget only:

- ``"persistent"`` (one kernel a call, after a memset of its counters): a
  co-resident grid of SMs × ``blocks_per_sm`` blocks in groups of P; each
  block stages its slice of a ghost's rows in shared memory once, the group
  meets at a per-ghost barrier inside the kernel, every block merges the P
  partials in index order and normalizes its staged rows. Each input is
  read from device memory once, as the bound counts.
- ``"two_pass"`` where a ghost's slices do not fit the grid's shared
  memory: statistics, merge and normalize kernels that read the inputs
  twice (3 kernels forward, 4 backward).

Neither pads: C stays at its width (16/32/64 on ResNet44) and the ragged
row edge is masked inside the kernels. The backward runs no PyTorch
arithmetic: rstd, the dx coefficients and the ghost sums of dgamma/dbeta
are computed in the kernels.

On a CPU tensor each wrapper computes its plain version
(:mod:`repro_torch.kernels.ref`); on a CUDA tensor it launches the kernels
or raises. ``launches`` counts the calls that launched a body.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"gbn_forward": 0, "gbn_backward": 0}

# the two-pass body: enough blocks to fill 132 SMs several times over; at
# most this many row steps per thread, so small ghosts still spread over
# many blocks
TARGET_BLOCKS = 1056
MAX_ITERS = 64
MAX_GHOSTS = 65535            # gridDim.y
MAX_CHANNEL_GROUPS = 1024     # one thread per channel group in a block

# the persistent body: an H100 SM's shared memory, which its blocks share
# (the runtime keeps 1 KB of it a block), and the most one block may take
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMEM_RESERVED = 1024
THREADS_PER_SM = 2048
MAX_SLOTS = 64
# its constants, from scripts/gbn_times.py --sweep (PERF.md): blocks an SM,
# slices a block's ring holds where it can, bytes of a sub-chunk an input
BLOCKS_PER_SM = 1
DEPTH = 1
SUB_BYTES = 16384


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@dataclass(frozen=True)
class Geometry:
    vec: int          # channels per thread: 4 (16-byte accesses) or 1
    threads: int      # threads per block
    chunk_rows: int   # rows per block of the two-pass body
    nchunks: int      # blocks per ghost of the two-pass body


def geometry(G: int, R: int, C: int, *, aligned: bool = True) -> Geometry:
    """Thread shape of both bodies and the two-pass body's chunks; raises
    past the kernels' limits."""
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


@dataclass(frozen=True)
class Plan:
    """A call's body and, for the persistent body, its launch: ``ngroups``
    groups of ``P`` blocks (``blocks_per_sm`` an SM); block p of group k
    owns rows [p·slice_rows, (p+1)·slice_rows) of ghosts k, k + ngroups,
    ..., staged as ``nsub`` sub-chunks of ``sub_rows`` rows through a ring
    of ``nslot`` slots of ``slot_floats`` floats an input."""
    body: str                 # "persistent" or "two_pass"
    geometry: Geometry
    blocks_per_sm: int = 0
    P: int = 0
    ngroups: int = 0
    slice_rows: int = 0
    sub_rows: int = 0
    nsub: int = 0
    nslot: int = 0
    slot_floats: int = 0
    smem_bytes: int = 0

    @property
    def grid(self) -> int:
        return self.P * self.ngroups


def smem_bytes(nslot: int, nin: int, slot_floats: int, C: int, threads: int,
               vec: int) -> int:
    """Dynamic shared memory of a persistent block, as ``csrc/gbn.cu``'s
    ``smem_bytes`` lays it out: the ring, its mbarriers, the per-thread
    sums, the merge's ranges and the merged per-channel values."""
    rest = threads * 2 * vec + 2 * max(C, threads) + 3 * C
    return 4 * nslot * nin * slot_floats + 8 * nslot + 4 * rest


def _ring(C: int, threads: int, vec: int, nin: int, blocks_per_sm: int,
          sub_rows: int) -> Tuple[int, int]:
    """(slot_floats, nslot): a slot holds sub_rows rows of an input and the
    up to 3 floats of an unaligned copy's lead; as many slots as the
    block's share of its SM's shared memory leaves room for."""
    budget = min(SMEM_PER_BLOCK, SMEM_PER_SM // blocks_per_sm - SMEM_RESERVED)
    slot_floats = -(-(sub_rows * C + 3) // 4) * 4
    free = budget - smem_bytes(0, nin, slot_floats, C, threads, vec)
    return slot_floats, max(0, min(MAX_SLOTS,
                                   free // (4 * nin * slot_floats + 8)))


def _fit_ring(C: int, geo: Geometry, nin: int, blocks_per_sm: int,
              sub_rows: int) -> Tuple[int, int, int]:
    """(blocks an SM, slot_floats, nslot): at most ``blocks_per_sm`` blocks
    an SM, fewer where the threads or one slot would not fit."""
    bps = max(1, min(blocks_per_sm, THREADS_PER_SM // geo.threads))
    while True:
        slot_floats, nslot = _ring(C, geo.threads, geo.vec, nin, bps,
                                   sub_rows)
        if nslot >= 1 or bps == 1:
            return bps, slot_floats, nslot
        bps -= 1


def ghost_rows_budget(C: int, sms: int, *, backward: bool,
                      aligned: bool = True,
                      blocks_per_sm: int = BLOCKS_PER_SM,
                      sub_bytes: int = SUB_BYTES) -> int:
    """The most rows a ghost of width C may have and take the persistent
    body: what the rings of all SMs × blocks_per_sm blocks hold (for R at
    least one sub-chunk; a ghost of one sub-chunk fits any ring that holds
    one slot)."""
    geo = geometry(1, 1, C, aligned=aligned)
    sub_rows = max(1, sub_bytes // (4 * C))
    bps, _, nslot = _fit_ring(C, geo, 2 if backward else 1, blocks_per_sm,
                              sub_rows)
    return sms * bps * nslot * sub_rows


@functools.lru_cache(maxsize=4096)
def plan(G: int, R: int, C: int, sms: int, *, backward: bool,
         aligned: bool = True, blocks_per_sm: int = BLOCKS_PER_SM,
         depth: int = DEPTH, sub_bytes: int = SUB_BYTES) -> Plan:
    """The body of a call on (G, R, C) f32 inputs with ``sms`` SMs, from the
    shape, the SM count and the shared-memory budget only; raises past both
    bodies' limits (:func:`geometry`).

    The persistent body takes a ghost whose rows fit the grid's rings
    (:func:`ghost_rows_budget`). Its groups are as many as leave each
    block's slice at most 1/``depth`` of its ring (else as many as fit),
    balanced over the G ghosts; each group then spreads a ghost over all of
    its blocks."""
    geo = geometry(G, R, C, aligned=aligned)
    nin = 2 if backward else 1
    sub_rows = max(1, min(R, sub_bytes // (4 * C)))
    bps, _, nslot = _fit_ring(C, geo, nin, blocks_per_sm, sub_rows)
    nblocks = sms * bps
    subs = -(-R // sub_rows)                     # sub-chunks of a ghost
    if nslot < 1 or -(-subs // nslot) > nblocks:
        return Plan("two_pass", geo)
    for d in range(max(1, depth), 0, -1):       # fewest blocks a ghost
        p_min = -(-subs // max(1, nslot // d))
        if p_min <= nblocks:
            break
    ngroups = min(G, nblocks // p_min)
    ngroups = -(-G // -(-G // ngroups))          # same rounds, balanced
    P = min(nblocks // ngroups, subs)
    slice_rows = -(-R // P)
    P = -(-R // slice_rows)
    nsub = -(-slice_rows // sub_rows)
    sub_rows = -(-slice_rows // nsub)
    slot_floats, nslot = _ring(C, geo.threads, geo.vec, nin, bps, sub_rows)
    return Plan("persistent", geo, bps, P, ngroups, slice_rows, sub_rows,
                nsub, nslot, slot_floats,
                smem_bytes(nslot, nin, slot_floats, C, geo.threads, geo.vec))


def two_pass(G: int, R: int, C: int, *, aligned: bool = True) -> Plan:
    """The two-pass body's plan at any shape the kernels take."""
    return Plan("two_pass", geometry(G, R, C, aligned=aligned))


def counter_ints(G: int) -> int:
    """Ints of a persistent call's counters (one a ghost, and the
    backward's count of finished groups), padded to 16 bytes."""
    return (G + 4) // 4 * 4


_LL = ctypes.c_longlong
_PLAN = [L.I] * 13 + [L.P]     # G, R, C, P, ngroups, ..., smem, stream
_TWO_PASS = [L.I] * 7 + [L.P]  # G, R, C, chunk_rows, nchunks, vec, threads
_SIGNATURES = {
    "gbn_fit": [L.I] * 4 + [ctypes.POINTER(ctypes.c_int)],
    "gbn_fwd_persistent": [L.P] * 3 + [L.F] + [L.P] * 4 + [_LL] + _PLAN,
    "gbn_bwd_persistent": [L.P] * 7 + [L.F] + [L.P] * 4 + [_LL] + _PLAN,
    "gbn_fwd_two_pass": [L.P] * 3 + [L.F] + [L.P] * 4 + [_LL] + _TWO_PASS,
    "gbn_bwd_two_pass": [L.P] * 7 + [L.F] + [L.P] * 4 + [_LL] + _TWO_PASS,
}


def _lib():
    return L.bind("gbn.cu", _SIGNATURES)


sm_count = L.sm_count


_fits: Dict[tuple, int] = {}


def _check_fit(lib, device: torch.device, p: Plan, backward: bool) -> None:
    """Sets the kernel's shared memory and checks, with the occupancy
    calculator, that an SM holds the plan's blocks (the cooperative launch
    would refuse the grid otherwise)."""
    g = p.geometry
    key = (device.index, backward, g.vec, g.threads, p.smem_bytes)
    if key not in _fits:
        per_sm = ctypes.c_int(0)
        L.call(lib.gbn_fit, int(backward), g.vec, g.threads, p.smem_bytes,
               ctypes.byref(per_sm))
        _fits[key] = per_sm.value
    if _fits[key] < p.blocks_per_sm:
        raise RuntimeError(
            f"an SM holds {_fits[key]} GBN blocks of {g.threads} threads and "
            f"{p.smem_bytes} bytes of shared memory; the plan needs "
            f"{p.blocks_per_sm}")


def _check(name: str, t: Tensor, shape: Tuple[int, ...],
           device: torch.device) -> None:
    L.check(name, t, shape, device, torch.float32)


def _plan_args(p: Plan, G: int, R: int, C: int, device: torch.device):
    g = p.geometry
    return (G, R, C, p.P, p.ngroups, p.slice_rows, p.sub_rows, p.nsub,
            p.nslot, p.slot_floats, g.vec, g.threads, p.smem_bytes,
            L.stream(device))


def _two_pass_args(p: Plan, G: int, R: int, C: int, device: torch.device):
    g = p.geometry
    return (G, R, C, g.chunk_rows, g.nchunks, g.vec, g.threads,
            L.stream(device))


def gbn_forward(xg: Tensor, gamma: Tensor, beta: Tensor, *,
                eps: float = 1e-5) -> Tuple[Tensor, Tensor, Tensor]:
    """xg (G, R, C) -> (y (G, R, C), mu (G, C), biased var (G, C))."""
    if not xg.is_cuda:
        return ref.gbn_ref(xg, gamma, beta, eps=eps)
    G, R, C = xg.shape
    p = plan(G, R, C, sm_count(xg.device.index), backward=False,
             aligned=L.aligned(xg))
    return forward_with(p, xg, gamma, beta, eps=eps)


def forward_with(p: Plan, xg: Tensor, gamma: Tensor, beta: Tensor, *,
                 eps: float = 1e-5) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`gbn_forward` on CUDA tensors through the body of plan ``p``
    (``gbn_forward``'s own plan, or another at the same shape)."""
    G, R, C = xg.shape
    dev = xg.device
    _check("xg", xg, (G, R, C), dev)
    _check("gamma", gamma, (C,), dev)
    _check("beta", beta, (C,), dev)
    if p.geometry.vec == 4 and not L.aligned(xg):
        raise ValueError("the plan's 16-byte accesses need an aligned xg")
    y = torch.empty_like(xg)
    mu = torch.empty((G, C), device=dev, dtype=torch.float32)
    var = torch.empty_like(mu)
    lib = _lib()
    ins = (xg.data_ptr(), gamma.data_ptr(), beta.data_ptr(), eps,
           y.data_ptr(), mu.data_ptr(), var.data_ptr())
    with torch.cuda.device(dev):
        if p.body == "persistent":
            _check_fit(lib, dev, p, backward=False)
            scratch = torch.empty(counter_ints(G) + 2 * G * p.P * C,
                                  device=dev, dtype=torch.float32)
            L.call(lib.gbn_fwd_persistent, *ins, scratch.data_ptr(),
                   scratch.numel(), *_plan_args(p, G, R, C, dev))
        else:
            scratch = torch.empty(2 * G * p.geometry.nchunks * C,
                                  device=dev, dtype=torch.float32)
            L.call(lib.gbn_fwd_two_pass, *ins, scratch.data_ptr(),
                   scratch.numel(), *_two_pass_args(p, G, R, C, dev))
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
    p = plan(G, R, C, sm_count(xg.device.index), backward=True,
             aligned=L.aligned(xg, dy))
    return backward_with(p, xg, gamma, mu, var, dy, dmu, dvar, eps=eps)


def backward_with(p: Plan, xg: Tensor, gamma: Tensor, mu: Tensor,
                  var: Tensor, dy: Tensor, dmu: Tensor, dvar: Tensor, *,
                  eps: float = 1e-5) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`gbn_backward` on CUDA tensors through the body of plan
    ``p``."""
    G, R, C = xg.shape
    dev = xg.device
    _check("xg", xg, (G, R, C), dev)
    _check("dy", dy, (G, R, C), dev)
    _check("gamma", gamma, (C,), dev)
    for name, t in (("mu", mu), ("var", var), ("dmu", dmu), ("dvar", dvar)):
        _check(name, t, (G, C), dev)
    if p.geometry.vec == 4 and not L.aligned(xg, dy):
        raise ValueError("the plan's 16-byte accesses need aligned xg, dy")
    dx = torch.empty_like(xg)
    dgamma = torch.empty((C,), device=dev, dtype=torch.float32)
    dbeta = torch.empty_like(dgamma)
    lib = _lib()
    ins = (xg.data_ptr(), dy.data_ptr(), gamma.data_ptr(), mu.data_ptr(),
           var.data_ptr(), dmu.data_ptr(), dvar.data_ptr(), eps,
           dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr())
    with torch.cuda.device(dev):
        if p.body == "persistent":
            _check_fit(lib, dev, p, backward=True)
            scratch = torch.empty(counter_ints(G) + 2 * G * (p.P + 1) * C,
                                  device=dev, dtype=torch.float32)
            L.call(lib.gbn_bwd_persistent, *ins, scratch.data_ptr(),
                   scratch.numel(), *_plan_args(p, G, R, C, dev))
        else:
            scratch = torch.empty(
                2 * G * p.geometry.nchunks * C + 5 * G * C, device=dev,
                dtype=torch.float32)
            L.call(lib.gbn_bwd_two_pass, *ins, scratch.data_ptr(),
                   scratch.numel(), *_two_pass_args(p, G, R, C, dev))
    launches["gbn_backward"] += 1
    return dx, dgamma, dbeta

