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

Both run on row teams (see ``csrc/rmsnorm_residual.cu``): a row belongs to
a team of 1, 2, 4 or 8 warps that holds it in registers, K 16-byte chunks
a thread, and reduces it in an order fixed by ``d`` and the element size
(:func:`team`), so a row's result is the same bits in any batch. The
launch, team, teams a block and grid, is :func:`plan`, a pure function of
``(N, d)``, the element size and the SM count.

On a CPU tensor each computes its plain version
(:func:`repro_torch.kernels.ref.rmsnorm_residual_ref`,
:func:`~repro_torch.kernels.ref.rmsnorm_residual_backward_ref`); on a CUDA
tensor it launches the kernel or raises. The kernels' limits: f32 or bf16
rows of ``d <= MAX_D`` features.
"""
from __future__ import annotations

import functools
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"rmsnorm_residual": 0,
                            "rmsnorm_residual_backward": 0}
MAX_D = 8192

THREADS = 256                 # threads of a block at most (csrc kThreads)
WARPS = (1, 2, 4, 8)          # warps a team
# the most chunks a thread holds before a team takes more warps, from
# scripts/norm_times.py on the card (PERF.md): at 2 the decode-sized calls
# match the one-block-a-row kernel's latency and 4096-row calls are within
# 1-2 % of the best team
KMAX = {False: 2, True: 2}
REGS_PER_SM = 65536
MAX_REGS = 255                # a thread
SMEM_PER_BLOCK = 48 * 1024    # static and dynamic, without opting in


def _csrc_ints(name: str) -> Tuple[int, ...]:
    """The literal ints of ``constexpr int name`` (or ``name[n]``) in
    ``csrc/rmsnorm_residual.cu``, where the launch policy lives."""
    m = re.search(rf"constexpr int {name}(?:\[\d+\])? = \{{?([\d,\s]+)\}}?;",
                  (build.CSRC / "rmsnorm_residual.cu").read_text())
    return tuple(int(v) for v in m.group(1).split(","))


# the blocks an SM must hold at each compiled K (chunks a thread), the rows
# kernels' __launch_bounds__, which cap their registers; the stream body's,
# and the dynamic shared memory a stream block may take
MIN_BLOCKS = {bwd: {k: b for k, b in enumerate(_csrc_ints(name)) if b}
              for bwd, name in ((False, "kFwdMinBlocks"),
                                (True, "kBwdMinBlocks"))}
PER_LANE = {bwd: tuple(bs) for bwd, bs in MIN_BLOCKS.items()}
STREAM_MIN_BLOCKS, = _csrc_ints("kStreamMinBlocks")
STREAM_SMEM_MAX, = _csrc_ints("kStreamSmemMax")


@dataclass(frozen=True)
class Plan:
    body: str             # "rows" (a row in registers) or "stream"
    vec: int              # elements a 16-byte chunk
    warps: int            # warps a team
    per_lane: int         # chunks a thread holds (K; stream: chunks it walks)
    teams_per_block: int
    blocks: int           # the grid; the backward's dscale partials
    blocks_per_sm: int    # as the kernel's register cap guarantees
    regs: int             # the register cap a thread
    smem_bytes: int       # dynamic shared memory a block (backward)

    @property
    def threads(self) -> int:
        return 32 * self.warps * self.teams_per_block

    @property
    def teams(self) -> int:
        """Teams of the grid: team g takes rows g, g + teams, ..."""
        return self.blocks * self.teams_per_block


def team(d: int, itemsize: int, *, backward: bool) -> Tuple[str, int, int]:
    """(body, warps, chunks a thread) of a row of ``d`` elements of
    ``itemsize`` bytes: the fewest warps (1, 2, 4, 8) whose threads hold
    the row's ceil(d / V) 16-byte chunks at most ``KMAX`` a thread, else 8
    warps; at the least compiled K that covers the row. A backward row past 8 warps x 4 chunks takes the stream body
    (one team of 8 warps, two passes). Depends on d and the element size
    only."""
    chunks = -(-d // (16 // itemsize))
    ks = PER_LANE[backward]
    w = next((w for w in WARPS if -(-chunks // (32 * w)) <= KMAX[backward]),
             WARPS[-1])
    need = -(-chunks // (32 * w))
    if need <= ks[-1]:
        return "rows", w, min(k for k in ks if k >= need)
    if not backward:
        raise ValueError(f"d={d}: no forward team holds the row")
    return "stream", w, need


@functools.lru_cache(maxsize=4096)
def plan(N: int, d: int, sms: int, *, backward: bool, itemsize: int = 2
         ) -> Plan:
    """The launch of a call on (N, d) rows of ``itemsize`` bytes with
    ``sms`` SMs. The team comes from :func:`team` (d only); a block holds
    256 / (32 warps) teams, fewer when N is below that many times the SM
    count (few rows then spread over many SMs); the grid is the fewest
    blocks that give every row a team, at most ``sms`` times the blocks an
    SM holds at the kernel's register cap."""
    body, w, k = team(d, itemsize, backward=backward)
    if body == "stream":
        tpb, bps = 1, STREAM_MIN_BLOCKS
    else:
        tpb = max(1, min(THREADS // (32 * w), -(-N // sms)))
        bps = MIN_BLOCKS[backward][k]
    blocks = max(1, min(-(-N // tpb), sms * bps))
    regs = min(MAX_REGS, REGS_PER_SM // (THREADS * bps))
    V = 16 // itemsize
    chunks = -(-d // V)
    smem = (0 if not backward else 4 * d if body == "rows"
            else 2 * 16 * chunks + 4 * V * chunks)  # s, dy slots; partial
    return Plan(body, V, w, k, tpb, blocks, bps, regs, smem)


_SIGNATURES = {
    "rmsnorm_residual_fwd": [L.P] * 5 + [L.I, L.I, L.F] + [L.I] * 6 + [L.P],
    "rmsnorm_residual_bwd": [L.P] * 7 + [L.I, L.I, L.F] + [L.I] * 8 + [L.P],
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
    vec = int(d % (16 // x.element_size()) == 0 and L.aligned(
        *(t for t in (x, r, y, s, scale32) if t is not None)))
    p = plan(N, d, L.sm_count(dev.index), backward=False,
             itemsize=x.element_size())
    lib = L.bind("rmsnorm_residual.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.rmsnorm_residual_fwd, x.data_ptr(), L.ptr(r),
               scale32.data_ptr(), y.data_ptr(),
               None if r is None else s.data_ptr(), N, d, float(eps), code,
               vec, p.warps, p.per_lane, p.blocks, p.threads, L.stream(dev))
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
    p = plan(N, d, L.sm_count(dev.index), backward=True,
             itemsize=s.element_size())
    dx = torch.empty_like(s)
    partial = torch.empty((p.blocks, d), device=dev, dtype=torch.float32)
    dscale = torch.empty((d,), device=dev, dtype=torch.float32)
    vec = int(d % (16 // s.element_size()) == 0 and L.aligned(
        *(t for t in (s, dy, ds, dx, scale32) if t is not None)))
    lib = L.bind("rmsnorm_residual.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.rmsnorm_residual_bwd, s.data_ptr(), scale32.data_ptr(),
               dy.data_ptr(), L.ptr(ds), dx.data_ptr(), partial.data_ptr(),
               dscale.data_ptr(), N, d, float(eps), code, vec,
               int(p.body == "stream"), p.warps, p.per_lane, p.blocks,
               p.threads, p.smem_bytes, L.stream(dev))
    launches["rmsnorm_residual_backward"] += 1
    return dx, dscale
