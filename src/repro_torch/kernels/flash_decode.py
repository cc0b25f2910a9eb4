"""Wrappers of the Hopper flash decode kernels (``csrc/flash_decode.cu``
and ``csrc/flash_decode_paged.cu``, one body in ``csrc/flash_decode.cuh``).

``flash_decode`` replaces
``src/repro/kernels/flash_decode.py:flash_decode_pallas``: one query row
per sequence against a head-major (B, KV, S, hd) cache, with per-row
``pos`` and left-pad ``offsets``, a ring-buffer or windowed cache and the
query's RoPE rotation (by ``pos - offset``) fused in. Slot visibility is
:func:`slot_visibility`, the predicate the kernel evaluates per slot. It
is bound by the bytes of the visible cache.

Both kernels split a row's slots into chunks of :func:`chunk_slots`
consecutive logical slots; a cluster of 8 blocks per (kv head, row) takes
them in turn (rank r the chunks r, r + 8, ...) and rank 0 merges the
blocks' partial softmaxes in rank order. The chunks depend only
on ``hd`` and the cache's element size, so a row's output does not depend
on the batch, on the cache's length past ``pos`` or on the cache's layout.
A row that sees no slot is the mean of V over every slot (the S slots, or
the ``NB * ps`` logical slots of a paged row), as the reference's oracle
gives it; only such a row depends on the cache's length.

``pos`` is an int (every row at one depth), a 0-d tensor or a per-row
(B,) tensor; a tensor is read by the kernel on the device, never on the
host. On a CPU tensor the wrapper computes its plain version
(:func:`repro_torch.kernels.ref.flash_decode_ref`); on a CUDA tensor it
launches the kernel or raises. The kernel's limits: q, k, v of one dtype
(f32 or bf16), contiguous, ``hd`` in ``HEAD_DIMS``, a GQA group
``H // KV`` in ``GROUPS`` with ``(H // KV) * hd <= MAX_GROUP_WIDTH``, k and v
16-byte aligned (the kernel copies 16-byte units; an int8 pool of width
120, whose rows are 120 bytes, 8-byte ones).

``flash_decode_paged`` replaces
``src/repro/kernels/flash_decode.py:flash_decode_paged_pallas``: the same
decode against a page pool ``(pages, KV, ps, hd)`` reached through per-row
block tables ``pt (B, NB)``, bf16/f32 or int8 codes with per-slot f32
scales (dequantized in f32). It takes the chunks as ``flash_decode``
does, so on the same cache contents the two agree bit for bit. Its plain
version is :func:`repro_torch.kernels.ref.flash_decode_paged_ref`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref
from repro_torch.kernels.ref import slot_visibility  # noqa: F401 (re-export)

Tensor = torch.Tensor

launches: Dict[str, int] = {"flash_decode": 0, "flash_decode_paged": 0}
HEAD_DIMS = (32, 64, 112, 120, 128, 256)
GROUPS = (1, 2, 4, 8, 16)
MAX_GROUP_WIDTH = 1024

_SIGNATURES = {"flash_decode_fwd": [L.P] * 5 + [L.I, L.P] + [L.I] * 8
               + [L.F, L.F, L.I, L.P],
               "flash_decode_chunk_slots": [L.I, L.I]}
_PAGED_SIGNATURES = {"flash_decode_paged_fwd": [L.P] * 8 + [L.I, L.P]
                     + [L.I] * 8 + [L.F, L.F, L.I, L.I, L.P]}


def chunk_slots(hd: int, itemsize: int) -> int:
    """Slots of the kernels' chunk for a cache of ``hd``-wide rows of
    ``itemsize`` bytes: ``Chunk::SLOTS`` of csrc/flash_decode.cuh, asked of
    the built library (so it needs the CUDA toolkit)."""
    n = L.bind("flash_decode.cu", _SIGNATURES).flash_decode_chunk_slots(
        hd, itemsize)
    if n == 0:
        raise ValueError(f"hd={hd}, itemsize={itemsize}: the kernels take "
                         f"hd in {HEAD_DIMS} and 1, 2 or 4 bytes")
    return n


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_group(H: int, KV: int, hd: int) -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim={hd}: the kernel takes {HEAD_DIMS}")
    if H % KV or H // KV not in GROUPS \
            or (H // KV) * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"H={H}, KV={KV}, hd={hd}: the kernel takes a GQA "
                         f"group in {GROUPS} with group * hd <= "
                         f"{MAX_GROUP_WIDTH}")
    if KV > 65535:
        raise ValueError(f"KV={KV}: the grid takes at most 65535")


def _rows(pos: Union[int, Tensor], offsets: Optional[Tensor], B: int,
          dev: torch.device, window: Optional[int]):
    """(pos_rows (B,) int32 or None, pos_scalar, offsets int32 or None,
    window as an int, 0 for none), checked."""
    if B > 65535:
        raise ValueError(f"B={B}: the grid takes at most 65535")
    pos_rows, pos_scalar = None, 0
    if isinstance(pos, Tensor):
        if pos.device != dev or pos.numel() not in (1, B) or pos.dim() > 1:
            raise ValueError(f"pos must be a scalar or ({B},) on {dev}")
        pos_rows = pos.to(torch.int32).reshape(-1).expand(B).contiguous()
    else:
        pos_scalar = int(pos)
    offs = None
    if offsets is not None:
        if offsets.device != dev or offsets.shape != (B,):
            raise ValueError(f"offsets must be ({B},) on {dev}")
        offs = offsets.to(torch.int32).contiguous()
    w = 0 if window is None else int(window)
    if window is not None and w < 1:
        raise ValueError(f"window={window} must be >= 1")
    return pos_rows, pos_scalar, offs, w


def flash_decode(q: Tensor, k: Tensor, v: Tensor, pos: Union[int, Tensor],
                 *, window: Optional[int] = None, ring: bool = False,
                 offsets: Optional[Tensor] = None,
                 rope_theta: Optional[float] = None) -> Tensor:
    """q: (B, H, hd); k, v: (B, KV, S, hd) -> (B, H, hd) in q.dtype."""
    if not q.is_cuda:
        return ref.flash_decode_ref(q, k, v, pos, window=window, ring=ring,
                                    offsets=offsets, rope_theta=rope_theta)
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B, H, hd) and k (B, KV, S, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    dev = q.device
    code = L.dtype_code("q", q)
    L.check("q", q, (B, H, hd), dev)
    L.check("k", k, (B, KV, S, hd), dev, q.dtype)
    L.check("v", v, (B, KV, S, hd), dev, q.dtype)
    _check_group(H, KV, hd)
    L.check_index("S", S)
    if not L.aligned(k, v):
        raise ValueError("k and v must be 16-byte aligned")
    pos_rows, pos_scalar, offs, w = _rows(pos, offsets, B, dev, window)
    rope = rope_theta is not None
    log_theta = math.log(rope_theta) if rope else 0.0
    o = torch.empty_like(q)
    lib = L.bind("flash_decode.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.flash_decode_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               o.data_ptr(), L.ptr(pos_rows), pos_scalar, L.ptr(offs), B, H,
               KV, S, hd, w, int(ring), int(rope), log_theta,
               1.0 / math.sqrt(hd), code, L.stream(dev))
    launches["flash_decode"] += 1
    return o


def flash_decode_paged(q: Tensor, kp: Tensor, vp: Tensor, pt: Tensor,
                       pos: Union[int, Tensor], *,
                       window: Optional[int] = None,
                       offsets: Optional[Tensor] = None,
                       k_scale: Optional[Tensor] = None,
                       v_scale: Optional[Tensor] = None,
                       rope_theta: Optional[float] = None) -> Tensor:
    """q: (B, H, hd); kp, vp: (pages, KV, ps, hd); pt: (B, NB) int32 ->
    (B, H, hd) in q.dtype. ``k_scale``/``v_scale`` (pages, KV, ps) f32 come
    together and only with an int8 pool; a bf16/f32 pool has q's dtype.

    Every ``pt`` entry that a visible slot reaches (every entry of a row
    that sees no slot) must lie in [0, pages): the caller's contract,
    which the wrapper cannot check without a host sync (the serving
    engine keeps it)."""
    if not q.is_cuda:
        return ref.flash_decode_paged_ref(
            q, kp, vp, pt, pos, window=window, offsets=offsets,
            k_scale=k_scale, v_scale=v_scale, rope_theta=rope_theta)
    if q.dim() != 3 or kp.dim() != 4 or pt.dim() != 2:
        raise ValueError(f"q must be (B, H, hd), kp (pages, KV, ps, hd) and "
                         f"pt (B, NB), got {tuple(q.shape)}, "
                         f"{tuple(kp.shape)} and {tuple(pt.shape)}")
    B, H, hd = q.shape
    pages, KV, ps = kp.shape[0], kp.shape[1], kp.shape[2]
    NB = pt.shape[1]
    dev = q.device
    code = L.dtype_code("q", q)
    int8 = kp.dtype == torch.int8
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if int8 != (k_scale is not None):
        raise ValueError("k_scale/v_scale come with an int8 pool and only "
                         f"with one (pool is {kp.dtype})")
    kv_dtype = torch.int8 if int8 else q.dtype
    L.check("q", q, (B, H, hd), dev)
    L.check("kp", kp, (pages, KV, ps, hd), dev, kv_dtype)
    L.check("vp", vp, (pages, KV, ps, hd), dev, kv_dtype)
    L.check("pt", pt, (B, NB), dev, torch.int32)
    if int8:
        L.check("k_scale", k_scale, (pages, KV, ps), dev, torch.float32)
        L.check("v_scale", v_scale, (pages, KV, ps), dev, torch.float32)
    _check_group(H, KV, hd)
    if ps < 1 or NB < 1:
        raise ValueError(f"page_size={ps} and NB={NB} must be >= 1")
    if not L.aligned(kp, vp):
        raise ValueError("kp and vp must be 16-byte aligned")
    L.check_index("NB * page_size", NB * ps)
    pos_rows, pos_scalar, offs, w = _rows(pos, offsets, B, dev, window)
    rope = rope_theta is not None
    log_theta = math.log(rope_theta) if rope else 0.0
    o = torch.empty_like(q)
    lib = L.bind("flash_decode_paged.cu", _PAGED_SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.flash_decode_paged_fwd, q.data_ptr(), kp.data_ptr(),
               vp.data_ptr(), L.ptr(k_scale), L.ptr(v_scale), pt.data_ptr(),
               o.data_ptr(), L.ptr(pos_rows), pos_scalar, L.ptr(offs), B, H,
               KV, NB, ps, hd, w, int(rope), log_theta, 1.0 / math.sqrt(hd),
               code, int(int8), L.stream(dev))
    launches["flash_decode_paged"] += 1
    return o
