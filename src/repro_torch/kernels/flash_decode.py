"""Wrapper of the Hopper flash decode kernel (``csrc/flash_decode.cu``).

``flash_decode`` replaces
``src/repro/kernels/flash_decode.py:flash_decode_pallas``: one query row
per sequence against a head-major (B, KV, S, hd) cache, with per-row
``pos`` and left-pad ``offsets``, a ring-buffer or windowed cache and the
query's RoPE rotation (by ``pos - offset``) fused in. Slot visibility is
:func:`slot_visibility`, the predicate the kernel evaluates per slot. It
is bound by the bytes of the visible cache.

``pos`` is an int (every row at one depth), a 0-d tensor or a per-row
(B,) tensor; a tensor is read by the kernel on the device, never on the
host. On a CPU tensor the wrapper computes its plain version
(:func:`repro_torch.kernels.ref.flash_decode_ref`); on a CUDA tensor it
launches the kernel or raises. The kernel's limits: q, k, v of one dtype
(f32 or bf16), contiguous, ``hd`` in ``HEAD_DIMS``, a GQA group
``H // KV`` in ``GROUPS`` with ``(H // KV) * hd <= MAX_GROUP_WIDTH``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref
from repro_torch.kernels.ref import slot_visibility  # noqa: F401 (re-export)

Tensor = torch.Tensor

launches: Dict[str, int] = {"flash_decode": 0}
HEAD_DIMS = (32, 64, 128, 256)
GROUPS = (1, 2, 4, 8, 16)
MAX_GROUP_WIDTH = 1024

_SIGNATURES = {"flash_decode_fwd": [L.P] * 5 + [L.I, L.P] + [L.I] * 8
               + [L.F, L.F, L.I, L.P]}


def reset_launches() -> None:
    launches["flash_decode"] = 0


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
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim={hd}: the kernel takes {HEAD_DIMS}")
    if H % KV or H // KV not in GROUPS \
            or (H // KV) * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"H={H}, KV={KV}, hd={hd}: the kernel takes a GQA "
                         f"group in {GROUPS} with group * hd <= "
                         f"{MAX_GROUP_WIDTH}")
    if B > 65535 or KV > 65535:
        raise ValueError(f"B={B}, KV={KV}: the grid takes at most 65535 each")
    L.check_index("S", S)
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
