"""Wrapper of the Hopper flash attention forward kernel
(``csrc/flash_attention.cu``).

``flash_attention_fwd`` replaces
``src/repro/kernels/flash_attention.py:flash_attention_pallas`` (forward,
without RoPE): causal or windowed GQA self-attention over head-major
q (B, H, T, hd) and k, v (B, KV, S, hd), with the ``kv_offsets`` left-pad
mask of the serving prefill and, when asked, the f32 row logsumexp. Its
backward comes with the training slice.

A query row that sees no key (a left-pad row, ``t < kv_offsets[b]``) is
written as 0 with ``lse = -inf``; the Pallas kernel leaves there a mean of
V that depends on its block size. Such rows never reach a real row (their
slots are masked in every later attention), so the port is compared with
the JAX package on real rows only.

On a CPU tensor it computes its plain version
(:func:`repro_torch.kernels.ref.attention_ref`); on a CUDA tensor it
launches the kernel or raises. The kernel's limits: q, k, v of one dtype
(f32 or bf16), contiguous, ``hd`` in ``HEAD_DIMS``, ``H % KV == 0``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"flash_attention": 0}
HEAD_DIMS = (32, 64, 128, 256)

_SIGNATURES = {"flash_attention_fwd": [L.P] * 6 + [L.I] * 8 + [L.F, L.I,
                                                             L.P]}


def reset_launches() -> None:
    launches["flash_attention"] = 0


def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        kv_offsets: Optional[Tensor] = None,
                        return_lse: bool = False
                        ) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """q: (B, H, T, hd); k, v: (B, KV, S, hd) -> o (B, H, T, hd) in q.dtype
    (and lse (B, H, T) f32 with ``return_lse``). ``kv_offsets`` (B,) hides
    keys before each row's first real token."""
    if not q.is_cuda:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 kv_offsets=kv_offsets,
                                 return_lse=return_lse)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, H, T, hd) and k (B, KV, S, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    dev = q.device
    code = L.dtype_code("q", q)
    L.check("q", q, (B, H, T, hd), dev)
    L.check("k", k, (B, KV, S, hd), dev, q.dtype)
    L.check("v", v, (B, KV, S, hd), dev, q.dtype)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim={hd}: the kernel takes {HEAD_DIMS}")
    if H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B}, H={H}: the grid takes at most 65535 each")
    L.check_index("T", T)
    L.check_index("S", S)
    offs = None
    if kv_offsets is not None:
        if kv_offsets.device != dev or kv_offsets.shape != (B,):
            raise ValueError(f"kv_offsets must be ({B},) on {dev}")
        offs = kv_offsets.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, T), device=dev, dtype=torch.float32)
           if return_lse else None)
    w = 0 if window is None else int(window)
    if window is not None and w < 1:
        raise ValueError(f"window={window} must be >= 1")
    lib = L.bind("flash_attention.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.flash_attention_fwd, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), o.data_ptr(), L.ptr(lse), L.ptr(offs), B, H, KV,
               T, S, hd, int(causal), w, 1.0 / math.sqrt(hd), code,
               L.stream(dev))
    launches["flash_attention"] += 1
    return (o, lse) if return_lse else o
