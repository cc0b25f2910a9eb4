"""Wrappers of the Hopper flash attention kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``).

- ``flash_attention_fwd`` replaces
  ``src/repro/kernels/flash_attention.py:flash_attention_pallas``
  (forward, without RoPE): causal or windowed GQA self-attention over
  head-major q (B, H, T, hd) and k, v (B, KV, S, hd), with the
  ``kv_offsets`` left-pad mask of the serving prefill and, when asked, the
  f32 row logsumexp.
- ``flash_attention_rope_fwd`` replaces ``flash_attention_rope_pallas``:
  q and k rotated by the positions ``pos`` (B, T) inside the call
  (self-attention, S == T): a first kernel rotates each value once into
  scratch the wrapper allocates, then the same attention kernel runs.
- ``flash_attention_backward`` replaces
  ``flash_attention_backward_pallas`` (its split path): dq, dk, dv from
  q, k, v, o, lse and do, the probabilities recomputed from lse; dk and dv
  are summed over each GQA group inside the kernel.
  ``flash_attention_rope_backward`` (the reference's RoPE wrapper,
  ``:629``) is the same kernel with its RoPE flag on: on CUDA one call
  takes the UNROTATED q, k and ``pos``, rotates q and k as the forward
  does (bit for bit the same operands), and rotates dq and dk back by
  ``-pos`` in the kernels' epilogues. On the CPU it is the composite plain
  version: q and k rotated in plain torch, the plain backward, dq and dk
  rotated back.

bf16 runs on the tensor-core bodies (``mma.sync`` with f32 accumulation),
f32 on the FMA bodies: the dtype chooses, and the kernels' C entry points
dispatch on it.

A query row that sees no key (a left-pad row, ``t < kv_offsets[b]``) is
written as the mean of V over the S keys with ``lse = -inf``: the softmax
of equal masked logits, as the reference's attention gives it (and its
Pallas kernel where one of its blocks holds exactly the S keys; elsewhere
the Pallas value depends on its block size). Left pads route in an MoE layer and take
capacity slots, so the value reaches real tokens there.

On a CPU tensor each computes its plain version
(:func:`repro_torch.kernels.ref.attention_ref`,
:func:`~repro_torch.kernels.ref.attention_rope_ref`,
:func:`~repro_torch.kernels.ref.attention_backward_ref`); on a CUDA tensor
it launches the kernel or raises. The kernels' limits: every operand of
one dtype (f32 or bf16), contiguous, ``hd`` in ``HEAD_DIMS`` (the
backward: ``BWD_HEAD_DIMS``; its f32 tiles must fit in shared memory and
its bf16 accumulators in registers), ``H % KV == 0``; bf16 operands
16-byte aligned (the tensor-core bodies copy 16-byte chunks). Widths 112
and 120 (kimi-k2, h2o-danube-3-4b) run in the kernels themselves: the
bf16 bodies on tiles of 128 columns whose columns past the width are
zeros, never stored, the scale the real width's 1/sqrt(hd).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import launch as L
from repro_torch.kernels import ref

Tensor = torch.Tensor

launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_rope": 0,
                            "flash_attention_backward": 0}
HEAD_DIMS = (32, 64, 112, 120, 128, 256)
BWD_HEAD_DIMS = (32, 64, 112, 120, 128)

_SIGNATURES = {"flash_attention_fwd": [L.P] * 8 + [L.I] * 8
               + [L.F, L.F, L.I, L.P]}
_BWD_SIGNATURES = {"flash_attention_bwd": [L.P] * 12 + [L.I] * 8
                   + [L.F, L.F, L.I, L.P]}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_qkv(q: Tensor, k: Tensor, v: Tensor, head_dims=HEAD_DIMS
               ) -> Tuple[int, int, int, int, int, int, int]:
    """(B, H, KV, T, S, hd, dtype code) of head-major q, k, v the kernels
    take; raises on anything else."""
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
    if hd not in head_dims:
        raise ValueError(f"head_dim={hd}: the kernel takes {head_dims}")
    if H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B}, H={H}: the grid takes at most 65535 each")
    L.check_index("T", T)
    L.check_index("S", S)
    if q.dtype == torch.bfloat16 and not L.aligned(q, k, v):
        raise ValueError("bf16 q, k, v must be 16-byte aligned")
    return B, H, KV, T, S, hd, code


def _positions(q: Tensor, k: Tensor, pos: Tensor) -> Tensor:
    """pos (B, T) as the contiguous f32 the kernels take, for head-major
    q, k already checked by :func:`_check_qkv`; RoPE attention is
    self-attention (S == T), and its rotation pass reads q and k in 16-byte
    chunks."""
    B, T, S = q.shape[0], q.shape[2], k.shape[2]
    if S != T:
        raise ValueError(f"RoPE attention is self-attention: S={S} != T={T}")
    if not L.aligned(q, k):
        raise ValueError("q and k must be 16-byte aligned for RoPE")
    pos32 = pos.to(torch.float32).contiguous()
    L.check("pos", pos32, (B, T), q.device)
    return pos32


def _rope_scratch(q: Tensor, k: Tensor) -> Tensor:
    """Room for the rotated q and k, which the kernels' first pass writes
    once and the attention kernels read."""
    return torch.empty(q.numel() + k.numel(), device=q.device,
                       dtype=q.dtype)


def _window(window: Optional[int]) -> int:
    if window is not None and int(window) < 1:
        raise ValueError(f"window={window} must be >= 1")
    return 0 if window is None else int(window)


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
    B, H, KV, T, S, hd, code = _check_qkv(q, k, v)
    dev = q.device
    offs = None
    if kv_offsets is not None:
        if kv_offsets.device != dev or kv_offsets.shape != (B,):
            raise ValueError(f"kv_offsets must be ({B},) on {dev}")
        offs = kv_offsets.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, T), device=dev, dtype=torch.float32)
           if return_lse else None)
    w = _window(window)
    lib = L.bind("flash_attention.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.flash_attention_fwd, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), o.data_ptr(), L.ptr(lse), L.ptr(offs), None,
               None, B, H, KV, T, S, hd, int(causal), w, 1.0 / math.sqrt(hd),
               0.0, code, L.stream(dev))
    launches["flash_attention"] += 1
    return (o, lse) if return_lse else o


def flash_attention_rope_fwd(q: Tensor, k: Tensor, v: Tensor, pos: Tensor, *,
                             theta: float, causal: bool = True,
                             window: Optional[int] = None,
                             return_lse: bool = False
                             ) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """q: (B, H, T, hd); k, v: (B, KV, T, hd) UNROTATED; pos: (B, T)
    positions shared by q and k -> o (B, H, T, hd) in q.dtype (and lse
    (B, H, T) f32 with ``return_lse``), the rotation done inside the kernel."""
    if not q.is_cuda:
        return ref.attention_rope_ref(q, k, v, pos, theta=theta,
                                      causal=causal, window=window,
                                      return_lse=return_lse)
    B, H, KV, T, S, hd, code = _check_qkv(q, k, v)
    dev = q.device
    pos32 = _positions(q, k, pos)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, T), device=dev, dtype=torch.float32)
           if return_lse else None)
    w = _window(window)
    rot = _rope_scratch(q, k)
    lib = L.bind("flash_attention.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.flash_attention_fwd, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), o.data_ptr(), L.ptr(lse), None,
               pos32.data_ptr(), L.ptr(rot), B, H, KV, T, S, hd, int(causal),
               w, 1.0 / math.sqrt(hd), math.log(theta), code, L.stream(dev))
    launches["flash_attention_rope"] += 1
    return (o, lse) if return_lse else o


def flash_attention_backward(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                             lse: Tensor, do: Tensor, *, causal: bool = True,
                             window: Optional[int] = None
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """VJP of the forward w.r.t. (q, k, v). q, o, do: (B, H, T, hd); k, v:
    (B, KV, S, hd); lse (B, H, T) f32. Returns (dq, dk, dv) in q's dtype, dk
    and dv summed over each GQA group."""
    if not q.is_cuda:
        return ref.attention_backward_ref(q, k, v, o, lse, do, causal=causal,
                                          window=window)
    return _backward(q, k, v, o, lse, do, None, None, causal, window)


def flash_attention_rope_backward(q: Tensor, k: Tensor, v: Tensor,
                                  pos: Tensor, o: Tensor, lse: Tensor,
                                  do: Tensor, *, theta: float,
                                  causal: bool = True,
                                  window: Optional[int] = None
                                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """VJP of :func:`flash_attention_rope_fwd` w.r.t. the UNROTATED (q, k,
    v). On CUDA one call of the backward kernels with their RoPE flag on. On
    the CPU the plain composite: the rotation is orthogonal and
    position-wise, so q and k are rotated by pos (in their dtype), the plain
    backward runs on the rotated inputs, and dq, dk are rotated back by
    -pos. dv is untouched by RoPE."""
    if not q.is_cuda:
        qr = ref.rope_rotate_hm(q, pos, theta)
        kr = ref.rope_rotate_hm(k, pos, theta)
        dqr, dkr, dv = ref.attention_backward_ref(qr, kr, v, o, lse, do,
                                                  causal=causal,
                                                  window=window)
        back = -pos.to(torch.float32)
        return (ref.rope_rotate_hm(dqr, back, theta),
                ref.rope_rotate_hm(dkr, back, theta), dv)
    return _backward(q, k, v, o, lse, do, pos, theta, causal, window)


def _backward(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
              do: Tensor, pos: Optional[Tensor], theta: Optional[float],
              causal: bool, window: Optional[int]
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """One call of the backward kernels; with ``pos`` (and ``theta``) q
    and k are the unrotated inputs of RoPE attention."""
    B, H, KV, T, S, hd, code = _check_qkv(q, k, v, BWD_HEAD_DIMS)
    dev = q.device
    pos32 = None if pos is None else _positions(q, k, pos)
    L.check("o", o, (B, H, T, hd), dev, q.dtype)
    L.check("do", do, (B, H, T, hd), dev, q.dtype)
    L.check("lse", lse, (B, H, T), dev, torch.float32)
    if q.dtype == torch.bfloat16 and not L.aligned(o, do):
        raise ValueError("bf16 o and do must be 16-byte aligned")
    w = _window(window)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, T), device=dev, dtype=torch.float32)
    rot = None if pos is None else _rope_scratch(q, k)
    log_theta = 0.0 if pos is None else math.log(theta)
    lib = L.bind("flash_attention_bwd.cu", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        L.call(lib.flash_attention_bwd, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
               L.ptr(pos32), L.ptr(rot), B, H, KV, T, S, hd, int(causal), w,
               1.0 / math.sqrt(hd), log_theta, code, L.stream(dev))
    launches["flash_attention_backward"] += 1
    return dq, dk, dv
