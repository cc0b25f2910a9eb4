"""The kernels as the model code calls them (the port of
``repro.kernels.ops``), taking the model's layouts ((B, T, H, hd)
activations, (..., d) rows) to the kernels'.

Every differentiable op is a ``torch.autograd.Function`` (the reference's
``jax.custom_vjp``) whose backward is the op's backward kernel:

- ``gbn_forward``: the GBN pair; saves x and the (G, C) statistics.
- ``rmsnorm_residual``: saves ``(s, scale)``; the backward kernel gives
  ``dx`` (also ``dr``) and ``dscale``. With ``r=None`` a separate Function
  returns y alone and saves ``(x, scale)``; an unused cotangent of s
  reaches the kernel as a null ``ds``, not as zeros.
- ``swiglu``: saves ``(x, wg, wu, g)``; the backward kernel gives dx, dg
  and du, and ``dwg = x^T dg``, ``dwu = x^T du`` are plain f32 GEMMs, as
  in ``repro.kernels.ops._swiglu_bwd``.
- ``flash_attention_rope``: saves the UNROTATED q, k, v, the positions, o
  and lse; ``flash_attention``/``flash_attention_hm`` without
  ``kv_offsets`` save q, k, v, o and lse. Both backwards run the flash
  backward kernel (through the RoPE wrapper for the first).

``flash_attention`` with ``kv_offsets``, ``flash_decode`` and
``flash_decode_paged`` are forward-only, as in the reference (serving).
Where no input requires grad (serving), nothing is kept for a backward.

A CUDA tensor goes to the CUDA kernels or the call raises; a CPU tensor
goes to their plain versions (forward and backward alike).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_norm as FN
from repro_torch.kernels import gbn as K
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import swiglu as SW
from repro_torch.kernels.flash_decode import flash_decode as _flash_decode
from repro_torch.kernels.flash_decode import \
    flash_decode_paged as _flash_decode_paged

Tensor = torch.Tensor


class _GBN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xg: Tensor, gamma: Tensor, beta: Tensor, eps: float):
        y, mu, var = K.gbn_forward(xg, gamma, beta, eps=eps)
        ctx.save_for_backward(xg, gamma, mu, var)
        ctx.eps = eps
        ctx.beta_dtype = beta.dtype
        return y, mu, var

    @staticmethod
    def backward(ctx, dy: Tensor, dmu: Tensor, dvar: Tensor):
        xg, gamma, mu, var = ctx.saved_tensors
        dx, dgamma, dbeta = K.gbn_backward(
            xg, gamma, mu, var, dy.contiguous(), dmu.contiguous(),
            dvar.contiguous(), eps=ctx.eps)
        return dx, dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype), None


def gbn_forward(xg: Tensor, gamma: Tensor, beta: Tensor, *,
                eps: float = 1e-5) -> Tuple[Tensor, Tensor, Tensor]:
    """xg: (G, R, C) f32 -> (y, mu (G, C), var (G, C)); differentiable
    w.r.t. xg, gamma and beta through all three outputs."""
    return _GBN.apply(xg, gamma, beta, eps)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, causal: bool,
                window: Optional[int]):
        o, lse = FA.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do: Tensor):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = FA.flash_attention_backward(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


class _FlashAttentionRoPE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, pos: Tensor,
                theta: float, causal: bool, window: Optional[int]):
        o, lse = FA.flash_attention_rope_fwd(q, k, v, pos, theta=theta,
                                             causal=causal, window=window,
                                             return_lse=True)
        # the UNROTATED q and k: the backward re-rotates them
        ctx.save_for_backward(q, k, v, pos, o, lse)
        ctx.theta, ctx.causal, ctx.window = theta, causal, window
        return o

    @staticmethod
    def backward(ctx, do: Tensor):
        q, k, v, pos, o, lse = ctx.saved_tensors
        dq, dk, dv = FA.flash_attention_rope_backward(
            q, k, v, pos, o, lse, do.contiguous(), theta=ctx.theta,
            causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def _head_major(t: Tensor) -> Tensor:
    return t.transpose(1, 2).contiguous()


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    kv_offsets: Optional[Tensor] = None) -> Tensor:
    """q (B, T, H, hd); k, v (B, S, KV, hd) -> (B, T, H, hd), head-major
    inside. ``kv_offsets`` (B,) masks keys before each sequence's first
    real token (the serving prefill's left-padded ragged prompts); that
    path is forward-only. Without it the op is differentiable through the
    flash backward kernel."""
    qm, km, vm = _head_major(q), _head_major(k), _head_major(v)
    if kv_offsets is not None:
        out = FA.flash_attention_fwd(qm, km, vm, causal=causal,
                                     window=window, kv_offsets=kv_offsets)
    else:
        out = _FlashAttention.apply(qm, km, vm, causal, window)
    return out.transpose(1, 2)


def flash_attention_hm(q: Tensor, k: Tensor, v: Tensor, *,
                       causal: bool = True,
                       window: Optional[int] = None) -> Tensor:
    """Head-major entry: q (B, H, T, hd); k, v (B, KV, S, hd), contiguous;
    differentiable."""
    return _FlashAttention.apply(q, k, v, causal, window)


def flash_attention_rope(q: Tensor, k: Tensor, v: Tensor, positions: Tensor,
                         *, theta: float, causal: bool = True,
                         window: Optional[int] = None) -> Tensor:
    """Self-attention with RoPE fused into the kernel's q/k loads: q
    (B, T, H, hd); k, v (B, T, KV, hd) UNROTATED; ``positions``
    broadcastable to (B, T) -> (B, T, H, hd). Differentiable: the backward
    rotates q and k, runs the flash backward kernel and rotates dq and dk
    back."""
    B, T = q.shape[0], q.shape[1]
    pos = torch.broadcast_to(positions.to(torch.float32), (B, T)).contiguous()
    out = _FlashAttentionRoPE.apply(_head_major(q), _head_major(k),
                                    _head_major(v), pos, theta, causal,
                                    window)
    return out.transpose(1, 2)


def flash_decode(q: Tensor, k: Tensor, v: Tensor, pos: Union[int, Tensor], *,
                 window: Optional[int] = None, ring: bool = False,
                 offsets: Optional[Tensor] = None,
                 rope_theta: Optional[float] = None) -> Tensor:
    """q (B, 1, H, hd) UNROTATED; k, v (B, KV, S, hd) head-major cache ->
    (B, 1, H, hd). ``pos`` is an int or a per-row (B,) tensor;
    ``rope_theta`` rotates q by ``pos - offsets`` inside the kernel."""
    B, T, H, hd = q.shape
    if T != 1:
        raise ValueError(f"decode takes one query row per sequence, got {T}")
    out = _flash_decode(q.reshape(B, H, hd).contiguous(), k, v, pos,
                        window=window, ring=ring, offsets=offsets,
                        rope_theta=rope_theta)
    return out.reshape(B, 1, H, hd)


def flash_decode_paged(q: Tensor, kp: Tensor, vp: Tensor, pt: Tensor,
                       pos: Union[int, Tensor], *,
                       window: Optional[int] = None,
                       offsets: Optional[Tensor] = None,
                       k_scale: Optional[Tensor] = None,
                       v_scale: Optional[Tensor] = None,
                       rope_theta: Optional[float] = None) -> Tensor:
    """q (B, 1, H, hd) UNROTATED; kp, vp (pages, KV, ps, hd) page pool;
    pt (B, NB) int32 block tables -> (B, 1, H, hd). ``k_scale``/``v_scale``
    (pages, KV, ps) f32 mark an int8 pool, dequantized at the load;
    ``rope_theta`` rotates q by ``pos - offsets`` inside the kernel."""
    B, T, H, hd = q.shape
    if T != 1:
        raise ValueError(f"decode takes one query row per sequence, got {T}")
    out = _flash_decode_paged(q.reshape(B, H, hd).contiguous(), kp, vp, pt,
                              pos, window=window, offsets=offsets,
                              k_scale=k_scale, v_scale=v_scale,
                              rope_theta=rope_theta)
    return out.reshape(B, 1, H, hd)


class _RMSNormResidual(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x: Tensor, r: Tensor, scale: Tensor, eps: float):
        ctx.set_materialize_grads(False)
        y, s = FN.rmsnorm_residual(x, r, scale, eps=eps)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        return y, s

    @staticmethod
    def backward(ctx, dy: Optional[Tensor], ds: Optional[Tensor]):
        s, scale = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(s)
        dx, dscale = FN.rmsnorm_residual_backward(
            s, scale, dy.contiguous(), None if ds is None else ds.contiguous(),
            eps=ctx.eps)
        # the residual add fans the cotangent out equally: dr == dx
        return dx, dx, dscale.to(scale.dtype), None


class _RMSNorm(torch.autograd.Function):
    """The norm with no residual: y alone (s would be x itself)."""

    @staticmethod
    def forward(ctx, x: Tensor, scale: Tensor, eps: float):
        y, _ = FN.rmsnorm_residual(x, None, scale, eps=eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy: Tensor):
        x, scale = ctx.saved_tensors
        dx, dscale = FN.rmsnorm_residual_backward(x, scale, dy.contiguous(),
                                                  None, eps=ctx.eps)
        return dx, dscale.to(scale.dtype), None


def rmsnorm_residual(x: Tensor, r: Optional[Tensor], scale: Tensor, *,
                     eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """(rmsnorm(x + r) * scale, x + r) over (..., d) rows; ``r=None`` is a
    zero residual (no add, s is x). Differentiable w.r.t. x, r and scale."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    if r is None:
        return _RMSNorm.apply(x2, scale, eps).reshape(x.shape), x
    y, s = _RMSNormResidual.apply(x2, r.reshape(-1, d).contiguous(), scale,
                                  eps)
    return y.reshape(x.shape), s.reshape(x.shape)


class _SwiGLU(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x: Tensor, wg: Tensor, wu: Tensor):
        h, g = SW.swiglu(x, wg, wu)
        ctx.save_for_backward(x, wg, wu, g)     # g: the one saved hidden
        return h

    @staticmethod
    def backward(ctx, dh: Tensor):
        x, wg, wu, g = ctx.saved_tensors
        dx, dg, du = SW.swiglu_backward(x, wg, wu, g, dh.contiguous())
        # weight grads are plain f32 GEMMs over the rows, as the reference's
        xt = x.float().T
        return (dx.to(x.dtype), (xt @ dg.float()).to(wg.dtype),
                (xt @ du.float()).to(wu.dtype))


def swiglu(x: Tensor, wg: Tensor, wu: Tensor) -> Tensor:
    """silu(x @ wg) * (x @ wu) over (..., d) rows -> (..., F);
    differentiable w.r.t. x, wg and wu."""
    d, F = wg.shape
    h = _SwiGLU.apply(x.reshape(-1, d).contiguous(), wg.contiguous(),
                      wu.contiguous())
    return h.reshape(x.shape[:-1] + (F,))


class _MambaChunk(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xc: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor,
                A: Tensor, h0: Tensor):
        y, h_last = MS.mamba_chunk(xc, dt, Bm, Cm, A, h0)
        ctx.save_for_backward(xc, dt, Bm, Cm, A, h0)
        return y, h_last

    @staticmethod
    def backward(ctx, dy: Tensor, dh_last: Tensor):
        return MS.mamba_chunk_backward(*ctx.saved_tensors, dy.contiguous(),
                                       dh_last.contiguous())


def mamba_chunk(xc: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor, A: Tensor,
                h0: Tensor) -> Tuple[Tensor, Tensor]:
    """One chunk of the selective scan: xc, dt (B, c, di); Bm, Cm
    (B, c, ds); A (di, ds) f32; h0 (B, di, ds) f32 -> (y (B, c, di) f32,
    h_last (B, di, ds) f32). Differentiable w.r.t. all six inputs through
    the backward kernel (no replay of the forward)."""
    return _MambaChunk.apply(xc.contiguous(), dt.contiguous(),
                             Bm.contiguous(), Cm.contiguous(),
                             A.contiguous(), h0.contiguous())
