"""The kernels as the model code calls them (the port of
``repro.kernels.ops``).

- ``gbn_forward``: the GBN kernel pair of :mod:`repro_torch.kernels.gbn`
  behind a ``torch.autograd.Function`` (``ops.gbn_forward``'s
  ``jax.custom_vjp``). The saved residuals are the input and the reduced
  (G, C) statistics: nothing activation-sized besides x.
- ``flash_attention``, ``flash_decode``, ``flash_decode_paged``,
  ``rmsnorm_residual``, ``swiglu``: forward-only layout adapters of the
  serving path, taking the model's
  layouts ((B, T, H, hd) activations, (..., d) rows) to the kernels'. Their
  autograd Functions come with the training slice.

A CUDA tensor goes to the CUDA kernels or the call raises; a CPU tensor
goes to their plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import gbn as K
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode as _flash_decode
from repro_torch.kernels.flash_decode import \
    flash_decode_paged as _flash_decode_paged
from repro_torch.kernels.fused_norm import \
    rmsnorm_residual as _rmsnorm_residual
from repro_torch.kernels.swiglu import swiglu as _swiglu

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


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    kv_offsets: Optional[Tensor] = None) -> Tensor:
    """q (B, T, H, hd); k, v (B, S, KV, hd) -> (B, T, H, hd), head-major
    inside. ``kv_offsets`` (B,) masks keys before each sequence's first
    real token (the serving prefill's left-padded ragged prompts)."""
    out = flash_attention_fwd(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), causal=causal,
                              window=window, kv_offsets=kv_offsets)
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


def rmsnorm_residual(x: Tensor, r: Optional[Tensor], scale: Tensor, *,
                     eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """(rmsnorm(x + r) * scale, x + r) over (..., d) rows; ``r=None`` is a
    zero residual (no add, s is x)."""
    d = x.shape[-1]
    y, s = _rmsnorm_residual(
        x.reshape(-1, d).contiguous(),
        None if r is None else r.reshape(-1, d).contiguous(), scale, eps=eps)
    return y.reshape(x.shape), s.reshape(x.shape)


def swiglu(x: Tensor, wg: Tensor, wu: Tensor) -> Tensor:
    """silu(x @ wg) * (x @ wu) over (..., d) rows -> (..., F)."""
    d, F = wg.shape
    h, _ = _swiglu(x.reshape(-1, d).contiguous(), wg.contiguous(),
                   wu.contiguous())
    return h.reshape(x.shape[:-1] + (F,))
