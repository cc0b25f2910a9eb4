"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper, and what ``chip_smoke.py`` holds each CUDA kernel to on the card.

- GBN: mirrors ``repro.kernels.ref.gbn_ref`` / ``gbn_vjp_ref`` (two-pass,
  biased variance).
- ``rmsnorm_residual_ref`` and ``swiglu_ref`` mirror their ``repro`` twins
  op for op, in the input dtype; their backwards
  (``rmsnorm_residual_backward_ref``, ``swiglu_backward_ref``) mirror the
  Pallas backward kernels in f32, and the ``*_vjp_ref`` oracles are hand
  derived from them, not autograd through the forward.
- ``attention_ref``, ``attention_rope_ref``, ``flash_decode_ref`` and
  ``flash_decode_paged_ref`` compute in f32 as the kernels do (``repro``'s
  attention oracle forms bf16 logits; in f32 the two agree).
  ``attention_backward_ref`` is the flash backward's recomputation from
  (o, lse); ``attention_vjp_ref`` and ``attention_rope_vjp_ref`` are the
  hand-derived softmax VJPs of ``repro.kernels.ref``. A query row that
  sees no key (a left-pad row of a ragged prompt) takes the softmax of
  equal masked logits over every key: the mean of V over the S keys (the
  S slots of a decode cache), as the reference's attention gives it. Pad
  rows route in an MoE layer and take capacity slots, so their value
  reaches real tokens there.
- ``quantize_slots`` is the int8 KV pool's per-slot quantizer.
- ``mamba_chunk_ref`` is the sequential selective-scan recurrence of
  ``repro.kernels.ref.mamba_chunk_ref`` in f32; its backward
  ``mamba_chunk_backward_ref`` is autograd through it, as the reference's
  oracle VJP is ``jax.vjp`` of its forward.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
NEG_INF = -1e30          # the masked logit, as in ``repro.kernels``


def gbn_ref(xg: Tensor, gamma: Tensor, beta: Tensor, *, eps: float = 1e-5
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """xg: (G, R, C) -> (y (G,R,C), mu (G,C), var (G,C)); biased variance."""
    xf = xg.float()
    mu = xf.mean(dim=1)
    var = (xf - mu[:, None, :]).square().mean(dim=1)
    y = (xf - mu[:, None, :]) * torch.rsqrt(var[:, None, :] + eps)
    y = y * gamma.float() + beta.float()
    return y.to(xg.dtype), mu, var


def gbn_backward_ref(xg: Tensor, gamma: Tensor, mu: Tensor, var: Tensor,
                     dy: Tensor, dmu: Tensor, dvar: Tensor, *,
                     eps: float = 1e-5) -> Tuple[Tensor, Tensor, Tensor]:
    """VJP of :func:`gbn_ref` from the saved (mu, var), with the cotangents
    of all three outputs. Returns (dx in xg.dtype, dgamma f32, dbeta f32).

        gvar = dvar - 1/2 gamma rstd^2 sum_r dy xhat
        gmu  = dmu  - gamma rstd sum_r dy
        dx_r = gamma rstd dy_r + 2 gvar (x_r - mu)/R + gmu/R
    """
    xf = xg.float()
    dyf = dy.float()
    g = gamma.float()
    R = xg.shape[1]
    rstd = torch.rsqrt(var.float() + eps)
    xc = xf - mu.float()[:, None, :]
    sdy = dyf.sum(dim=1)                                       # (G, C)
    sdyxh = (dyf * (xc * rstd[:, None, :])).sum(dim=1)
    gvar = dvar.float() - 0.5 * g * rstd * rstd * sdyxh
    gmu = dmu.float() - g * rstd * sdy
    dx = dyf * (g * rstd)[:, None, :] + xc * (2.0 * gvar / R)[:, None, :] \
        + (gmu / R)[:, None, :]
    return dx.to(xg.dtype), sdyxh.sum(dim=0), sdy.sum(dim=0)


def gbn_vjp_ref(xg: Tensor, gamma: Tensor, beta: Tensor,
                cts: Tuple[Tensor, Tensor, Tensor], *, eps: float = 1e-5
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """VJP of :func:`gbn_ref` w.r.t. (xg, gamma, beta), statistics
    recomputed from ``xg``; ``cts = (dy, dmu, dvar)``."""
    _, mu, var = gbn_ref(xg, gamma, beta, eps=eps)
    dx, dgamma, dbeta = gbn_backward_ref(xg, gamma, mu, var, *cts, eps=eps)
    return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


# ---------------------------------------------------------------------------
# fused rmsnorm + residual, fused SwiGLU
# ---------------------------------------------------------------------------


def rmsnorm_residual_ref(x: Tensor, r: Optional[Tensor], scale: Tensor,
                         eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """``s = x + r`` (rounded to x.dtype) and ``y = rmsnorm(s) * scale``
    computed in f32 and cast back. x, r: (..., d); scale: (d,). Returns
    (y, s); ``r=None`` is a zero residual, and s is x."""
    s = x if r is None else x + r
    sf = s.float()
    var = sf.square().mean(dim=-1, keepdim=True)
    y = sf * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype), s


def rmsnorm_residual_backward_ref(s: Tensor, scale: Tensor, dy: Tensor,
                                  ds: Optional[Tensor], eps: float = 1e-6
                                  ) -> Tuple[Tensor, Tensor]:
    """VJP of :func:`rmsnorm_residual_ref` from the saved ``(s, scale)``,
    op for op as ``repro.kernels.fused_norm._bwd_kernel``: with
    ``s_hat = s * rstd`` and ``w = dy * scale``,

        dx = rstd * (w - s_hat * mean(w * s_hat)) + ds
        dscale = sum over rows of dy * s_hat

    s, dy, ds: (N, d); ``ds=None`` is a zero cotangent on s (the norms with
    no residual). Returns (dx (N, d) in s.dtype, which is also dr, and
    dscale (d,) f32)."""
    sf = s.float()
    dyf = dy.float()
    rv = torch.rsqrt(sf.square().mean(dim=-1, keepdim=True) + eps)
    s_hat = sf * rv
    w = dyf * scale.float()
    dx = rv * (w - s_hat * (w * s_hat).mean(dim=-1, keepdim=True))
    if ds is not None:
        dx = dx + ds.float()
    dscale = (dyf * s_hat).reshape(-1, s.shape[-1]).sum(dim=0)
    return dx.to(s.dtype), dscale


def rmsnorm_residual_vjp_ref(x: Tensor, r: Optional[Tensor], scale: Tensor,
                             cts: Tuple[Tensor, Optional[Tensor]],
                             eps: float = 1e-6
                             ) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """VJP of :func:`rmsnorm_residual_ref` w.r.t. (x, r, scale), hand
    derived (:func:`rmsnorm_residual_backward_ref` at ``s = x + r``).
    ``cts = (dy, ds)``; returns (dx, dr (None when ``r`` is None; else dx:
    the add fans the cotangent out equally), dscale in scale.dtype)."""
    _, s = rmsnorm_residual_ref(x, r, scale, eps)
    dy, ds = cts
    dx, dscale = rmsnorm_residual_backward_ref(s, scale, dy, ds, eps)
    return dx, (None if r is None else dx), dscale.to(scale.dtype)


def swiglu_ref(x: Tensor, wg: Tensor, wu: Tensor) -> Tuple[Tensor, Tensor]:
    """``h = silu(x @ wg) * (x @ wu)`` and the gate pre-activation
    ``g = x @ wg``, in x.dtype. x: (..., d); wg, wu: (d, F)."""
    dt = x.dtype
    g = x @ wg.to(dt)
    u = x @ wu.to(dt)
    return F.silu(g) * u, g


def swiglu_backward_ref(x: Tensor, wg: Tensor, wu: Tensor, g: Tensor,
                        dh: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Activation-side VJP of :func:`swiglu_ref` from the saved gate ``g``,
    op for op as ``repro.kernels.swiglu._bwd_kernel`` (f32 throughout, u
    recomputed): with ``sig = sigmoid(g)``,

        du = dh * g * sig
        dg = dh * u * sig * (1 + g * (1 - sig))
        dx = dg @ wg^T + du @ wu^T          (from the f32 dg, du)

    x: (N, d); wg, wu: (d, F); g, dh: (N, F). Returns (dx (N, d) f32,
    dg and du (N, F) in x.dtype)."""
    wgf, wuf = wg.float(), wu.float()
    u = x.float() @ wuf
    gf, dhf = g.float(), dh.float()
    sig = torch.sigmoid(gf)
    du = dhf * gf * sig
    dg = dhf * u * sig * (1.0 + gf * (1.0 - sig))
    dx = dg @ wgf.T + du @ wuf.T
    return dx, dg.to(x.dtype), du.to(x.dtype)


def swiglu_vjp_ref(x: Tensor, wg: Tensor, wu: Tensor, dh: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """VJP of the SwiGLU output ``h`` w.r.t. (x, wg, wu), hand derived as
    ``repro.kernels.ops._swiglu_bwd``: the activation side from
    :func:`swiglu_backward_ref`, then the weight gradients as f32 GEMMs
    over the rows, ``dwg = x^T @ dg`` and ``dwu = x^T @ du``. x: (..., d);
    dh: (..., F). Returns (dx in x.dtype, dwg, dwu in the weights' dtypes)."""
    d, Fh = wg.shape
    x2 = x.reshape(-1, d)
    _, g = swiglu_ref(x2, wg, wu)
    dx, dg, du = swiglu_backward_ref(x2, wg, wu, g, dh.reshape(-1, Fh))
    x2t = x2.float().T
    return (dx.to(x.dtype).reshape(x.shape), (x2t @ dg.float()).to(wg.dtype),
            (x2t @ du.float()).to(wu.dtype))


# ---------------------------------------------------------------------------
# attention: prefill (flash forward) and decode
# ---------------------------------------------------------------------------


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: Optional[int] = None,
                  kv_offsets: Optional[Tensor] = None,
                  return_lse: bool = False
                  ) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """q: (B, H, T, hd); k, v: (B, KV, S, hd) -> (B, H, T, hd) in q.dtype,
    and with ``return_lse`` the f32 row logsumexp (B, H, T) (-inf for a
    row that sees no key, whose output is the mean of V over the S keys).

    Head h reads kv head ``h // (H // KV)``. Key s is visible to query t
    iff ``s <= t`` (causal), ``s > t - window`` (window) and
    ``s >= kv_offsets[b]`` (left-padded ragged prompts)."""
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    qg = q.float().reshape(B, KV, g, T, hd)
    logits = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) / math.sqrt(hd)
    qi = torch.arange(T, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    mask = mask.expand(B, T, S)
    if kv_offsets is not None:
        mask = mask & (ki[None] >= kv_offsets.reshape(B, 1, 1))
    mask = mask[:, None, None]                              # (B,1,1,T,S)
    p = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    out = out.reshape(B, H, T, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return out, lse.reshape(B, H, T)


def _band_mask(T: int, S: int, causal: bool, window: Optional[int],
               device) -> Tensor:
    """(T, S) visibility of key s to query t (causal, window)."""
    qi = torch.arange(T, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    return mask


def attention_backward_ref(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                           lse: Tensor, do: Tensor, *, causal: bool = True,
                           window: Optional[int] = None
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """VJP of :func:`attention_ref` from the forward's (o, lse), the
    recomputation of ``repro.kernels.flash_attention``'s backward kernels
    (``_recompute_p_ds``) in f32: ``p = exp(q k^T / sqrt(hd) - lse)``,
    ``delta = rowsum(do * o)``, ``ds = p * (do v^T - delta)``; then
    ``dq = ds k / sqrt(hd)``, ``dk = ds^T q / sqrt(hd)``, ``dv = p^T do``
    with dk, dv summed over each GQA group. q, o, do: (B, H, T, hd); k, v:
    (B, KV, S, hd); lse (B, H, T) f32. Returns (dq, dk, dv) in the input
    dtypes."""
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, KV, g, T, hd)
    dof = do.float().reshape(B, KV, g, T, hd)
    kf, vf = k.float(), v.float()
    mask = _band_mask(T, S, causal, window, q.device)
    s = torch.einsum("bkgtd,bksd->bkgts", qf, kf) * scale
    p = torch.exp(s - lse.reshape(B, KV, g, T, 1)).masked_fill(~mask, 0.0)
    delta = (do.float() * o.float()).sum(dim=-1).reshape(B, KV, g, T, 1)
    dp = torch.einsum("bkgtd,bksd->bkgts", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgts,bksd->bkgtd", ds, kf) * scale
    dk = torch.einsum("bkgts,bkgtd->bksd", ds, qf) * scale
    dv = torch.einsum("bkgts,bkgtd->bksd", p, dof)
    return (dq.reshape(B, H, T, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_vjp_ref(q: Tensor, k: Tensor, v: Tensor, do: Tensor, *,
                      causal: bool = True, window: Optional[int] = None
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """Hand-derived VJP of :func:`attention_ref` w.r.t. (q, k, v), as
    ``repro.kernels.ref.attention_vjp_ref``: the probabilities from a
    softmax (not from a saved lse) and ``delta = rowsum(p * dp)``, f32
    throughout. Returns (dq, dk, dv) in the input dtypes."""
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, KV, g, T, hd)
    dof = do.float().reshape(B, KV, g, T, hd)
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bkgtd,bksd->bkgts", qf, kf) * scale
    mask = _band_mask(T, S, causal, window, q.device)
    p = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1)
    dv = torch.einsum("bkgts,bkgtd->bksd", p, dof)
    dp = torch.einsum("bkgtd,bksd->bkgts", dof, vf)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bkgts,bksd->bkgtd", ds, kf).reshape(B, H, T, hd)
    dk = torch.einsum("bkgts,bkgtd->bksd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rope_rotate_hm(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """Head-major RoPE: x (B, Hx, T, hd) by positions pos (B, T), returned
    in x.dtype, as ``repro.kernels.flash_attention._rope_rotate_hm``;
    ``-pos`` rotates back (the rotation is orthogonal)."""
    return rope_rotate(x, pos[:, None, :], theta).to(x.dtype)


def attention_rope_ref(q: Tensor, k: Tensor, v: Tensor, pos: Tensor, *,
                       theta: float, causal: bool = True,
                       window: Optional[int] = None,
                       return_lse: bool = False
                       ) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """RoPE-fused self-attention: q (B, H, T, hd) and k (B, KV, T, hd)
    rotated by pos (B, T) in f32 (as the kernel rotates its tiles right
    after the load, before the 1/sqrt(hd) scale), then
    :func:`attention_ref` in f32. Returns o in q.dtype (and the f32 lse)."""
    out = attention_ref(rope_rotate(q, pos[:, None, :], theta),
                        rope_rotate(k, pos[:, None, :], theta), v.float(),
                        causal=causal, window=window, return_lse=return_lse)
    if return_lse:
        return out[0].to(q.dtype), out[1]
    return out.to(q.dtype)


def attention_rope_vjp_ref(q: Tensor, k: Tensor, v: Tensor, pos: Tensor,
                           do: Tensor, *, theta: float, causal: bool = True,
                           window: Optional[int] = None
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """VJP of :func:`attention_rope_ref` w.r.t. (q, k, v): the rotation is
    orthogonal and position-wise, so rotate q and k by pos, take
    :func:`attention_vjp_ref`, and rotate dq and dk back by -pos (f32)."""
    qr = rope_rotate(q, pos[:, None, :], theta)
    kr = rope_rotate(k, pos[:, None, :], theta)
    dqr, dkr, dv = attention_vjp_ref(qr, kr, v.float(), do, causal=causal,
                                     window=window)
    back = -pos.float()[:, None, :]
    return (rope_rotate(dqr, back, theta).to(q.dtype),
            rope_rotate(dkr, back, theta).to(k.dtype), dv.to(v.dtype))


def slot_visibility(slot: Tensor, pos: Union[int, Tensor], *, seq_k: int,
                    window: Optional[int], ring: bool,
                    offset: Optional[Tensor] = None) -> Tensor:
    """Visibility of cache slots at query position ``pos`` — the predicate
    of ``repro.kernels.flash_decode._slot_visibility``, which the CUDA decode
    kernel evaluates per slot. Slot ``s`` holds global position ``s``, or
    ``pos - ((pos - s) mod seq_k)`` for a ring buffer; it is visible iff
    ``0 <= g <= pos``, ``g > pos - window`` and ``g >= offset``."""
    gpos = pos - torch.remainder(pos - slot, seq_k) if ring else slot
    mask = (slot < seq_k) & (gpos >= 0) & (gpos <= pos)
    if window is not None:
        mask = mask & (gpos > pos - window)
    if offset is not None:
        mask = mask & (gpos >= offset)
    return mask


def rope_rotate(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """Half-split RoPE of ``x (..., hd)`` by positions ``pos`` broadcastable
    to ``x.shape[:-1]``, in f32, as the fused kernels rotate in-kernel
    (``freqs_i = exp(-(i / (hd/2)) * log(theta))``). Returns f32."""
    half = x.shape[-1] // 2
    j = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-(j / half) * math.log(theta))
    ang = pos.float()[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float()[..., :half], x.float()[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def flash_decode_ref(q: Tensor, k: Tensor, v: Tensor,
                     pos: Union[int, Tensor], *,
                     window: Optional[int] = None, ring: bool = False,
                     offsets: Optional[Tensor] = None,
                     rope_theta: Optional[float] = None) -> Tensor:
    """One query row per sequence against a head-major cache. q: (B, H, hd);
    k, v: (B, KV, S, hd) -> (B, H, hd) in q.dtype.

    ``pos`` is an int, a 0-d tensor or a per-row ``(B,)`` tensor of query
    positions. ``rope_theta`` rotates q by ``pos - offsets`` first (the
    cached keys were rotated when written). A row that sees no slot is the
    mean of V over the S slots."""
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    posb = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    posb = posb.to(torch.int64)[:, None]                      # (B, 1)
    off = None if offsets is None else offsets.to(torch.int64)[:, None]
    qf = q.float()
    if rope_theta is not None:
        qpos = posb if off is None else posb - off
        qf = rope_rotate(qf, qpos.expand(B, H), rope_theta)
    qg = qf.reshape(B, KV, g, hd) / math.sqrt(hd)
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k.float())
    slot = torch.arange(S, device=q.device)[None, :]
    valid = slot_visibility(slot, posb, seq_k=S, window=window, ring=ring,
                            offset=off)                       # (B, S)
    valid = valid[:, None, None, :]
    p = torch.softmax(logits.masked_fill(~valid, NEG_INF), dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# paged decode and the int8 pool
# ---------------------------------------------------------------------------


def quantize_slots(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-slot symmetric int8 over the last (head) dim, the rule of
    ``repro.serving.engine._slot_scales`` and the quantized decode write:
    ``scale = max(max|x|, 1e-8) / 127`` and ``codes = clip(round(x /
    scale), -127, 127)``, all in f32 (``torch.round`` rounds half to even,
    as ``jnp.round`` does). x: (..., hd) -> (codes (..., hd) int8,
    scale (...) f32)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    codes = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return codes.to(torch.int8), scale


def flash_decode_paged_ref(q: Tensor, kp: Tensor, vp: Tensor, pt: Tensor,
                           pos: Union[int, Tensor], *,
                           window: Optional[int] = None,
                           offsets: Optional[Tensor] = None,
                           k_scale: Optional[Tensor] = None,
                           v_scale: Optional[Tensor] = None,
                           rope_theta: Optional[float] = None) -> Tensor:
    """One query row per sequence against a paged cache: the port of
    ``repro.kernels.flash_decode.flash_decode_paged_blockwise``, a loop over
    logical blocks that gathers ONE page per row per step (``kp[pt[:, i]]``)
    under an online softmax. q: (B, H, hd); kp, vp: (pages, KV, ps, hd);
    pt: (B, NB) int -> (B, H, hd) in q.dtype.

    Row b's logical slot s lives at ``kp[pt[b, s // ps], :, s % ps]`` and is
    visible by :func:`slot_visibility` (no ring, ``seq_k = NB * ps``).
    ``k_scale``/``v_scale`` (pages, KV, ps) f32 mark an int8 pool,
    dequantized in f32 at the gather. ``rope_theta`` rotates q by
    ``pos - offsets`` first. Every ``pt`` entry must lie in [0, pages): the
    caller's contract, which the CUDA kernel cannot check without a host
    sync. A row that sees no slot is the mean of V over all NB * ps logical
    slots, as the reference's oracle (the gathered cache through
    ``flash_decode_ref``) gives it."""
    B, H, hd = q.shape
    KV, ps = kp.shape[1], kp.shape[2]
    NB = pt.shape[1]
    g = H // KV
    posb = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    posb = posb.to(torch.int64)[:, None]                      # (B, 1)
    off = None if offsets is None else offsets.to(torch.int64)[:, None]
    qf = q.float()
    if rope_theta is not None:
        qpos = posb if off is None else posb - off
        qf = rope_rotate(qf, qpos.expand(B, H), rope_theta)
    qg = qf.reshape(B, KV, g, hd) * (1.0 / math.sqrt(hd))
    m = torch.full((B, KV, g), NEG_INF, device=q.device)
    l = torch.zeros((B, KV, g), device=q.device)
    acc = torch.zeros((B, KV, g, hd), device=q.device)
    slots = torch.arange(ps, device=q.device)
    for i in range(NB):
        ids = pt[:, i].long()
        kb, vb = kp[ids].float(), vp[ids].float()             # (B,KV,ps,hd)
        if k_scale is not None:
            kb = kb * k_scale[ids][..., None]
            vb = vb * v_scale[ids][..., None]
        s = torch.einsum("bkgd,bksd->bkgs", qg, kb)
        mask = slot_visibility(i * ps + slots[None, :], posb, seq_k=NB * ps,
                               window=window, ring=False, offset=off)
        s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum("bkgs,bksd->bkgd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# mamba chunk scan
# ---------------------------------------------------------------------------


def mamba_chunk_ref(xc: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor,
                    A: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """One chunk of the selective scan, step by step in f32:
    ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``, ``y_t = h_t . C_t``.

    xc, dt: (B, c, di); Bm, Cm: (B, c, ds); A: (di, ds); h0: (B, di, ds).
    Returns (y (B, c, di) f32, h_last (B, di, ds) f32)."""
    xc, dt, Bm, Cm, A, h = (t.float() for t in (xc, dt, Bm, Cm, A, h0))
    ys = []
    for t in range(xc.shape[1]):
        dt_t = dt[:, t]
        a = torch.exp(dt_t[:, :, None] * A)                  # (B, di, ds)
        h = a * h + (dt_t * xc[:, t])[:, :, None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def mamba_chunk_backward_ref(xc: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor,
                             A: Tensor, h0: Tensor, dy: Tensor,
                             dh_last: Tensor) -> Tuple[Tensor, ...]:
    """VJP of :func:`mamba_chunk_ref` w.r.t. all six inputs, by autograd
    through it. dy (B, c, di) and dh_last (B, di, ds) are the cotangents of
    y and h_last. Returns (dxc, ddt, dB, dC, dA, dh0), each in its input's
    dtype, as ``mamba_chunk_backward_pallas`` returns them."""
    ins = [t.detach().requires_grad_(True) for t in (xc, dt, Bm, Cm, A, h0)]
    with torch.enable_grad():
        y, h = mamba_chunk_ref(*ins)
        grads = torch.autograd.grad((y, h), ins, (dy.float(),
                                                  dh_last.float()))
    return tuple(g.to(t.dtype) for g, t in zip(grads, (xc, dt, Bm, Cm, A,
                                                       h0)))
