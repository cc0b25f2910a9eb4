"""Mamba-1 selective state-space mixer (the port of ``repro.models.ssm``).

Training and prefill walk the sequence in chunks of ``DEFAULT_CHUNK`` steps
carrying the (B, d_inner, d_state) state from chunk to chunk:

- ``use_kernels=True``: each chunk is one call of the CUDA chunk-scan kernel
  (:func:`repro_torch.kernels.ops.mamba_chunk`, its plain sequential version
  on the CPU), differentiable through the backward kernel, which recomputes
  the chunk's states on chip: nothing (B, chunk, d_inner, d_state)-sized is
  kept for the backward.
- ``use_kernels=False``: the reference's parallel in-chunk scan, written as
  a log-step doubling (Hillis-Steele) scan in torch (``lax.associative_scan``
  has no torch counterpart). It materialises (B, chunk, d_inner, d_state)
  tensors, as the reference's plain path does.

Decode is the O(1)-per-token recurrence with a conv state of the last
``d_conv - 1`` inputs, in plain torch (no kernel on the reference's decode
either). Unlike the JAX package, the block updates its decode cache in
place.

The softplus of dt is ``F.softplus``, which returns x itself above 20;
``jax.nn.softplus`` has no threshold. There the two differ by
log1p(exp(-x)) < 2.1e-9, below an f32 ulp of x.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, rows_matmul

Params = Dict[str, Any]
Tensor = torch.Tensor

DEFAULT_CHUNK = 256


def ssm_init(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    dtr = s.resolved_dt_rank(d)
    dev = gen.device
    # S4/Mamba init: A = -(1..d_state) broadcast over channels
    a = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(di, 1)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype=dtype),
        "conv_w": dense_init(gen, (s.d_conv, di), scale=0.5, dtype=dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (di, dtr + 2 * s.d_state), dtype=dtype),
        "dt_proj": dense_init(gen, (dtr, di), dtype=dtype),
        "dt_bias": torch.full((di,), -4.6, device=dev),  # softplus ~ 0.01
        "A_log": torch.log(a),
        "D": torch.ones((di,), device=dev),
        "out_proj": dense_init(gen, (di, d), dtype=dtype),
    }


def _split_in(params: Params, cfg: ModelConfig, x: Tensor
              ) -> Tuple[Tensor, Tensor]:
    di = cfg.ssm.d_inner(cfg.d_model)
    xz = x @ params["in_proj"].to(x.dtype)
    return xz[..., :di], xz[..., di:]


def _bcdt(params: Params, cfg: ModelConfig, xc: Tensor
          ) -> Tuple[Tensor, Tensor, Tensor]:
    """xc: (..., di) post-conv activations -> (dt, B, C) selective params,
    all f32."""
    s = cfg.ssm
    dtr = s.resolved_dt_rank(cfg.d_model)
    proj = rows_matmul(xc, params["x_proj"].to(xc.dtype))
    dt_in = proj[..., :dtr]
    Bm = proj[..., dtr:dtr + s.d_state]
    Cm = proj[..., dtr + s.d_state:]
    dt = F.softplus((dt_in @ params["dt_proj"].to(xc.dtype)).float()
                    + params["dt_bias"])
    return dt, Bm.float(), Cm.float()


def _causal_conv_full(params: Params, cfg: ModelConfig, x: Tensor,
                      conv_state: Optional[Tensor] = None) -> Tensor:
    """Depthwise causal conv over (B, S, di)."""
    k = cfg.ssm.d_conv
    w = params["conv_w"].to(x.dtype)                 # (k, di)
    if conv_state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(k))
    return out + params["conv_b"].to(x.dtype)


def _chunk_scan(a: Tensor, b: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """Within-chunk parallel scan of h_t = a_t * h_{t-1} + b_t, by doubling:
    after the step of width w every position holds the composition of the
    (up to) 2w steps ending at it.

    a, b: (B, c, di, ds); h0: (B, di, ds). Returns (h_all (B, c, di, ds),
    h_last)."""
    c = a.shape[1]
    w = 1
    while w < c:
        # (a1, b1) then (a2, b2) compose to (a1 a2, a2 b1 + b2)
        b = torch.cat([b[:, :w], a[:, w:] * b[:, :-w] + b[:, w:]], dim=1)
        a = torch.cat([a[:, :w], a[:, w:] * a[:, :-w]], dim=1)
        w *= 2
    h_all = a * h0[:, None] + b
    return h_all, h_all[:, -1]


def ssm_forward(params: Params, cfg: ModelConfig, x: Tensor,
                chunk: int = DEFAULT_CHUNK, use_kernels: bool = False,
                valid: Optional[Tensor] = None, return_state: bool = False):
    """Full-sequence mamba mixer. x: (B, S, d_model) -> (B, S, d_model).

    ``valid`` (B, S) bool masks left-padded ragged prompts: invalid
    positions contribute zero conv taps (the causal zero-padding an
    unpadded run sees before its first token) and identity state updates
    (``dt = 0`` => a = 1, b = 0), so the carried state matches the unpadded
    per-sequence run; outputs at invalid positions are garbage and must be
    discarded by the caller.

    ``return_state=True`` also returns the decode cache ``{"h", "conv"}`` at
    the last position, the fused-prefill handoff to :func:`ssm_decode`."""
    B, S, _ = x.shape
    dt_ = x.dtype
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    xin, z = _split_in(params, cfg, x)
    if valid is not None:
        xin = torch.where(valid[..., None], xin, 0)
    xc = F.silu(_causal_conv_full(params, cfg, xin))
    dt, Bmat, Cmat = _bcdt(params, cfg, xc)          # (B,S,di) (B,S,ds) x2
    if valid is not None:
        dt = torch.where(valid[..., None], dt, 0.0)
    A = -torch.exp(params["A_log"])                  # (di, ds)

    c = min(chunk, S)
    # pad to a chunk multiple (padded steps have dt=0 -> identity updates)
    pad = (c - S % c) % c
    xc_p, dt_p, B_p, C_p = (F.pad(t, (0, 0, 0, pad)) if pad else t
                            for t in (xc, dt, Bmat, Cmat))
    h = torch.zeros((B, di, s.d_state), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(0, S + pad, c):
        xc_c, dt_c = xc_p[:, i:i + c], dt_p[:, i:i + c]
        B_c, C_c = B_p[:, i:i + c], C_p[:, i:i + c]
        if use_kernels:
            y_c, h = kops.mamba_chunk(xc_c.float(), dt_c, B_c, C_c, A, h)
        else:
            a = torch.exp(dt_c[..., None] * A)                  # (B,c,di,ds)
            b = (dt_c * xc_c.float())[..., None] * B_c[:, :, None, :]
            h_all, h = _chunk_scan(a, b, h)
            y_c = torch.einsum("bcds,bcs->bcd", h_all, C_c)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + params["D"] * xc.float()
    y = y.to(dt_) * F.silu(z)
    out = rows_matmul(y, params["out_proj"].to(dt_))
    if not return_state:
        return out
    # decode handoff: conv state = the last d_conv-1 (masked) inputs, padded
    # with the same causal zeros a fresh sequence starts from
    k = s.d_conv - 1
    conv = xin[:, S - k:] if S >= k else F.pad(xin, (0, 0, k - S, 0))
    return out, {"h": h, "conv": conv.to(dt_)}


def ssm_prefill(params: Params, cfg: ModelConfig, x: Tensor, *,
                valid: Optional[Tensor] = None,
                use_kernels: bool = False) -> Tuple[Tensor, Params]:
    """Fused prefill: the full-sequence mixer that also returns the decode
    cache ``{"h", "conv"}`` ready for :func:`ssm_decode`."""
    return ssm_forward(params, cfg, x, use_kernels=use_kernels, valid=valid,
                       return_state=True)


# -- decode ------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, batch: int, device=None) -> Params:
    """The decode cache, both leaves f32 as the reference's block keeps
    them: the state (B, d_inner, d_state) and the last d_conv - 1 inputs
    (B, d_conv - 1, d_inner)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    return {
        "h": torch.zeros((batch, di, s.d_state), device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, di), device=device),
    }


def ssm_decode(params: Params, cfg: ModelConfig, x: Tensor,
               cache: Params) -> Tuple[Tensor, Params]:
    """One-token recurrent step. x: (B, 1, d_model) -> (out, new cache)."""
    dt_ = x.dtype
    xin, z = _split_in(params, cfg, x)               # (B,1,di)
    xc = F.silu(_causal_conv_full(params, cfg, xin, conv_state=cache["conv"]))
    new_conv = torch.cat([cache["conv"][:, 1:],
                          xin.to(cache["conv"].dtype)], dim=1)
    dt, Bmat, Cmat = _bcdt(params, cfg, xc)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt[:, 0, :, None] * A)             # (B,di,ds)
    b = (dt[:, 0] * xc[:, 0].float())[..., None] * Bmat[:, 0, None, :]
    h = a * cache["h"] + b
    y = torch.einsum("bds,bs->bd", h, Cmat[:, 0])
    y = y + params["D"] * xc[:, 0].float()
    y = y[:, None].to(dt_) * F.silu(z)
    out = rows_matmul(y, params["out_proj"].to(dt_))
    return out, {"h": h, "conv": new_conv}
