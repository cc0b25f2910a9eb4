"""Decoder layers (the port of ``repro.models.layers``): RMSNorm and
LayerNorm, half-split RoPE, GQA self-attention over a full sequence
(training, the encoder) and over a KV cache (fused prefill and one-token
decode), cross-attention into an encoder or vision memory, and the SwiGLU
MLP.

Layers are functions over explicit parameter trees, as in the JAX package:
``params = <layer>_init(gen, ...)``, ``y = <layer>_apply(params, x, ...)``.
Weights are drawn from an explicit ``torch.Generator`` on the device the
tree lives on. Compute happens in the activations' dtype (bf16 at full
width, f32 in the parity tests); norm scales are f32.

``use_kernels=True`` takes the reference's kernel structure: the training
attention with RoPE fused into the flash kernel, a head-major cache
(``kh``/``vh``), the query's RoPE rotation fused into the decode kernel
and the cached key rotated when written, the flash prefill with the ragged
``kv_offsets`` mask, the fused residual-add + RMSNorm and the fused
SwiGLU, each differentiable through its backward kernel.
``use_kernels=False`` is the reference's plain path (``_sdpa``, the
block-local window attention, a seq-major cache). Unlike the JAX package,
a cache is updated IN PLACE and returned: decode then allocates nothing
cache-sized.

A paged cache (``kp``/``vp`` page pool, ``pt`` block tables, and for an
int8 pool the ``ks``/``vs`` per-slot scales) is the continuous-batching
engine's layout; decode writes into it in place and attends through the
paged decode kernel (kernels) or a gather of every row's pages (plain).

Cross-attention projects the memory's K/V once (``cross_kv``; a decode
cache holds them) and attends with the plain ``_sdpa`` and no mask over
the memory, as the reference does: no Pallas kernel computes it there.
The encoder's non-causal self-attention, and any ``segment_mask``, take
the plain path too (the reference's kernel condition is causal and
unmasked). LayerNorm has no kernel: it is the plain two-pass norm with
kernels on too.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_decode import slot_visibility
from repro_torch.kernels.ref import quantize_slots

Params = Dict[str, Any]
Tensor = torch.Tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> Tensor:
    """Scaled normal init (``1/sqrt(fan_in)`` unless given), drawn in f32 on
    the generator's device and cast, as ``repro.models.layers.dense_init``."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0], 1))
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (scale * w).to(dtype)


# On the card, cuBLAS splits the reduction of a bf16 product over a long K
# (8192: falcon-mamba's d_inner, seamless's d_ff) across blocks when it has
# few rows (a short prompt, a decode step), and a row's rounding then
# depends on how many rows came with it, so a left-padded batch row parts
# from its solo run. With 512 rows or more it took one order (chip_smoke.py's
# phase 16 probe and scripts/memory_invariance.py count both).
INVARIANT_ROWS = 512


def rows_matmul(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` over (..., K) rows, computed on at least INVARIANT_ROWS
    rows (zero rows appended, their products dropped), so that a row's
    result does not depend on the rows computed beside it."""
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    if n < INVARIANT_ROWS:
        rows = F.pad(rows, (0, 0, 0, INVARIANT_ROWS - n))
    return (rows @ w)[:n].reshape(*x.shape[:-1], w.shape[1])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device: torch.device) -> Params:
    return {"scale": torch.ones(d, device=device)}


def rmsnorm_apply(params: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, device: torch.device) -> Params:
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def layernorm_apply(params: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


def norm_init(cfg: ModelConfig, d: int, device: torch.device) -> Params:
    if cfg.norm.kind == "layernorm":
        return layernorm_init(d, device)
    return rmsnorm_init(d, device)


def norm_apply(cfg: ModelConfig, params: Params, x: Tensor, *,
               use_kernels: bool = False) -> Tensor:
    """The config's norm over the model width. With kernels an RMSNorm runs
    in the fused norm kernel with no residual: one block reduces one row in
    a fixed order, so a row's result does not depend on how many rows the
    batch holds (torch's mean over d_model splits its reduction by the
    number of rows, and a last-bit difference there flips a bf16 rounding
    now and then), which is what lets a ContinuousEngine row equal its solo
    run. LayerNorm is always the plain two-pass norm."""
    if cfg.norm.kind == "layernorm":
        return layernorm_apply(params, x, cfg.norm.eps)
    if use_kernels:
        return kops.rmsnorm_residual(x, None, params["scale"],
                                     eps=cfg.norm.eps)[0]
    return rmsnorm_apply(params, x, cfg.norm.eps)


def norm_residual_apply(cfg: ModelConfig, params: Params, x: Tensor,
                        r: Tensor, *, use_kernels: bool = False
                        ) -> Tuple[Tensor, Tensor]:
    """``(norm(x + r), x + r)``: the next sublayer's input and the new
    residual stream; one fused kernel pass with kernels on (RMSNorm only:
    LayerNorm adds, then norms)."""
    if use_kernels and cfg.norm.kind == "rmsnorm":
        return kops.rmsnorm_residual(x, r, params["scale"], eps=cfg.norm.eps)
    s = x + r
    return norm_apply(cfg, params, s), s


# ---------------------------------------------------------------------------
# rotary position embedding (half-rotation / llama convention)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = (positions[..., None].float() * freqs)[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_init(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype=dtype),
        "wk": dense_init(gen, (d, kv * hd), dtype=dtype),
        "wv": dense_init(gen, (d, kv * hd), dtype=dtype),
        "wo": dense_init(gen, (h * hd, d), dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, gen.device)
        p["k_norm"] = rmsnorm_init(hd, gen.device)
    return p


def _project_qkv(params: Params, cfg: ModelConfig, x: Tensor,
                 positions: Optional[Tensor], rope: bool = True
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    B, T = x.shape[0], x.shape[1]
    hd = cfg.head_dim
    dt = x.dtype
    h = params["wq"].shape[-1] // hd
    kv = params["wk"].shape[-1] // hd
    q = (x @ params["wq"].to(dt)).reshape(B, T, h, hd)
    k = (x @ params["wk"].to(dt)).reshape(B, T, kv, hd)
    v = (x @ params["wv"].to(dt)).reshape(B, T, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm_apply(params["q_norm"], q, cfg.norm.eps)
        k = rmsnorm_apply(params["k_norm"], k, cfg.norm.eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor]) -> Tensor:
    """q: (B,T,h,hd); k,v: (B,S,kv,hd), kv heads repeated to h. mask:
    broadcastable to (B, T, S), True = attend."""
    B, T, h, hd = q.shape
    S, kv = k.shape[1], k.shape[2]
    if h // kv > 1:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(hd)
    if mask is not None:
        m = mask.expand((B,) + tuple(mask.shape[-2:]))
        logits = logits.masked_fill(~m[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _sdpa_grouped(q: Tensor, k: Tensor, v: Tensor,
                  mask: Optional[Tensor]) -> Tensor:
    """Decode attention without repeating K/V to full heads: q (B,T,h,hd);
    k,v (B,S,kv,hd); GQA by a grouped einsum."""
    B, T, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(B, T, kv, h // kv, hd)
    logits = torch.einsum("btkgd,bskd->bktgs", qg, k).float() / math.sqrt(hd)
    if mask is not None:
        m = mask.expand((B,) + tuple(mask.shape[-2:]))
        logits = logits.masked_fill(~m[:, None, :, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bktgs,bskd->btkgd", probs, v)
    return out.reshape(B, T, h, hd)


def causal_mask(T: int, S: int, device=None) -> Tensor:
    """True where query t may attend key s."""
    qi = torch.arange(T, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    return ki <= qi


def window_mask(T: int, S: int, window: int, device=None) -> Tensor:
    qi = torch.arange(T, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    return (ki <= qi) & (ki > qi - window)


def _local_attention(q: Tensor, k: Tensor, v: Tensor, window: int,
                     dtype: torch.dtype) -> Tensor:
    """Block-local sliding-window attention with O(T * 2*window) cost, as
    ``repro.models.layers._local_attention``: T is padded to a multiple of
    ``window``; each query block attends its own and the previous key
    block, masked to exactly ``window`` history."""
    B, T, h, hd = q.shape
    kv = k.shape[2]
    W = window
    Tp = (T + W - 1) // W * W
    pad = Tp - T
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    nb = Tp // W
    if h // kv > 1:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    qb = q.reshape(B, nb, W, h, hd)
    kb = k.reshape(B, nb, W, h, hd)
    vb = v.reshape(B, nb, W, h, hd)
    # keys for block i = concat(block i-1, block i): (B, nb, 2W, h, hd)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1),
                    kb], dim=2)
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1),
                    vb], dim=2)
    logits = torch.einsum("bnwhd,bnshd->bnhws", qb, k2).float() / math.sqrt(hd)
    # in-block relative positions: query w (0..W-1) at global offset W + w
    qi = torch.arange(W, device=q.device)[:, None] + W
    ki = torch.arange(2 * W, device=q.device)[None, :]
    m = (ki <= qi) & (ki > qi - W)                          # (W, 2W)
    # the first block has no previous block
    first = torch.arange(nb, device=q.device)[:, None, None] > 0
    m = m[None] & (first | (ki[None] >= W))                 # (nb, W, 2W)
    logits = logits.masked_fill(~m[None, :, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bnhws,bnshd->bnwhd", probs, v2)
    return out.reshape(B, Tp, h, hd)[:, :T]


def attention_full(params: Params, cfg: ModelConfig, x: Tensor,
                   positions: Tensor, *, window: Optional[int] = None,
                   causal: bool = True,
                   segment_mask: Optional[Tensor] = None,
                   use_kernels: bool = False) -> Tensor:
    """Self-attention over a full sequence (training, the encoder). x: (B,
    T, D); positions: (B, T); ``segment_mask`` (T, T) or (B, T, T), True =
    attend, is and-ed into the causal (or all-true) mask. With kernels, a
    causal call with no segment mask runs in the flash kernel, which
    rotates q and k on its loads; otherwise the plain path applies RoPE,
    then ``_sdpa`` with the mask, or the block-local attention for a
    window shorter than half the sequence."""
    B, T, _ = x.shape
    if use_kernels and causal and segment_mask is None:
        q, k, v = _project_qkv(params, cfg, x, positions, rope=False)
        out = kops.flash_attention_rope(q, k, v, positions,
                                        theta=cfg.rope_theta, causal=True,
                                        window=window)
        return out.reshape(B, T, -1) @ params["wo"].to(x.dtype)
    q, k, v = _project_qkv(params, cfg, x, positions)
    if window is not None and causal and T > 2 * window \
            and segment_mask is None:
        out = _local_attention(q, k, v, window, x.dtype)
    else:
        if causal:
            m = (window_mask(T, T, window, device=x.device)
                 if window is not None else causal_mask(T, T, device=x.device))
        else:
            m = torch.ones((T, T), dtype=torch.bool, device=x.device)
        if segment_mask is not None:
            m = m & segment_mask
        out = _sdpa(q, k, v, m if m.dim() == 3 else m[None])
    return out.reshape(B, T, -1) @ params["wo"].to(x.dtype)


# -- KV cache -----------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: Optional[int] = None,
                  dtype: torch.dtype = torch.bfloat16, layout: str = "seq",
                  page_size: int = 64, total_pages: Optional[int] = None,
                  cache_dtype: Optional[str] = None,
                  device=None, kv_heads: Optional[int] = None) -> Params:
    """KV cache of one attention layer: a ring of ``min(max_len, window)``
    slots for sliding-window layers, ``max_len`` slots otherwise, of
    ``kv_heads`` kv heads (default ``cfg.n_kv_heads``; a rank of a
    model-sharded engine holds its share).

    - ``layout="seq"``: ``k``/``v`` (B, S, kv, hd), the plain path's.
    - ``layout="head"``: ``kh``/``vh`` (B, kv, S, hd), the decode kernel's.
    - ``layout="paged"``: a page pool ``kp``/``vp`` (total_pages, kv,
      page_size, hd) and int32 block tables ``pt`` (B, ceil(max_len /
      page_size)) mapping row b's logical block i to a page. Page 0 is the
      trash page: unallocated and retired table entries point at it and no
      visible slot ever maps there. ``total_pages`` defaults to
      ``1 + batch * n_blocks``. A sliding-window layer keeps its
      head-major ring (``kh``/``vh``).

    ``cache_dtype="int8"`` (paged only) stores the pool as int8 codes with
    f32 per-slot scales ``ks``/``vs`` (total_pages, kv, page_size); the
    window ring stays in ``dtype``."""
    if cache_dtype not in (None, "int8"):
        raise ValueError(f"unknown cache_dtype: {cache_dtype!r}")
    if cache_dtype == "int8" and layout != "paged":
        raise ValueError(
            "cache_dtype='int8' requires layout='paged' (the contiguous "
            "layouts have no per-slot scale planes)")
    if layout not in ("seq", "head", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")
    S = min(max_len, window) if window is not None else max_len
    kv = cfg.n_kv_heads if kv_heads is None else kv_heads
    hd = cfg.head_dim
    if layout == "paged" and window is None:
        nb = -(-max_len // page_size)
        pages = total_pages if total_pages is not None else 1 + batch * nb
        pool = (pages, kv, page_size, hd)
        pool_dtype = torch.int8 if cache_dtype == "int8" else dtype
        c = {n: torch.zeros(pool, dtype=pool_dtype, device=device)
             for n in ("kp", "vp")}
        if cache_dtype == "int8":
            for n in ("ks", "vs"):
                c[n] = torch.zeros(pool[:3], dtype=torch.float32,
                                   device=device)
        c["pt"] = torch.zeros((batch, nb), dtype=torch.int32, device=device)
        return c
    head = layout in ("head", "paged")
    shape = (batch, kv, S, hd) if head else (batch, S, kv, hd)
    keys = ("kh", "vh") if head else ("k", "v")
    return {n: torch.zeros(shape, dtype=dtype, device=device) for n in keys}


def _cache_kv(cache: Params) -> Tuple[Tensor, Tensor, bool]:
    """(k, v, head_major) for either cache layout."""
    if "kh" in cache:
        return cache["kh"], cache["vh"], True
    return cache["k"], cache["v"], False


def _cache_valid_mask(pos: Union[int, Tensor], S: int, *, ring: bool,
                      offsets: Optional[Tensor], device=None) -> Tensor:
    """(B?, S) visibility of cache slots at query position ``pos`` (an int
    or a per-row (B, 1) tensor), by the decode kernel's own predicate.
    Window membership is implied by the ring depth."""
    idx = torch.arange(S, device=device)[None, :]
    return slot_visibility(
        idx, pos, seq_k=S, window=None, ring=ring,
        offset=None if offsets is None else offsets[:, None])


def _paged_decode(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor,
                  cache: Params, posb: Tensor, *, window: Optional[int],
                  offsets: Optional[Tensor], use_kernels: bool) -> Tensor:
    """Write this token's K/V into row b's page ``pt[b, pos_b // ps]`` at
    slot ``pos_b % ps`` (in place; an int8 pool quantizes per slot first),
    then attend: the paged decode kernel with the query's RoPE fused in, or
    a gather of every row's pages and the grouped einsum. A retired row
    whose table was zeroed writes into the trash page 0. Returns
    (B, 1, h, hd)."""
    kp, vp, pt = cache["kp"], cache["vp"], cache["pt"]
    quantized = "ks" in cache
    B, kv, hd = q.shape[0], kp.shape[1], kp.shape[3]
    ps, NB = kp.shape[2], pt.shape[1]
    b_idx = torch.arange(B, device=q.device)
    page = pt[b_idx, (posb // ps).clamp(0, NB - 1)].long()          # (B,)
    slot = posb % ps
    ks_ = vs_ = None
    if quantized:
        ks_, vs_ = cache["ks"], cache["vs"]
        kq, ksc = quantize_slots(k[:, 0])                # (B, kv, hd), (B, kv)
        vq, vsc = quantize_slots(v[:, 0])
        kp[page, :, slot] = kq
        vp[page, :, slot] = vq
        ks_[page, :, slot] = ksc
        vs_[page, :, slot] = vsc
    else:
        kp[page, :, slot] = k[:, 0].to(kp.dtype)
        vp[page, :, slot] = v[:, 0].to(vp.dtype)
    if use_kernels:
        return kops.flash_decode_paged(q, kp, vp, pt, posb.int(),
                                       window=window, offsets=offsets,
                                       k_scale=ks_, v_scale=vs_,
                                       rope_theta=cfg.rope_theta)
    S = NB * ps
    rows = pt.long()

    def gather(pool: Tensor, scales: Optional[Tensor]) -> Tensor:
        g = pool[rows].permute(0, 2, 1, 3, 4).reshape(B, kv, S, hd)
        if scales is not None:
            sc = scales[rows].permute(0, 2, 1, 3).reshape(B, kv, S, 1)
            g = g.float() * sc
        return g.to(q.dtype).transpose(1, 2)                 # (B, S, kv, hd)

    m = slot_visibility(
        torch.arange(S, device=q.device)[None, :], posb[:, None], seq_k=S,
        window=window, ring=False,
        offset=None if offsets is None else offsets[:, None])
    return _sdpa_grouped(q, gather(kp, ks_), gather(vp, vs_), m[:, None, :])


def attention_decode(params: Params, cfg: ModelConfig, x: Tensor,
                     cache: Params, pos: Union[int, Tensor], *,
                     window: Optional[int] = None,
                     offsets: Optional[Tensor] = None,
                     use_kernels: bool = False) -> Tuple[Tensor, Params]:
    """One-token decode. x: (B, 1, D); pos: an int (every row at one
    position) or a per-row (B,) tensor. ``offsets`` (B,) are the left pads
    of ragged prompts: RoPE positions are ``pos - offsets`` and earlier
    slots are masked. Writes this token's K/V into ``cache`` in place; a
    paged cache (``pt`` in it) takes :func:`_paged_decode`. The head
    counts are the projections' (a tensor-parallel rank holds a share of
    them) and the cache's. Returns (y (B, 1, D), cache)."""
    B = x.shape[0]
    hd = cfg.head_dim
    h = params["wq"].shape[-1] // hd
    dev = x.device
    vector_pos = isinstance(pos, Tensor)
    if vector_pos:
        posb = pos.reshape(-1).expand(B).long()
    else:
        posb = torch.full((B,), int(pos), device=dev, dtype=torch.long)
    positions = (posb if offsets is None else posb - offsets)[:, None]
    # kernels fuse the query rotation into the decode kernel; only the key
    # still needs its write-time rotation here
    q, k, v = _project_qkv(params, cfg, x, positions, rope=not use_kernels)
    if use_kernels:
        k = apply_rope(k, positions, cfg.rope_theta)

    if "pt" in cache:                  # paged pool + per-row block tables
        out = _paged_decode(cfg, q, k, v, cache, posb, window=window,
                            offsets=offsets, use_kernels=use_kernels)
        y = out.reshape(B, 1, h * hd) @ params["wo"].to(x.dtype)
        return y, cache

    ck, cv, head_major = _cache_kv(cache)
    S = ck.shape[2 if head_major else 1]
    if vector_pos:
        slot = posb % S if window is not None else posb
        b_idx = torch.arange(B, device=dev)
        if head_major:
            ck[b_idx, :, slot] = k[:, 0].to(ck.dtype)
            cv[b_idx, :, slot] = v[:, 0].to(cv.dtype)
        else:
            ck[b_idx, slot] = k[:, 0].to(ck.dtype)
            cv[b_idx, slot] = v[:, 0].to(cv.dtype)
    else:
        slot = pos % S if window is not None else pos
        if head_major:
            ck[:, :, slot] = k[:, 0].to(ck.dtype)
            cv[:, :, slot] = v[:, 0].to(cv.dtype)
        else:
            ck[:, slot] = k[:, 0].to(ck.dtype)
            cv[:, slot] = v[:, 0].to(cv.dtype)
    ring = window is not None
    if use_kernels:
        khm = ck if head_major else ck.transpose(1, 2).contiguous()
        vhm = cv if head_major else cv.transpose(1, 2).contiguous()
        out = kops.flash_decode(q, khm.to(q.dtype), vhm.to(q.dtype),
                                posb.int() if vector_pos else pos,
                                window=window, ring=ring, offsets=offsets,
                                rope_theta=cfg.rope_theta)
    else:
        valid = _cache_valid_mask(posb[:, None] if vector_pos else pos, S,
                                  ring=ring, offsets=offsets, device=dev)
        m = valid.expand(B, S)[:, None, :]
        ks = ck.transpose(1, 2) if head_major else ck
        vs = cv.transpose(1, 2) if head_major else cv
        out = _sdpa_grouped(q, ks.to(q.dtype), vs.to(q.dtype), m)
    y = out.reshape(B, 1, h * hd) @ params["wo"].to(x.dtype)
    return y, cache


def attention_prefill(params: Params, cfg: ModelConfig, x: Tensor,
                      positions: Tensor, cache: Params, *,
                      window: Optional[int] = None,
                      offsets: Optional[Tensor] = None,
                      use_kernels: bool = False) -> Tuple[Tensor, Params]:
    """Fused prefill of one attention layer: full-sequence attention that
    also writes every position's K/V into the cache (in place).

    x: (B, P, D); positions: (B, P) RoPE positions (already offset for
    left-padded prompts). Full caches take tokens 0..P-1 at slots 0..P-1;
    ring caches keep the last ``min(P, ring)`` tokens at slots ``t % ring``.
    Returns (y (B, P, D), cache)."""
    B, P, _ = x.shape
    if "pt" in cache:
        raise ValueError("a paged cache is filled by ContinuousEngine's "
                         "admission: prefill a contiguous cache and scatter "
                         "it into the pages")
    q, k, v = _project_qkv(params, cfg, x, positions)
    ck, cv, head_major = _cache_kv(cache)
    seq_ax = 2 if head_major else 1
    S = ck.shape[seq_ax]
    if window is None and P > S:
        raise ValueError(f"prompt of {P} tokens exceeds the cache depth {S}")

    def fill(c: Tensor, t: Tensor) -> None:
        if head_major:
            t = t.transpose(1, 2)
        if P <= S:
            c.narrow(seq_ax, 0, P).copy_(t)
        else:       # ring wrap: token at global position g lands at g % S
            tail = t.narrow(seq_ax, P - S, S)
            c.copy_(torch.roll(tail, (P - S) % S, dims=seq_ax))

    fill(ck, k)
    fill(cv, v)
    if use_kernels:
        out = kops.flash_attention(q, k, v, causal=True, window=window,
                                   kv_offsets=offsets)
    else:
        m = (window_mask(P, P, window, device=x.device) if window is not None
             else causal_mask(P, P, device=x.device))[None]
        if offsets is not None:
            m = m & (torch.arange(P, device=x.device)[None, None, :]
                     >= offsets[:, None, None])
        out = _sdpa(q, k, v, m)
    y = out.reshape(B, P, -1) @ params["wo"].to(x.dtype)
    return y, cache


# -- cross-attention ------------------------------------------------------------


def cross_attention_init(gen: torch.Generator, cfg: ModelConfig,
                         dtype: torch.dtype) -> Params:
    return attention_init(gen, cfg, dtype)


def cross_kv(params: Params, cfg: ModelConfig, memory: Tensor
             ) -> Tuple[Tensor, Tensor]:
    """Project the (encoder or vision) memory (B, S, D) once, in its dtype:
    K and V (B, S, kv, hd), which a decode cache keeps."""
    B, S, _ = memory.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    dt = memory.dtype
    k = (memory @ params["wk"].to(dt)).reshape(B, S, kv, hd)
    v = (memory @ params["wv"].to(dt)).reshape(B, S, kv, hd)
    return k, v


def cross_attention_apply(params: Params, cfg: ModelConfig, x: Tensor,
                          k: Tensor, v: Tensor) -> Tensor:
    """x: (B, T, D) queries; k, v: the projected memory (B, S, kv, hd).
    No RoPE and no mask; under ``qk_norm`` only the query is normed, as in
    the reference."""
    B, T, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, T, h, hd)
    if cfg.qk_norm:
        q = rmsnorm_apply(params["q_norm"], q, cfg.norm.eps)
    out = _sdpa(q, k.to(dt), v.to(dt), None)
    return out.reshape(B, T, h * hd) @ params["wo"].to(dt)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, d_ff: int,
             dtype: torch.dtype) -> Params:
    return {
        "w_gate": dense_init(gen, (d, d_ff), dtype=dtype),
        "w_up": dense_init(gen, (d, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (d_ff, d), dtype=dtype),
    }


def mlp_apply(params: Params, x: Tensor, use_kernels: bool = False) -> Tensor:
    """SwiGLU: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``; with kernels
    the gated product runs in the SwiGLU kernel. The down projection
    reduces over d_ff (up to 21504) and runs on at least INVARIANT_ROWS
    rows (:func:`rows_matmul`)."""
    dt = x.dtype
    if use_kernels:
        h = kops.swiglu(x, params["w_gate"].to(dt), params["w_up"].to(dt))
    else:
        h = F.silu(x @ params["w_gate"].to(dt)) * (x @ params["w_up"].to(dt))
    return rows_matmul(h, params["w_down"].to(dt))
