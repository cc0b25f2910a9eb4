"""Top-level decoder of the serving path (the port of
``repro.models.transformer``): token embedding, the block stack and the LM
head, as a fused prefill and a one-token decode step against KV caches.
Both run through the kernels by default (``use_kernels=True``, head-major
caches); ``use_kernels=False`` is the reference's plain path over
seq-major caches.

The training forward and loss (``forward``, ``lm_loss``) come with the LM
training slice; encoder and vision memories with theirs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

Params = Dict[str, Any]
Tensor = torch.Tensor


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return L.torch_dtype(cfg.dtype)


def init_params(seed: int, cfg: ModelConfig, device: DeviceLike = None
                ) -> Params:
    """Random weights from ``seed``, drawn on ``device`` (the card unless
    told otherwise) in the config's dtype; norm scales are f32. A seed gives
    different weights on the CPU and on the card: to compare devices, draw
    once and move the tree."""
    if cfg.encoder is not None or cfg.vision is not None:
        raise NotImplementedError("encoder and vision memories come with the "
                                  "encoder/VLM slice")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = compute_dtype(cfg)
    Vp, d = cfg.padded_vocab, cfg.d_model
    p: Params = {
        "embed": L.dense_init(gen, (Vp, d), scale=0.02, dtype=dtype),
        "stack": B.stack_init(gen, cfg, dtype),
        "final_norm": L.norm_init(cfg, d, dev),
    }
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(gen, (Vp, d), scale=0.02, dtype=dtype)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype: Optional[torch.dtype] = None, layout: str = "head",
               page_size: int = 64, total_pages: Optional[int] = None,
               cache_dtype: Optional[str] = None,
               device: DeviceLike = None) -> Params:
    """Zeroed KV caches of every layer, ``max_len`` slots deep (a ring of
    ``sliding_window`` slots for "swa" layers). ``layout="head"`` is the
    decode kernel's (B, kv, S, hd); "seq" the plain path's (B, S, kv, hd);
    "paged" gives full-attention layers a page pool of ``total_pages``
    pages (the trash page 0 included) of ``page_size`` slots and one
    block table shared by every layer, for :class:`repro_torch.serving.
    ContinuousEngine`. ``cache_dtype="int8"`` stores the paged pool as
    per-slot int8 codes with f32 scales (``ks``/``vs``). ``dtype``
    defaults to the config's compute dtype."""
    dev = resolve_device(device)
    return B.stack_cache(cfg, batch, max_len, dtype or compute_dtype(cfg),
                         layout, page_size, total_pages, cache_dtype, dev)


def _logits(params: Params, cfg: ModelConfig, x: Tensor,
            use_kernels: bool) -> Tensor:
    x = L.norm_apply(cfg, params["final_norm"], x, use_kernels=use_kernels)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return x @ head.to(x.dtype).T


def decode_step(params: Params, cfg: ModelConfig, tokens: Tensor,
                cache: Params, pos: Union[int, Tensor], *,
                use_kernels: bool = True,
                offsets: Optional[Tensor] = None) -> Tuple[Tensor, Params]:
    """tokens: (B, 1) ids; pos: an int (every row at one position) or a
    per-row (B,) tensor -> (logits (B, 1, padded_vocab), cache). ``offsets``
    (B,) are the left pads of ragged prompts: RoPE positions shift to
    ``pos - offsets`` and the padded slots are masked."""
    x = F.embedding(tokens, params["embed"]).to(compute_dtype(cfg))
    x, cache = B.stack_apply(params["stack"], cfg, x, cache=cache, pos=pos,
                             decode=True, use_kernels=use_kernels,
                             offsets=offsets)
    return _logits(params, cfg, x, use_kernels), cache


def prefill_forward(params: Params, cfg: ModelConfig, tokens: Tensor,
                    cache: Params, *, use_kernels: bool = True,
                    offsets: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Params]:
    """Fused prefill: one full-sequence forward that writes every layer's
    K/V into the cache and returns the last position's logits.

    tokens: (B, P) -> (logits (B, 1, padded_vocab), cache). With
    ``offsets`` (left-padded ragged prompts) each row's RoPE positions
    start at its first real token and the padding is masked out of the
    attention, so the cache holds what each row would produce unpadded."""
    Bsz, P = tokens.shape
    x = F.embedding(tokens, params["embed"]).to(compute_dtype(cfg))
    positions = torch.arange(P, device=x.device)[None].expand(Bsz, P)
    if offsets is not None:
        positions = positions - offsets[:, None]
    if not cfg.causal:
        raise NotImplementedError("non-causal stacks come with the encoder "
                                  "slice")
    x, cache = B.stack_apply(params["stack"], cfg, x, cache=cache,
                             positions=positions, decode=False,
                             use_kernels=use_kernels, offsets=offsets)
    return _logits(params, cfg, x[:, -1:], use_kernels), cache
