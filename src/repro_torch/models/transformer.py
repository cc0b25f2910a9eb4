"""Top-level model (the port of ``repro.models.transformer``): token
embedding, the block stack and the LM head, and for the encoder-decoder
and vision-LM families the memory the cross blocks attend.

- Training: ``forward`` (logits), ``hidden_states`` and ``lm_loss`` (next-
  token cross-entropy, dense or vocab-chunked, plus the MoE router losses),
  differentiable; the reference's default ``use_kernels=False`` here too.
  Prefill and decode drop the router losses, as the reference does.
- Serving: a fused prefill and a one-token decode step against KV caches,
  through the kernels by default (``use_kernels=True``, head-major
  caches); ``use_kernels=False`` is the reference's plain path over
  seq-major caches.
- Memories: an encoder-decoder config (``cfg.encoder``) runs ``encode``,
  a non-causal dense stack over stub frame embeddings (B, F, d_model);
  a vision config (``cfg.vision``) takes the stub projected patch
  embeddings (B, n_image_tokens, d_model) as they are (``get_memory``).
  Training passes the memory to every cross block; serving projects it
  once into the cache (``init_cache(memory_len=)``,
  ``build_cross_cache``) before the prefill.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

Params = Dict[str, Any]
Tensor = torch.Tensor


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return L.torch_dtype(cfg.dtype)


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The config of the (non-causal, dense) encoder stack: the encoder's
    widths and depth with the decoder's norm, RoPE theta and dtype."""
    e = cfg.encoder
    return dataclasses.replace(
        cfg, name=cfg.name + "-encoder", d_model=e.d_model,
        n_heads=e.n_heads, n_kv_heads=e.n_kv_heads,
        head_dim=e.d_model // e.n_heads, d_ff=e.d_ff, head_pattern=(),
        body_pattern=(LayerSpec(mixer="attn", ff="dense"),),
        body_repeats=e.n_layers, tail_pattern=(), causal=False, moe=None,
        ssm=None, encoder=None, vision=None)


def init_params(seed: int, cfg: ModelConfig, device: DeviceLike = None
                ) -> Params:
    """Random weights from ``seed``, drawn on ``device`` (the card unless
    told otherwise) in the config's dtype; norm scales are f32. An
    encoder-decoder config also gets ``encoder`` (its stack and final
    norm). A seed gives different weights on the CPU and on the card: to
    compare devices, draw once and move the tree."""
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
    if cfg.encoder is not None:
        ecfg = encoder_config(cfg)
        p["encoder"] = {"stack": B.stack_init(gen, ecfg, dtype),
                        "final_norm": L.norm_init(ecfg, ecfg.d_model, dev)}
    return p


def encode(params: Params, cfg: ModelConfig, frames: Tensor,
           use_kernels: bool = False, remat: bool = False) -> Tensor:
    """The encoder over stub frame embeddings (B, F, d_model): RoPE
    positions 0..F-1, attention all to all (nothing masked), then the
    encoder's final norm."""
    ecfg = encoder_config(cfg)
    Bsz, Fr, _ = frames.shape
    positions = torch.arange(Fr, device=frames.device)[None].expand(Bsz, Fr)
    x, _, _ = B.stack_apply(params["encoder"]["stack"], ecfg, frames,
                            positions=positions, causal=False,
                            use_kernels=use_kernels, remat=remat)
    return L.norm_apply(ecfg, params["encoder"]["final_norm"], x,
                        use_kernels=use_kernels)


def get_memory(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
               use_kernels: bool = False, remat: bool = False
               ) -> Optional[Tensor]:
    """The cross-attention memory of this family: the encoder's output
    over ``batch["frames"]``, else ``batch["image_embeds"]``, else None."""
    if cfg.encoder is not None:
        return encode(params, cfg, batch["frames"], use_kernels, remat)
    if cfg.vision is not None:
        return batch["image_embeds"]
    return None


def memory_len(cfg: ModelConfig, seq_len: int) -> int:
    """The memory's length for a ``seq_len``-token input: seq_len //
    frame_ratio frames, or the vision stub's image tokens, or 0."""
    if cfg.encoder is not None:
        return seq_len // cfg.encoder.frame_ratio
    if cfg.vision is not None:
        return cfg.vision.n_image_tokens
    return 0


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               memory_len: int = 0,
               dtype: Optional[torch.dtype] = None, layout: str = "head",
               page_size: int = 64, total_pages: Optional[int] = None,
               cache_dtype: Optional[str] = None,
               device: DeviceLike = None,
               kv_heads: Optional[int] = None) -> Params:
    """Zeroed KV caches of every layer, ``max_len`` slots deep (a ring of
    ``sliding_window`` slots for "swa" layers). ``layout="head"`` is the
    decode kernel's (B, kv, S, hd); "seq" the plain path's (B, S, kv, hd);
    "paged" gives full-attention layers a page pool of ``total_pages``
    pages (the trash page 0 included) of ``page_size`` slots and one
    block table shared by every layer, for :class:`repro_torch.serving.
    ContinuousEngine`. ``cache_dtype="int8"`` stores the paged pool as
    per-slot int8 codes with f32 scales (``ks``/``vs``). ``dtype``
    defaults to the config's compute dtype. Cross blocks get zeroed
    ``cross_k``/``cross_v`` of ``memory_len`` slots, for
    :func:`build_cross_cache` to fill. ``kv_heads`` (default
    ``cfg.n_kv_heads``) sizes the attention caches: a tensor-parallel rank
    holds its share of the kv heads."""
    dev = resolve_device(device)
    return B.stack_cache(cfg, batch, max_len, dtype or compute_dtype(cfg),
                         layout, page_size, total_pages, cache_dtype, dev,
                         memory_len, kv_heads)


def build_cross_cache(params: Params, cfg: ModelConfig, memory: Tensor,
                      cache: Params) -> Params:
    """Project ``memory`` (B, S, D) into every cross block's ``cross_k``/
    ``cross_v`` (in place, cast to the cache's dtype); returns the cache.
    Prefill and decode then read them."""
    for (spec, p), (_, c) in zip(B.each_layer(params["stack"], cfg),
                                 B.each_layer(cache, cfg)):
        if spec.cross_attn:
            k, v = L.cross_kv(p["cross"], cfg, memory)
            c["cross_k"].copy_(k)
            c["cross_v"].copy_(v)
    return cache


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
    x, cache, _ = B.stack_apply(params["stack"], cfg, x, cache=cache,
                                pos=pos, decode=True,
                                use_kernels=use_kernels, offsets=offsets)
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
    attention, so the cache holds what each row would produce unpadded.
    Cross blocks read the memory from the cache: fill it first
    (:func:`build_cross_cache`)."""
    Bsz, P = tokens.shape
    x = F.embedding(tokens, params["embed"]).to(compute_dtype(cfg))
    positions = torch.arange(P, device=x.device)[None].expand(Bsz, P)
    if offsets is not None:
        positions = positions - offsets[:, None]
    if not cfg.causal:
        raise ValueError("prefill runs a causal decoder; a non-causal stack "
                         "(the encoder) runs with no cache")
    x, cache, _ = B.stack_apply(params["stack"], cfg, x, cache=cache,
                                positions=positions, decode=False,
                                use_kernels=use_kernels, offsets=offsets)
    return _logits(params, cfg, x[:, -1:], use_kernels), cache


# ---------------------------------------------------------------------------
# training forward and loss
# ---------------------------------------------------------------------------


def _embed_positions(params: Params, cfg: ModelConfig, tokens: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    Bsz, S = tokens.shape
    x = F.embedding(tokens, params["embed"]).to(compute_dtype(cfg))
    positions = torch.arange(S, device=x.device)[None].expand(Bsz, S)
    return x, positions


def hidden_states(params: Params, cfg: ModelConfig, tokens: Tensor, *,
                  memory: Optional[Tensor] = None,
                  use_kernels: bool = False, remat: bool = False
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The stack up to (but excluding) the LM head: the final norm's
    output (B, S, d) and the auxiliary losses summed over the blocks
    (``moe_aux``, ``moe_z``; zero without MoE blocks). Cross blocks
    attend ``memory``."""
    x, positions = _embed_positions(params, cfg, tokens)
    x, _, aux = B.stack_apply(params["stack"], cfg, x, positions=positions,
                              memory=memory, causal=cfg.causal,
                              use_kernels=use_kernels, remat=remat)
    x = L.norm_apply(cfg, params["final_norm"], x, use_kernels=use_kernels)
    return x, aux


def forward(params: Params, cfg: ModelConfig, tokens: Tensor, *,
            memory: Optional[Tensor] = None, use_kernels: bool = False,
            remat: bool = False) -> Tuple[Tensor, Dict[str, Tensor]]:
    """tokens: (B, S) ids -> (logits (B, S, padded_vocab), aux losses);
    cross blocks attend ``memory`` (B, S_mem, d_model)."""
    x, aux = hidden_states(params, cfg, tokens, memory=memory,
                           use_kernels=use_kernels, remat=remat)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return x @ head.to(x.dtype).T, aux


def _dense_ce(cfg: ModelConfig, logits: Tensor, targets: Tensor) -> Tensor:
    """Mean next-token CE in f32; padded-vocab logits are masked to -1e30."""
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (logz - gold).mean()


def _ce_chunk_step(cfg: ModelConfig, x: Tensor, hc: Tensor, base: int,
                   targets: Tensor, m_run: Tensor, s_run: Tensor,
                   gold: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """One vocab chunk of the streaming CE: this chunk's logits, the
    running max and sum of exponentials, and the gold logit of the targets
    that fall in it (the body of the reference's scan)."""
    chunk = hc.shape[0]
    lg = (x @ hc.to(x.dtype).T).float()                     # (B, S, chunk)
    if cfg.padded_vocab != cfg.vocab_size:
        vid = base + torch.arange(chunk, device=x.device)
        lg = lg.masked_fill(vid >= cfg.vocab_size, -1e30)
    m_new = torch.maximum(m_run, lg.amax(dim=-1))
    s_new = s_run * torch.exp(m_run - m_new) \
        + torch.exp(lg - m_new[..., None]).sum(dim=-1)
    in_chunk = (targets >= base) & (targets < base + chunk)
    idx = (targets - base).clamp(0, chunk - 1).long()
    g = lg.gather(-1, idx[..., None])[..., 0]
    return m_new, s_new, torch.where(in_chunk, g, gold)


def _chunked_ce(cfg: ModelConfig, x: Tensor, head: Tensor, targets: Tensor,
                chunk: int) -> Tensor:
    """Vocab-chunked streaming softmax CE: the (B, S, V) f32 logits are
    never materialised. A Python loop over the chunks; each chunk's logits
    are recomputed in the backward (``torch.utils.checkpoint``) rather than
    kept, as XLA rematerialises the reference's scan."""
    Vp = cfg.padded_vocab
    if Vp % chunk:
        raise ValueError(f"padded vocab {Vp} is not a multiple of {chunk}")
    shape = targets.shape
    m_run = torch.full(shape, -1e30, device=x.device)
    s_run = torch.zeros(shape, device=x.device)
    gold = torch.zeros(shape, device=x.device)
    for base in range(0, Vp, chunk):
        m_run, s_run, gold = checkpoint(
            _ce_chunk_step, cfg, x, head[base:base + chunk], base, targets,
            m_run, s_run, gold, use_reentrant=False)
    logz = m_run + torch.log(s_run.clamp_min(1e-30))
    return (logz - gold).mean()


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor], *,
            use_kernels: bool = False, remat: bool = False,
            ce_chunk: int = 0) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token cross-entropy of ``batch["tokens"]`` (B, S), plus, for an
    MoE config, ``router_aux_weight * moe_aux + router_z_weight * moe_z``.
    ``ce_chunk > 0`` (dividing the padded vocab) takes the vocab-chunked
    streaming CE. The memory comes from the batch (:func:`get_memory`:
    ``frames`` through the encoder, or ``image_embeds``). Returns (loss,
    {"ce", "moe_aux", "moe_z"})."""
    tokens = batch["tokens"]
    memory = get_memory(params, cfg, batch, use_kernels, remat)
    targets = tokens[:, 1:]
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    if ce_chunk and cfg.padded_vocab % ce_chunk == 0:
        x, aux = hidden_states(params, cfg, tokens, memory=memory,
                               use_kernels=use_kernels, remat=remat)
        ce = _chunked_ce(cfg, x[:, :-1], head, targets, ce_chunk)
    else:
        logits, aux = forward(params, cfg, tokens, memory=memory,
                              use_kernels=use_kernels, remat=remat)
        ce = _dense_ce(cfg, logits[:, :-1], targets)
    m = cfg.moe
    total = ce
    if m is not None:
        total = (total + m.router_aux_weight * aux["moe_aux"]
                 + m.router_z_weight * aux["moe_z"])
    return total, {"ce": ce, **aux}
