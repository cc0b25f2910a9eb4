"""Static batched serving (the port of ``repro.serving.engine``'s
``generate`` path): a fused prefill, then a KV-cache decode loop.

- **prefill** is one full-sequence forward
  (:func:`repro_torch.models.transformer.prefill_forward`) that writes
  every layer's K/V into the cache and keeps the last position's logits;
- **decode** is one token per step (:func:`make_serve_step`); with
  ``use_kernels=True`` (the default) the cache is head-major and attention
  runs in the flash-decode kernel with the query's RoPE fused in;
- ragged prompts are LEFT-padded with ``prompt_lens``: the padding is
  masked out of every attention and RoPE positions start at each row's
  first real token, so each row continues as it would unpadded.

The decode loop is a Python loop that never waits on the card: tokens stay
on the device, and ``prompt_lens`` is checked on the host before it is
sent. The token-at-a-time ``prefill`` fallback and the continuous-batching
engine come with later slices.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T

Params = Any
Tensor = torch.Tensor


def mask_padded_vocab(cfg: ModelConfig, logits: Tensor) -> Tensor:
    """-inf the padded-vocab tail so no sampler can emit an id >=
    vocab_size."""
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits.clone()
        logits[..., cfg.vocab_size:] = -torch.inf
    return logits


def sample_tokens(cfg: ModelConfig, logits: Tensor, *,
                  temperature: float = 0.0, top_k: int = 0,
                  generator: Optional[torch.Generator] = None) -> Tensor:
    """logits (B, V) -> token ids (B,) int64.

    ``temperature <= 0`` is exact greedy argmax; otherwise a draw from
    ``softmax(logits / temperature)`` (Gumbel-max with uniforms from
    ``generator``, on the logits' device), optionally restricted to the
    ``top_k`` largest logits. Padded-vocab ids are masked in every mode."""
    logits = mask_padded_vocab(cfg, logits.float())
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    if generator is None:
        raise ValueError("temperature sampling requires a generator (the "
                         "rng)")
    if top_k > 0:
        k_eff = min(top_k, cfg.vocab_size)        # the padded tail is -inf
        kth = torch.topk(logits, k_eff, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return (logits / temperature + gumbel).argmax(dim=-1)


def make_serve_step(cfg: ModelConfig, use_kernels: bool = True,
                    temperature: float = 0.0, top_k: int = 0) -> Callable:
    """(params, cache, tokens (B, 1), pos[, generator, offsets])
    -> (next_tokens (B, 1), cache)."""

    def serve_step(params: Params, cache: Params, tokens: Tensor,
                   pos: Union[int, Tensor],
                   generator: Optional[torch.Generator] = None,
                   offsets: Optional[Tensor] = None) -> Tuple[Tensor, Params]:
        logits, cache = T.decode_step(params, cfg, tokens, cache, pos,
                                      use_kernels=use_kernels,
                                      offsets=offsets)
        nxt = sample_tokens(cfg, logits[:, -1], temperature=temperature,
                            top_k=top_k, generator=generator)
        return nxt[:, None], cache

    return serve_step


def prefill_fused(params: Params, cfg: ModelConfig, prompts: Tensor,
                  cache: Params, *, offsets: Optional[Tensor] = None,
                  use_kernels: bool = True) -> Tuple[Tensor, Params]:
    """One full-sequence forward fills the cache. Returns (last-position
    logits (B, padded_vocab), cache)."""
    logits, cache = T.prefill_forward(params, cfg, prompts, cache,
                                      use_kernels=use_kernels,
                                      offsets=offsets)
    return logits[:, -1], cache


def _offsets(prompt_lens: Union[Sequence[int], np.ndarray, Tensor], B: int,
             P: int, device: torch.device) -> Tensor:
    """Left pads ``P - prompt_lens``, checked on the host, sent once."""
    if isinstance(prompt_lens, Tensor):
        prompt_lens = prompt_lens.cpu()
    lens = np.asarray(prompt_lens, dtype=np.int64).reshape(-1)
    if lens.shape != (B,) or ((lens < 1) | (lens > P)).any():
        raise ValueError(f"prompt_lens must be {B} lengths in [1, {P}] (the "
                         f"padded prompt width); got {lens.tolist()}")
    return torch.as_tensor((P - lens).astype(np.int32), device=device)


def generate(params: Params, cfg: ModelConfig,
             prompts: Union[Tensor, np.ndarray], *, max_new_tokens: int = 32,
             max_len: Optional[int] = None, use_kernels: bool = True,
             temperature: float = 0.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None,
             prompt_lens: Optional[Union[Sequence[int], Tensor]] = None,
             device: DeviceLike = None) -> Tensor:
    """Batched generation: prompts (B, P) -> (B, P + max_new_tokens) on
    ``device`` (the card unless told otherwise; ``params`` must live there).

    ``temperature == 0`` is greedy; ``temperature > 0`` samples with
    ``generator`` (required, on ``device``), optionally top-k truncated
    (``top_k`` is clamped to ``vocab_size``). ``prompt_lens`` (B,) marks
    LEFT-padded ragged prompts: row b's real tokens are its last
    ``prompt_lens[b]`` columns. ``max_len`` (when given) is the cache depth
    and must cover the prompt and every new token, or this raises.
    ``max_new_tokens == 0`` returns the prompts unchanged."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, device=dev)
    B, P = prompts.shape
    total = P + max_new_tokens if max_len is None else max_len
    if total < P + max_new_tokens:
        raise ValueError(
            f"max_len={total} is shallower than prompt ({P}) + "
            f"max_new_tokens ({max_new_tokens}) = {P + max_new_tokens}; "
            f"decode steps would write past the cache depth")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires a generator (the rng)")
    offsets = None if prompt_lens is None else _offsets(prompt_lens, B, P,
                                                         dev)
    if max_new_tokens == 0:
        return prompts
    cache = T.init_cache(cfg, B, total, layout="head" if use_kernels
                         else "seq", device=dev)
    last, cache = prefill_fused(params, cfg, prompts, cache, offsets=offsets,
                                use_kernels=use_kernels)
    step = make_serve_step(cfg, use_kernels, temperature, top_k)
    tok = sample_tokens(cfg, last, temperature=temperature, top_k=top_k,
                        generator=generator)[:, None]
    out = [prompts, tok.to(prompts.dtype)]
    # the prefill sampled token P, so N - 1 decode steps remain
    for i in range(max_new_tokens - 1):
        tok, cache = step(params, cache, tok, P + i, generator=generator,
                          offsets=offsets)
        out.append(tok.to(prompts.dtype))
    return torch.cat(out, dim=1)
