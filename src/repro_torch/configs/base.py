"""Configuration dataclasses of the decoder models (a copy of
``repro.configs.base``: the port keeps its own, it never imports the JAX
package).

A model is ``head_pattern`` + ``body_pattern * body_repeats`` +
``tail_pattern`` of ``LayerSpec`` layers. The JAX package scans the body
over stacked parameters; the port holds one parameter tree per layer
(``repro_torch.convert.lm_to_torch`` unstacks). ``reduced()`` gives the
CPU-smoke variant of the same family (<=2 body repeats, d_model<=256,
<=4 experts, vocab<=512).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts feed-forward configuration."""

    n_experts: int
    top_k: int
    d_expert: int                 # per-expert hidden width
    n_shared_experts: int = 0     # always-on experts (Kimi/Qwen2-MoE style)
    d_shared: int = 0             # hidden width of the fused shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2   # load-balance auxiliary loss weight
    router_z_weight: float = 0.0      # router logit z-loss
    # "expert": shard the expert axis over the model axis (E % model == 0)
    # "ffn":    shard each expert's hidden dim instead (e.g. qwen2's 60 experts)
    shard_axis: str = "expert"

    def tokens_capacity(self, n_tokens: int) -> int:
        cap = int(self.capacity_factor * n_tokens * self.top_k / self.n_experts)
        return max(cap, self.top_k)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 style selective SSM configuration."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> d_model // 16

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else max(1, d_model // 16)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclass(frozen=True)
class LayerSpec:
    """One layer of the network."""

    mixer: str = "attn"        # "attn" | "swa" | "ssm" | "none"
    ff: str = "dense"          # "dense" | "moe" | "none"
    cross_attn: bool = False   # prepend a cross-attention sublayer

    def __post_init__(self):
        assert self.mixer in ("attn", "swa", "ssm", "none"), self.mixer
        assert self.ff in ("dense", "moe", "none"), self.ff


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for encoder-decoder models (audio/seq2seq)."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    # the modality frontend is a STUB per assignment: input_specs() provides
    # precomputed frame embeddings of shape (B, frames(S), d_model).
    frame_ratio: int = 4  # encoder frames = seq_len // frame_ratio


@dataclass(frozen=True)
class VisionStubConfig:
    """Vision frontend stub: precomputed patch/projector embeddings."""

    n_image_tokens: int = 1600   # e.g. (448/14)^2 + specials, projector output
    d_embed: int = 0             # 0 -> d_model (already projected)


@dataclass(frozen=True)
class NormConfig:
    kind: str = "rmsnorm"   # "rmsnorm" | "layernorm" | "gbn"
    eps: float = 1e-6
    # GBN options (only used when kind == "gbn"; vision/MLP paper models)
    ghost_batch_size: int = 128
    momentum: float = 0.1


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # layer layout --------------------------------------------------------
    head_pattern: Tuple[LayerSpec, ...] = ()
    body_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    body_repeats: int = 1
    tail_pattern: Tuple[LayerSpec, ...] = ()

    # attention -----------------------------------------------------------
    rope_theta: float = 1e4
    sliding_window: int = 4096
    qk_norm: bool = False
    causal: bool = True

    # optional subsystems ---------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStubConfig] = None

    norm: NormConfig = field(default_factory=NormConfig)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # sub-quadratic decode capability: archs whose decode step scales to 500k
    supports_long_context: bool = False
    citation: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0 or self.n_kv_heads == 0, (
            self.n_heads, self.n_kv_heads)

    # ------------------------------------------------------------------
    @property
    def layers(self) -> Tuple[LayerSpec, ...]:
        """Flat layer list (head + body*repeats + tail), in execution order."""
        return (tuple(self.head_pattern)
                + tuple(self.body_pattern) * self.body_repeats
                + tuple(self.tail_pattern))

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def n_attn_layers(self) -> int:
        return sum(1 for s in self.layers if s.mixer in ("attn", "swa"))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so it shards evenly over 16-way model parallelism."""
        mult = 256
        return (self.vocab_size + mult - 1) // mult * mult

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic total parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.head_dim
        n = self.padded_vocab * d                       # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * d                  # unembedding
        for spec in self.layers:
            n += self._mixer_params(spec) + self._ff_params(spec) + 2 * d
        n += d                                          # final norm
        if self.encoder is not None:
            e = self.encoder
            per = (4 * e.d_model * e.n_heads * (e.d_model // e.n_heads)
                   + 3 * e.d_model * e.d_ff + 2 * e.d_model)
            n += e.n_layers * per + e.d_model
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        total = self.param_count()
        n_moe_layers = sum(1 for s in self.layers if s.ff == "moe")
        all_expert = n_moe_layers * m.n_experts * 3 * self.d_model * m.d_expert
        active_expert = n_moe_layers * m.top_k * 3 * self.d_model * m.d_expert
        return total - all_expert + active_expert

    def _mixer_params(self, spec: LayerSpec) -> int:
        d, hd = self.d_model, self.head_dim
        n = 0
        if spec.mixer in ("attn", "swa"):
            n += d * self.n_heads * hd              # q
            n += 2 * d * self.n_kv_heads * hd       # k, v
            n += self.n_heads * hd * d              # o
            if self.qk_norm:
                n += 2 * hd
        elif spec.mixer == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            dtr = s.resolved_dt_rank(d)
            n += d * 2 * di                          # in_proj (x, z)
            n += di * s.d_conv                       # conv
            n += di * (dtr + 2 * s.d_state)          # x_proj
            n += dtr * di + di                       # dt_proj
            n += di * s.d_state + di                 # A_log, D
            n += di * d                              # out_proj
        if spec.cross_attn:
            n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            n += self.n_heads * hd * d + d          # + extra norm
        return n

    def _ff_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        if spec.ff == "dense":
            return 3 * d * self.d_ff                 # swiglu: gate,up,down
        if spec.ff == "moe":
            m = self.moe
            n = m.n_experts * 3 * d * m.d_expert
            n += d * m.n_experts                     # router
            if m.n_shared_experts:
                n += 3 * d * m.d_shared
            return n
        return 0

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: <=2 body repeats,
        d_model<=512, <=4 experts, small vocab."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, 2))
        head_dim = d_model // n_heads
        kw = dict(
            name=self.name + "-reduced",
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_pattern=self.head_pattern[:1],
            body_pattern=self.body_pattern,
            body_repeats=min(self.body_repeats, 2) if len(self.body_pattern) <= 4
            else 1,
            tail_pattern=self.tail_pattern[:1],
            sliding_window=min(self.sliding_window, 16),
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_expert=min(self.moe.d_expert, 256),
                d_shared=min(self.moe.d_shared, 256) if self.moe.d_shared else 0,
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=min(self.ssm.d_state, 8), dt_rank=8)
        if self.encoder is not None:
            kw["encoder"] = dataclasses.replace(
                self.encoder, n_layers=2, d_model=d_model, n_heads=n_heads,
                n_kv_heads=n_kv, d_ff=min(self.encoder.d_ff, 512))
        if self.vision is not None:
            kw["vision"] = dataclasses.replace(self.vision, n_image_tokens=16)
        return dataclasses.replace(self, **kw)
