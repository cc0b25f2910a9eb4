"""gemma3-27b [dense] — 5:1 local:global attention, 128k. [hf:google/gemma-3-1b-pt]

A copy of ``repro.configs.gemma3_27b``
(the port keeps its own configs).

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
Pattern: 5 sliding-window (1024) layers then 1 global layer, repeated;
62 = 6*10 + 2 leaves a 2-local tail.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(mixer="swa", ff="dense")
_GLOBAL = LayerSpec(mixer="attn", ff="dense")

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    body_pattern=(_LOCAL,) * 5 + (_GLOBAL,),
    body_repeats=10,
    tail_pattern=(_LOCAL, _LOCAL),
    sliding_window=1024,
    rope_theta=1e6,
    qk_norm=True,
    # locals keep 1024-token caches; globals keep the full cache but decode
    # attention is a linear matvec — long_500k runs (DESIGN.md §Decode-shape).
    supports_long_context=True,
    citation="hf:google/gemma-3-1b-pt",
)
