"""qwen3-1.7b [dense] — qk_norm, GQA (copy of ``repro.configs.qwen3_1_7b``).

28L d_model=2048 16H (GQA kv=8) head_dim=128 d_ff=6144 vocab=151936
(padded to 152064), rope_theta 1e6, tied embeddings. [hf:Qwen/Qwen3-8B]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    body_pattern=(LayerSpec(mixer="attn", ff="dense"),),
    body_repeats=28,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    supports_long_context=False,
    citation="hf:Qwen/Qwen3-8B",
)
