"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 (copy of
``repro.configs.qwen2_moe_a27b``). [hf:Qwen/Qwen1.5-MoE-A2.7B]

24L d_model=2048 16H (GQA kv=16) d_ff=1408(expert) vocab=151936, MoE 60e top-4.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=5632,                 # dense-equivalent width (unused: all layers MoE)
    vocab_size=151_936,
    body_pattern=(LayerSpec(mixer="attn", ff="moe"),),
    body_repeats=24,
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        d_expert=1408,
        n_shared_experts=4,
        d_shared=5632,          # 4 shared experts fused: 4 * 1408
        capacity_factor=1.25,
        shard_axis="ffn",       # 60 % 16 != 0 -> shard each expert's hidden dim
    ),
    rope_theta=1e6,
    supports_long_context=False,   # full attention: long_500k skipped
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
