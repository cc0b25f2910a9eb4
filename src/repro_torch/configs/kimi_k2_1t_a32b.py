"""kimi-k2-1t-a32b [moe] — Kimi K2, trillion-param MoE (copy of
``repro.configs.kimi_k2_1t_a32b``). [arXiv:2501.kimi2]

61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert) vocab=163840,
MoE 384 experts top-8, 1 shared expert, first layer dense.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,              # 7168 / 64
    d_ff=18432,                # dense first layer (K2 model card)
    vocab_size=163_840,
    # layer 0 is dense (DeepSeek-V3-style), remaining 60 layers are MoE
    head_pattern=(LayerSpec(mixer="attn", ff="dense"),),
    body_pattern=(LayerSpec(mixer="attn", ff="moe"),),
    body_repeats=60,
    moe=MoEConfig(
        n_experts=384,
        top_k=8,
        d_expert=2048,
        n_shared_experts=1,
        d_shared=2048,
        capacity_factor=1.25,
        shard_axis="expert",   # 384 % 16 == 0
    ),
    rope_theta=5e6,
    supports_long_context=False,   # full attention: long_500k skipped
    citation="arXiv:2501.kimi2 (paper-table)",
)
