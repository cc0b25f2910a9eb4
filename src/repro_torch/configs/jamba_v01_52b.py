"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave + MoE. [arXiv:2403.19887]

A copy of ``repro.configs.jamba_v01_52b``
(the port keeps its own configs).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Jamba period-8 block: attention at offset 4, MoE on every other layer.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig, SSMConfig

_M_D = LayerSpec(mixer="ssm", ff="dense")   # mamba + dense MLP
_M_E = LayerSpec(mixer="ssm", ff="moe")     # mamba + MoE
_A_D = LayerSpec(mixer="attn", ff="dense")  # attention + dense MLP

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65_536,
    # 1 attention : 7 mamba per 8 layers; MoE every second layer
    body_pattern=(_M_D, _M_E, _M_D, _M_E, _A_D, _M_E, _M_D, _M_E),
    body_repeats=4,
    moe=MoEConfig(
        n_experts=16,
        top_k=2,
        d_expert=14336,
        capacity_factor=1.25,
        shard_axis="expert",   # 16 % 16 == 0
    ),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
    supports_long_context=True,   # hybrid: 4 attn layers keep caches, 28 are O(1)
    citation="arXiv:2403.19887",
)
