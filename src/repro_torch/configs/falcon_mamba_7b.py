"""falcon-mamba-7b [ssm] — attention-free Mamba-1 (copy of
``repro.configs.falcon_mamba_7b``). [arXiv:2410.05355]

64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16.
Mamba-1 blocks: the mixer *is* the FF (no separate MLP), d_inner = 2*d_model.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    d_model=4096,
    n_heads=1,                 # attention-free; placeholders
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=65_024,
    body_pattern=(LayerSpec(mixer="ssm", ff="none"),),
    body_repeats=64,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
    tie_embeddings=False,
    supports_long_context=True,   # O(1)/token recurrent decode
    citation="arXiv:2410.05355",
)
