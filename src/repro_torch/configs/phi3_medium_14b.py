"""phi3-medium-14b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219]

A copy of ``repro.configs.phi3_medium_14b``
(the port keeps its own configs).

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100_352,
    body_pattern=(LayerSpec(mixer="attn", ff="dense"),),
    body_repeats=40,
    rope_theta=1e4,
    supports_long_context=False,   # full attention: long_500k skipped
    citation="arXiv:2404.14219",
)
