"""h2o-danube-3-4b [dense] — llama+mistral mix, sliding-window attention. [arXiv:2401.16818]

A copy of ``repro.configs.h2o_danube_3_4b``
(the port keeps its own configs).

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32_000,
    body_pattern=(LayerSpec(mixer="swa", ff="dense"),),
    body_repeats=24,
    sliding_window=4096,
    rope_theta=5e5,
    supports_long_context=True,    # SWA: decode cache bounded by the window
    citation="arXiv:2401.16818",
)
