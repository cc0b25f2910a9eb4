"""llama-3.2-vision-11b [vlm] — cross-attn image layers. [hf:meta-llama/Llama-3.2-11B-Vision]

A copy of ``repro.configs.llama_3_2_vision_11b``
(the port keeps its own configs).

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
Every 5th layer carries a cross-attention sublayer into the (stubbed) vision
embeddings; the ViT + projector frontend is a STUB per the assignment —
input_specs() provides precomputed projected patch embeddings
(B, n_image_tokens, d_model).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, VisionStubConfig

_X = LayerSpec(mixer="attn", ff="dense", cross_attn=True)
_S = LayerSpec(mixer="attn", ff="dense")

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128_256,
    # 8 cross-attention layers interleaved into 40 decoder layers
    body_pattern=(_X, _S, _S, _S, _S),
    body_repeats=8,
    vision=VisionStubConfig(n_image_tokens=1600),
    rope_theta=5e5,
    supports_long_context=False,   # full attention: long_500k skipped
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
)
