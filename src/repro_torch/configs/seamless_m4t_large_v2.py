"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal. [arXiv:2308.11596]

A copy of ``repro.configs.seamless_m4t_large_v2``
(the port keeps its own configs).

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.
The speech frontend (mel-spectrogram + conformer feature extractor) is a STUB
per the assignment: input_specs() provides precomputed frame embeddings
(B, seq_len // frame_ratio, d_model). We implement the text decoder (24L,
self-attn + cross-attn) and a 24L transformer encoder over the stub frames.
"""
from repro_torch.configs.base import EncoderConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    body_pattern=(LayerSpec(mixer="attn", ff="dense", cross_attn=True),),
    body_repeats=24,
    encoder=EncoderConfig(
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
        frame_ratio=4),
    rope_theta=1e4,
    supports_long_context=False,   # full-attention decoder: long_500k skipped
    citation="arXiv:2308.11596",
)
