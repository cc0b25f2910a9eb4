"""Static batched serving of the decoder models (fused prefill + KV-cache
decode)."""
from repro_torch.serving.engine import (generate, make_serve_step,
                                        mask_padded_vocab, prefill_fused,
                                        sample_tokens)

__all__ = ["generate", "make_serve_step", "mask_padded_vocab",
           "prefill_fused", "sample_tokens"]
