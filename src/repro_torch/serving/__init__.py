"""Serving of the decoder models: static batches (fused prefill + KV-cache
decode) and the continuous-batching engine over paged or contiguous
caches."""
from repro_torch.serving.engine import (Completion, ContinuousEngine,
                                        Request, generate, make_serve_step,
                                        mask_padded_vocab, poisson_trace,
                                        prefill, prefill_fused,
                                        run_static_trace, sample_tokens)

__all__ = ["Completion", "ContinuousEngine", "Request", "generate",
           "make_serve_step", "mask_padded_vocab", "poisson_trace",
           "prefill", "prefill_fused", "run_static_trace", "sample_tokens"]
