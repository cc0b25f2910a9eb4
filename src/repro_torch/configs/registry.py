"""The configurations the port can run, by name: every architecture of
the JAX package's registry and the paper's vision models. The decoders
(``qwen3-1.7b``, ``phi3-medium-14b``, ``gemma3-27b``, ``h2o-danube-3-4b``),
the SSM and hybrid models (``falcon-mamba-7b``, ``jamba-v0.1-52b``), the
MoE models (``qwen2-moe-a2.7b``, ``kimi-k2-1t-a32b``), the encoder-decoder
``seamless-m4t-large-v2`` and the vision-LM ``llama-3.2-vision-11b``;
``<name>-reduced`` is each one's CPU-smoke variant."""
from __future__ import annotations

from typing import Dict, List, Union

from repro_torch.configs import (falcon_mamba_7b, gemma3_27b,
                                  h2o_danube_3_4b, jamba_v01_52b,
                                  kimi_k2_1t_a32b, llama_3_2_vision_11b,
                                  phi3_medium_14b, qwen2_moe_a27b,
                                  qwen3_1_7b, seamless_m4t_large_v2)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_models import PAPER_MODELS, VisionModelConfig

_ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        kimi_k2_1t_a32b.CONFIG, falcon_mamba_7b.CONFIG, gemma3_27b.CONFIG,
        jamba_v01_52b.CONFIG, seamless_m4t_large_v2.CONFIG,
        qwen2_moe_a27b.CONFIG, qwen3_1_7b.CONFIG,
        llama_3_2_vision_11b.CONFIG, phi3_medium_14b.CONFIG,
        h2o_danube_3_4b.CONFIG)}


def get_config(name: str) -> Union[ModelConfig, VisionModelConfig]:
    if name.endswith("-reduced") and name[:-len("-reduced")] in _ARCHS:
        return _ARCHS[name[:-len("-reduced")]].reduced()
    if name in _ARCHS:
        return _ARCHS[name]
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    raise KeyError(f"unknown configuration {name!r}; available: "
                   f"{list_configs()}")


def list_configs() -> List[str]:
    return sorted(_ARCHS) + sorted(PAPER_MODELS)
