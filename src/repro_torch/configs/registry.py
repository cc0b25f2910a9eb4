"""The configurations the port can run, by name: the decoder models whose
path is ported (``qwen3-1.7b``, ``falcon-mamba-7b``, the MoE models
``qwen2-moe-a2.7b`` and ``kimi-k2-1t-a32b``, and ``<name>-reduced`` for each
one's CPU-smoke variant) and the paper's vision models."""
from __future__ import annotations

from typing import Dict, List, Union

from repro_torch.configs import (falcon_mamba_7b, kimi_k2_1t_a32b,
                                  qwen2_moe_a27b, qwen3_1_7b)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_models import PAPER_MODELS, VisionModelConfig

_ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (qwen3_1_7b.CONFIG, falcon_mamba_7b.CONFIG,
                        qwen2_moe_a27b.CONFIG, kimi_k2_1t_a32b.CONFIG)}


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
