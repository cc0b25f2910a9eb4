"""Shared pieces of the paper's vision models: norm dispatch (GBN,
conventional full-batch BN, or none) with explicit running-state threading,
and the device and generator the initializers draw from."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.paper_models import VisionModelConfig
from repro_torch.core import gbn as GBN
from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, Any]


def init_rng(seed: int, device: DeviceLike
             ) -> Tuple[torch.Generator, torch.device]:
    """A CPU generator (weights are drawn on the host, so a seed gives the
    same weights on every device) and the device they go to."""
    return torch.Generator().manual_seed(seed), resolve_device(device)


def norm_init(cfg: VisionModelConfig, n_features: int, device: torch.device
              ) -> Tuple[Params, Params]:
    if cfg.norm == "none":
        return {}, {}
    return GBN.gbn_init(n_features, device)


def norm_apply(cfg: VisionModelConfig, params: Params, state: Params,
               x: torch.Tensor, *, training: bool,
               ghost_batch_size: Optional[int] = None,
               use_gbn: Optional[bool] = None,
               use_kernels: bool = False) -> Tuple[torch.Tensor, Params]:
    """x: (B, ..., C). ``use_gbn=False`` degrades GBN to full-batch BN (the
    LB baseline); ``ghost_batch_size`` overrides the config."""
    if cfg.norm == "none":
        return x, state
    gbs = ghost_batch_size or cfg.ghost_batch_size
    gbn_on = cfg.norm == "gbn" if use_gbn is None else use_gbn
    if gbn_on:
        return GBN.gbn_apply(params, state, x, ghost_batch_size=gbs,
                             momentum=cfg.bn_momentum, training=training,
                             use_kernels=use_kernels)
    return GBN.equal_weight_bn_apply(params, state, x,
                                     momentum=cfg.bn_momentum,
                                     training=training)
