"""F1 (Keskar et al. 2017): fully-connected MNIST model with (ghost) batch
normalization after every hidden layer. Dense weights are (din, dout), used
as ``x @ w``, as in ``repro.models.mlp``."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import VisionModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.vision_common import init_rng, norm_apply, norm_init

Params = Dict[str, Any]


def dense_init(generator: torch.Generator, shape: Tuple[int, ...],
               scale: Optional[float] = None) -> torch.Tensor:
    """Scaled normal init (Glorot/He style), drawn on the host."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0], 1))
    return scale * torch.randn(shape, generator=generator)


def init(seed: int, cfg: VisionModelConfig, device: DeviceLike = None
         ) -> Tuple[Params, Params]:
    gen, dev = init_rng(seed, device)
    h, w, c = cfg.input_shape
    sizes = (h * w * c,) + tuple(cfg.hidden_sizes)
    params: Params = {"layers": [], "out": None}
    state: Params = {"layers": []}
    for din, dout in zip(sizes[:-1], sizes[1:]):
        np_, ns = norm_init(cfg, dout, dev)
        params["layers"].append({
            "w": dense_init(gen, (din, dout), math.sqrt(2.0 / din)).to(dev),
            "b": torch.zeros(dout, device=dev),
            "norm": np_,
        })
        state["layers"].append(ns)
    params["out"] = {
        "w": dense_init(gen, (sizes[-1], cfg.n_classes),
                        math.sqrt(1.0 / sizes[-1])).to(dev),
        "b": torch.zeros(cfg.n_classes, device=dev),
    }
    return params, state


def apply(params: Params, state: Params, cfg: VisionModelConfig,
          x: torch.Tensor, *, training: bool = True,
          ghost_batch_size: Optional[int] = None,
          use_gbn: Optional[bool] = None,
          use_kernels: bool = False) -> Tuple[torch.Tensor, Params]:
    """x: (B, H, W, C) -> (logits (B, n_classes), new_state)."""
    h = x.reshape(x.shape[0], -1)
    new_state: Params = {"layers": []}
    for lp, ls in zip(params["layers"], state["layers"]):
        h = h @ lp["w"] + lp["b"]
        h, ns = norm_apply(cfg, lp["norm"], ls, h, training=training,
                           ghost_batch_size=ghost_batch_size,
                           use_gbn=use_gbn, use_kernels=use_kernels)
        new_state["layers"].append(ns)
        h = F.relu(h)
    logits = h @ params["out"]["w"] + params["out"]["b"]
    return logits, new_state
