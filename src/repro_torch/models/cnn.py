"""The paper's convolutional models: C1/C3-style shallow convnets (Keskar et
al. 2017) and ResNet44 / WResNet-style residual networks (He et al. 2016),
all with (ghost) batch normalization. Port of ``repro.models.cnn``.

Public layout as in the reference: inputs are (B, H, W, C). Inside, the
activations are NCHW tensors in ``torch.channels_last`` memory, which is the
same bytes as NHWC: an NHWC input is taken as such a tensor without a copy,
and the (G, R, C) ghost view each GBN takes of it is free too. Convolution
weights are OIHW (the reference's HWIO, permuted by
:mod:`repro_torch.convert`).

``padding="SAME"`` follows XLA: total padding max((ceil(n/s)-1)s + k - n, 0),
the odd pixel on the high side, so a stride-2 3x3 conv of an even input pads
(0, 1), which ``F.conv2d``'s symmetric padding cannot express.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import VisionModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.vision_common import init_rng, norm_apply, norm_init

Params = Dict[str, Any]
Tensor = torch.Tensor


def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int
               ) -> Tensor:
    fan_in = kh * kw * cin
    return torch.randn((cout, cin, kh, kw), generator=gen) \
        * math.sqrt(2.0 / fan_in)


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: Tensor, w: Tensor, stride: int = 1) -> Tensor:
    (ht, hb), (wl, wr) = (same_padding(x.shape[2], w.shape[2], stride),
                          same_padding(x.shape[3], w.shape[3], stride))
    if ht == hb and wl == wr:
        y = F.conv2d(x, w, stride=stride, padding=(ht, wl))
    else:
        y = F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride)
    return y.contiguous(memory_format=torch.channels_last)


def _norm(cfg: VisionModelConfig, p: Params, s: Params, x: Tensor, **kw
          ) -> Tuple[Tensor, Params]:
    """GBN over an NCHW channels_last activation, through its NHWC view."""
    y, ns = norm_apply(cfg, p, s, x.permute(0, 2, 3, 1), **kw)
    return y.permute(0, 3, 1, 2), ns


def _nchw(x: Tensor) -> Tensor:
    """(B, H, W, C) input -> NCHW view in channels_last memory."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# C1/C3-style shallow convnet
# ---------------------------------------------------------------------------


def convnet_init(seed: int, cfg: VisionModelConfig,
                 device: DeviceLike = None) -> Tuple[Params, Params]:
    gen, dev = init_rng(seed, device)
    params: Params = {"stages": [], "out": None}
    state: Params = {"stages": []}
    cin = cfg.input_shape[2]
    for cout in cfg.channels:
        np_, ns = norm_init(cfg, cout, dev)
        params["stages"].append({"w": _conv_init(gen, 3, 3, cin, cout).to(dev),
                                 "norm": np_})
        state["stages"].append(ns)
        cin = cout
    params["out"] = {
        "w": (torch.randn((cin, cfg.n_classes), generator=gen)
              / math.sqrt(cin)).to(dev),
        "b": torch.zeros(cfg.n_classes, device=dev),
    }
    return params, state


def convnet_apply(params: Params, state: Params, cfg: VisionModelConfig,
                  x: Tensor, *, training: bool = True,
                  ghost_batch_size: Optional[int] = None,
                  use_gbn: Optional[bool] = None,
                  use_kernels: bool = False) -> Tuple[Tensor, Params]:
    kw = dict(training=training, ghost_batch_size=ghost_batch_size,
              use_gbn=use_gbn, use_kernels=use_kernels)
    x = _nchw(x)
    new_state: Params = {"stages": []}
    for sp, ss in zip(params["stages"], state["stages"]):
        x, ns = _norm(cfg, sp["norm"], ss, _conv(x, sp["w"]), **kw)
        new_state["stages"].append(ns)
        x = F.relu(x)
        if x.shape[2] > 2:
            x = F.max_pool2d(x, 2, 2)
    logits = x.mean(dim=(2, 3)) @ params["out"]["w"] + params["out"]["b"]
    return logits, new_state


# ---------------------------------------------------------------------------
# ResNet44 / WResNet16-4 style residual network
# ---------------------------------------------------------------------------


def resnet_init(seed: int, cfg: VisionModelConfig,
                device: DeviceLike = None) -> Tuple[Params, Params]:
    gen, dev = init_rng(seed, device)
    c0 = cfg.channels[0]
    np_, ns = norm_init(cfg, c0, dev)
    params: Params = {
        "stem": {"w": _conv_init(gen, 3, 3, cfg.input_shape[2], c0).to(dev),
                 "norm": np_},
        "stages": [], "out": None}
    state: Params = {"stem": ns, "stages": []}
    cin = c0
    for cout in cfg.channels:
        stage_p, stage_s = [], []
        for _ in range(cfg.blocks_per_stage):
            n1p, n1s = norm_init(cfg, cout, dev)
            n2p, n2s = norm_init(cfg, cout, dev)
            blk = {"w1": _conv_init(gen, 3, 3, cin, cout).to(dev),
                   "norm1": n1p,
                   "w2": _conv_init(gen, 3, 3, cout, cout).to(dev),
                   "norm2": n2p}
            if cin != cout:
                blk["proj"] = _conv_init(gen, 1, 1, cin, cout).to(dev)
            stage_p.append(blk)
            stage_s.append({"norm1": n1s, "norm2": n2s})
            cin = cout
        params["stages"].append(stage_p)
        state["stages"].append(stage_s)
    params["out"] = {
        "w": (torch.randn((cin, cfg.n_classes), generator=gen)
              / math.sqrt(cin)).to(dev),
        "b": torch.zeros(cfg.n_classes, device=dev),
    }
    return params, state


def resnet_apply(params: Params, state: Params, cfg: VisionModelConfig,
                 x: Tensor, *, training: bool = True,
                 ghost_batch_size: Optional[int] = None,
                 use_gbn: Optional[bool] = None,
                 use_kernels: bool = False) -> Tuple[Tensor, Params]:
    kw = dict(training=training, ghost_batch_size=ghost_batch_size,
              use_gbn=use_gbn, use_kernels=use_kernels)
    x = _nchw(x)
    x, ns = _norm(cfg, params["stem"]["norm"], state["stem"],
                  _conv(x, params["stem"]["w"]), **kw)
    new_state: Params = {"stem": ns, "stages": []}
    x = F.relu(x)
    for si, (stage_p, stage_s) in enumerate(zip(params["stages"],
                                                state["stages"])):
        ns_stage = []
        for bi, (blk, bs) in enumerate(zip(stage_p, stage_s)):
            stride = 2 if (si > 0 and bi == 0) else 1
            h, n1 = _norm(cfg, blk["norm1"], bs["norm1"],
                          _conv(x, blk["w1"], stride), **kw)
            h, n2 = _norm(cfg, blk["norm2"], bs["norm2"],
                          _conv(F.relu(h), blk["w2"]), **kw)
            if "proj" in blk:
                skip = _conv(x, blk["proj"], stride)
            elif stride != 1:
                skip = x[:, :, ::stride, ::stride]
            else:
                skip = x
            x = F.relu(h + skip)
            ns_stage.append({"norm1": n1, "norm2": n2})
        new_state["stages"].append(ns_stage)
    logits = x.mean(dim=(2, 3)) @ params["out"]["w"] + params["out"]["b"]
    return logits, new_state


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def init(seed: int, cfg: VisionModelConfig, device: DeviceLike = None
         ) -> Tuple[Params, Params]:
    if cfg.kind == "convnet":
        return convnet_init(seed, cfg, device)
    if cfg.kind == "resnet":
        return resnet_init(seed, cfg, device)
    raise ValueError(cfg.kind)


def apply(params, state, cfg, x, **kw):
    if cfg.kind == "convnet":
        return convnet_apply(params, state, cfg, x, **kw)
    if cfg.kind == "resnet":
        return resnet_apply(params, state, cfg, x, **kw)
    raise ValueError(cfg.kind)


def model_fns(cfg: VisionModelConfig):
    """Returns (init, apply) for any paper model config (mlp included)."""
    if cfg.kind == "mlp":
        from repro_torch.models import mlp as M
        return M.init, M.apply
    return init, apply
