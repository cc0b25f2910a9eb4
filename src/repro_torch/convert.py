"""Move parameter trees between the JAX package's layout and the port's.

Trees are nested dicts and lists.

- Vision models (``to_torch``/``to_numpy``): the only 4-D leaves are
  convolution weights, HWIO in the reference and OIHW here. Dense weights
  stay (din, dout). Running BN state (``mu_run``, ``var_run``,
  ``initialized``) and optimizer momentum convert leaf by leaf the same way.
- Decoder models (``lm_to_torch``/``lm_to_numpy``): no leaf changes layout.
  The reference stacks each body slot's layers on a leading
  ``body_repeats`` axis (it scans over them); the port holds a list of
  per-layer trees. The same holds for KV caches, gradients and the
  optimizer state: ``lm_opt_state_to_torch`` carries an SGD (momentum) or
  Adam (mu, nu) state, each a tree shaped like the parameters. An
  encoder-decoder's ``encoder`` subtree holds a second stack, whose body
  slot is stacked on the encoder's ``n_layers`` axis.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import adam, sgd

_STACK = {"head", "body", "tail"}          # the keys of a block stack


def to_torch(np_tree: Any, device: DeviceLike = None) -> Any:
    """numpy (reference layout) -> tensors in the port's layout."""
    dev = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)                  # HWIO -> OIHW
        return torch.tensor(np.array(a, order="C"), device=dev)  # 0-d stays 0-d

    return tree.map(one, np_tree)


def to_numpy(torch_tree: Any) -> Any:
    """Tensors in the port's layout -> numpy in the reference layout."""

    def one(t):
        a = t.detach().cpu().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a   # OIHW -> HWIO

    return tree.map(one, torch_tree)


def is_decoder_tree(t: Any) -> bool:
    """Whether ``t`` holds a block stack (a decoder's parameters, caches or
    optimizer moments) rather than a vision model's tree."""
    if isinstance(t, dict):
        return set(t) == _STACK or any(is_decoder_tree(v) for v in t.values())
    if isinstance(t, (list, tuple)):
        return any(is_decoder_tree(v) for v in t)
    return False


def _leaf_to_torch(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes, as jax hands it out
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dev)


def lm_to_torch(np_tree: Any, cfg: ModelConfig, device: DeviceLike = None
                ) -> Any:
    """A decoder's parameters or caches in the reference's layout (numpy,
    e.g. ``jax.device_get(repro.models.transformer.init_params(...))``) ->
    the port's tree of tensors on ``device``. Every block stack (a dict of
    ``head``/``body``/``tail``) has its body slots unstacked into lists of
    ``cfg.body_repeats`` per-layer trees (``cfg.encoder.n_layers`` under
    ``encoder``). Leaves keep their layout."""
    dev = resolve_device(device)
    enc = getattr(cfg, "encoder", None)
    enc_repeats = enc.n_layers if enc is not None else cfg.body_repeats

    def walk(t, R):
        if isinstance(t, dict):
            if set(t) == _STACK:
                return {"head": [walk(x, R) for x in t["head"]],
                        "body": [unstack(x, R) for x in t["body"]],
                        "tail": [walk(x, R) for x in t["tail"]]}
            return {k: walk(v, enc_repeats if k == "encoder" else R)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(x, R) for x in t]
        return _leaf_to_torch(t, dev)

    def unstack(slot, R):
        for a in tree.leaves(slot):
            if np.shape(a)[:1] != (R,):
                raise ValueError(f"body leaf of shape {np.shape(a)} has no "
                                 f"leading body_repeats={R} axis")
        return [walk(tree.map(lambda a, i=i: np.asarray(a)[i], slot), R)
                for i in range(R)]

    return walk(np_tree, cfg.body_repeats)


def lm_to_numpy(torch_tree: Any) -> Any:
    """The port's decoder tree (parameters or caches) -> numpy in the
    reference's layout: body layers stacked again on a leading axis. bf16
    leaves come back as float32 (numpy has no bfloat16)."""

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def walk(t):
        if isinstance(t, dict):
            if set(t) == _STACK:
                return {"head": [walk(x) for x in t["head"]],
                        "body": [stack(x) for x in t["body"]],
                        "tail": [walk(x) for x in t["tail"]]}
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(x) for x in t]
        return leaf(t)

    def stack(layers):
        per_layer = [walk(x) for x in layers]
        return tree.map(lambda *xs: np.stack(xs), *per_layer)

    return walk(torch_tree)


def lm_opt_state_to_torch(state: Any, cfg: ModelConfig,
                          device: DeviceLike = None) -> Any:
    """The reference's LM optimizer state (numpy, e.g. ``jax.device_get`` of
    ``repro.optim.sgd.init(params)`` or ``adam.init(params)``) -> the port's
    ``SGDState`` or ``AdamState``: every params-shaped field through
    :func:`lm_to_torch`, the step counter as a 0-d int32 tensor."""
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    if hasattr(state, "momentum"):
        return sgd.SGDState(lm_to_torch(state.momentum, cfg, dev), step)
    return adam.AdamState(lm_to_torch(state.mu, cfg, dev),
                          lm_to_torch(state.nu, cfg, dev), step)
