"""Move parameter trees between the JAX package's layout and the port's.

Trees are nested dicts and lists. The only 4-D leaves are convolution
weights: HWIO in the reference, OIHW here. Dense weights stay (din, dout).
Running BN state (``mu_run``, ``var_run``, ``initialized``) and optimizer
momentum convert leaf by leaf the same way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import DeviceLike, resolve_device


def to_torch(np_tree: Any, device: DeviceLike = None) -> Any:
    """numpy (reference layout) -> tensors in the port's layout."""
    dev = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)                  # HWIO -> OIHW
        return torch.tensor(np.ascontiguousarray(a), device=dev)

    return tree.map(one, np_tree)


def to_numpy(torch_tree: Any) -> Any:
    """Tensors in the port's layout -> numpy in the reference layout."""

    def one(t):
        a = t.detach().cpu().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a   # OIHW -> HWIO

    return tree.map(one, torch_tree)
