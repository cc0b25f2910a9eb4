"""Momentum SGD, the paper's optimizer, with the large-batch toolkit inside
``update``: global-norm clipping, then multiplicative gradient noise, then
weight decay on every leaf (gamma, beta and biases included), as
``repro.optim.sgd.update`` does. Momentum is kept in float32, another
float dtype, or (``momentum_dtype="int8"``) in the reference's blockwise
int8 form: blocks of 256 along the last axis, each an int8 code and an f32
scale of max|m| / 127, so the quantized buffers keep their parameter's
leading dims.

Functional like the reference: ``update`` returns new tensors and leaves
its arguments as they were.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.core.clipping import clip_by_global_norm
from repro_torch.core.noise import multiplicative_noise_grads

Params = Any


_QBLOCK = 256


def _quantize_int8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Blockwise int8 along the LAST axis: {"q": (..., nb, 256) int8,
    "scale": (..., nb, 1) f32}, the last axis zero-padded to a multiple of
    256. Rounds half to even, as ``jnp.round``."""
    xf = x.float()
    pad = (-xf.shape[-1]) % _QBLOCK
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    blocks = xf.reshape(xf.shape[:-1] + (-1, _QBLOCK))
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"q": q, "scale": scale}


def _dequantize_int8(qs: Dict[str, torch.Tensor], shape, dtype
                     ) -> torch.Tensor:
    blocks = qs["q"].float() * qs["scale"]
    flat = blocks.reshape(blocks.shape[:-2] + (-1,))
    return flat[..., :shape[-1]].reshape(shape).to(dtype)


class SGDState(NamedTuple):
    momentum: Params
    step: torch.Tensor


def init(params: Params, momentum_dtype: str = "float32") -> SGDState:
    first = tree.leaves(params)[0]
    if momentum_dtype == "int8":
        mom = tree.map(lambda p: _quantize_int8(torch.zeros_like(
            p, dtype=torch.float32)), params)
    else:
        dt = getattr(torch, momentum_dtype)
        mom = tree.map(lambda p: torch.zeros_like(p, dtype=dt), params)
    return SGDState(momentum=mom, step=torch.zeros(
        (), dtype=torch.int32, device=first.device))


def _per_param(momentum: Params, n: int, quantized: bool) -> List[Any]:
    """The momentum of each parameter in :func:`tree.leaves` order: a
    tensor, or a {"q", "scale"} dict under int8 (whose two leaves come out
    of :func:`tree.leaves` in that order)."""
    flat = tree.leaves(momentum)
    if not quantized:
        return flat
    return [{"q": flat[2 * i], "scale": flat[2 * i + 1]} for i in range(n)]


@torch.no_grad()
def update(grads: Params, state: SGDState, params: Params, *,
           lr: torch.Tensor, momentum: float = 0.9, nesterov: bool = False,
           weight_decay: float = 0.0, grad_clip: float = 0.0,
           noise_sigma: float = 0.0,
           generator: Optional[torch.Generator] = None,
           momentum_dtype: str = "float32",
           ) -> Tuple[Params, SGDState, Dict[str, torch.Tensor]]:
    """One optimizer step. Returns (new_params, new_state, metrics)."""
    metrics: Dict[str, torch.Tensor] = {}
    if grad_clip and grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        metrics["grad_norm"] = gnorm
    if noise_sigma and noise_sigma > 0:
        if generator is None:
            raise ValueError("gradient noise needs a generator")
        grads = multiplicative_noise_grads(generator, grads, noise_sigma)

    is_q = momentum_dtype == "int8"
    flat_p = tree.leaves(params)
    new_p, new_m = [], []
    for p, g, m in zip(flat_p, tree.leaves(grads),
                       _per_param(state.momentum, len(flat_p), is_q)):
        gf = g.float()
        if weight_decay:
            gf = gf + weight_decay * p.float()
        mf = (_dequantize_int8(m, p.shape, torch.float32) if is_q
              else m.float())
        mf = momentum * mf + gf
        step_dir = (gf + momentum * mf) if nesterov else mf
        new_p.append((p.float() - lr * step_dir).to(p.dtype))
        new_m.append(_quantize_int8(mf) if is_q else mf.to(m.dtype))
    return (tree.unflatten(params, new_p),
            SGDState(tree.unflatten(params, new_m), state.step + 1), metrics)
