"""Mixture-of-Experts feed-forward with top-k routing and capacity-based
dispatch (the port of ``repro.models.moe``).

- Routing and capacity are computed per sequence. Decode (S == 1) folds the
  batch into one sequence, so capacity pools over the batch: every row of a
  decode step, idle engine slots included, competes for the same
  ``tokens_capacity(B)`` slots of an expert. This is the reference's
  semantics: capacity drops can differ between prefill and decode.
- An assignment's slot is its rank within its expert in (t, j) order, from
  a stable sort (never the (S*k, E) one-hot cumsum); ``slot >= C`` drops.
- Dispatch and combine are :func:`repro_torch.core.expert_parallel.
  local_combine` with every expert local; the shared expert is added last.
- Inside :func:`repro_torch.core.expert_parallel.manual_mode` (a train
  step sharded over a mesh) with expert weights that hold this rank's
  slice, dispatch and combine go through ``ep_manual_combine`` (one sum
  over the model axis a layer), and the load-balance statistics f and P
  are averaged over the data axes through ``mean_in_fwd``, because the
  Switch loss is a product of means.
- The load-balance loss is the Switch/GShard ``E * sum_e f_e * P_e``, the
  z-loss ``mean(logsumexp(logits)^2)``.

With ``use_kernels=True`` the shared expert runs in the fused SwiGLU kernel
(``layers.mlp_apply``); the routed experts are batched products over the
expert axis, as the reference computes them outside any kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import expert_parallel as EP
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init

Params = Dict[str, Any]
Tensor = torch.Tensor


def moe_init(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    """The f32 router (d, E), the experts' (E, d, f)/(E, f, d) weights in
    ``dtype`` and, with shared experts, one fused SwiGLU of ``d_shared``."""
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": dense_init(gen, (d, m.n_experts), dtype=torch.float32),
        "w_gate": dense_init(gen, (m.n_experts, d, m.d_expert), dtype=dtype),
        "w_up": dense_init(gen, (m.n_experts, d, m.d_expert), dtype=dtype),
        "w_down": dense_init(gen, (m.n_experts, m.d_expert, d), dtype=dtype),
    }
    if m.n_shared_experts:
        p["shared"] = mlp_init(gen, d, m.d_shared, dtype)
    return p


def _route(router_w: Tensor, x: Tensor, m: MoEConfig, losses: bool = True,
           dp_axes: Tuple[str, ...] = (), mesh=None
           ) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """x: (B, S, d) -> (topi, topw (B, S, k), aux losses). The logits are an
    f32 product (TF32 is off, ``device.set_precision``); ``topk`` returns
    the largest first, as ``jax.lax.top_k``. ``losses=False`` computes no
    loss and returns an empty dict for them. ``dp_axes`` (inside a manual
    region) makes f and P global over those axes of ``mesh``."""
    logits = x.float() @ router_w.float()                        # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    topw = topw / topw.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    if not losses:
        return topi, topw, {}
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    f = F.one_hot(topi[..., 0], m.n_experts).float().mean(dim=(0, 1))
    P = probs.mean(dim=(0, 1))
    if dp_axes:
        f = EP.mean_in_fwd(f, dp_axes, mesh)
        P = EP.mean_in_fwd(P, dp_axes, mesh)
    aux = m.n_experts * torch.sum(f * P)
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return topi, topw, {"moe_aux": aux, "moe_z": z}


def _slots(topi: Tensor, C: int) -> Tuple[Tensor, Tensor]:
    """(B, S, k) expert ids -> (slot, keep): each assignment's rank within
    its expert in (t, j) order, and ``slot < C``. A stable sort of the
    flattened ids, the start of each expert's run by a running max, and the
    inverse permutation; O(S k) memory."""
    B, S, k = topi.shape
    Tk = S * k
    e_flat = topi.reshape(B, Tk)
    sorted_e, order = torch.sort(e_flat, dim=1, stable=True)
    idx = torch.arange(Tk, device=topi.device).expand(B, Tk)
    change = torch.ones_like(e_flat, dtype=torch.bool)
    change[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    seg_start = torch.cummax(torch.where(change, idx, 0), dim=1).values
    pos_sorted = idx - seg_start                    # rank within the expert
    slot = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    slot = slot.reshape(B, S, k)
    return slot, slot < C


def moe_apply(params: Params, cfg: ModelConfig, x: Tensor, *,
              use_kernels: bool = False, losses: bool = True
              ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, S, d) -> (y (B, S, d), aux losses). ``losses=False`` (prefill
    and decode, whose callers drop the losses, as the reference's compiled
    serving step drops them) skips the loss arithmetic and returns an
    empty dict for them."""
    m = cfg.moe
    B0, S0, d = x.shape
    dt = x.dtype
    decode = S0 == 1
    xr = x.reshape(1, B0, d) if decode else x   # decode pools over the batch
    C = m.tokens_capacity(xr.shape[1])
    manual = EP.manual_state()
    topi, topw, aux = _route(params["router"], xr, m, losses,
                             *((manual.dp, manual.mesh) if manual else ()))
    slot, keep = _slots(topi, C)
    mode = EP.manual_shard_mode(m, params) if manual else None
    if mode is not None:
        y = EP.ep_manual_combine(params, m, xr, topi, topw, slot, keep, C,
                                 axis=manual.model_axis, mode=mode,
                                 mesh=manual.mesh)
    else:
        y = EP.local_combine(xr, topi, topw, slot, keep, params["w_gate"],
                             params["w_up"], params["w_down"], C)
    if decode:
        y = y.reshape(B0, S0, d)
    if m.n_shared_experts:
        y = y + mlp_apply(params["shared"], x, use_kernels=use_kernels)
    return y.to(dt), aux
