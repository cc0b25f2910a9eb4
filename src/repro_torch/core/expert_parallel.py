"""Expert dispatch and combine of the MoE feed-forward, local and
expert-parallel (the port of ``repro.core.expert_parallel``).

At the MoE boundary the tokens are data-sharded and replicated over the
model axis: every model rank already holds all tokens of its data row, so
each rank

  1. masks the (token, k) assignments routed to its E/msize local experts,
  2. scatters them into its local dispatch buffer,
  3. runs the local expert products,
  4. gathers and weights its partial outputs, and
  5. sums the partials over the model axis (one activation-sized
     all-reduce a layer: the same cost as a Megatron MLP block).

No all-to-all is needed in this replicated-token layout: the sum IS the
combine. Routing (top-k, capacity slots) happens outside, replicated.

Manual mode. A train step sharded over a mesh (:mod:`repro_torch.train.
parallel`) runs the model inside :func:`manual_mode`, the per-process twin
of the reference's ``shard_map`` region: :func:`manual_state` tells the
model code the model axis, its size, the data axes and the mesh, and the
model code infers from each leaf's shape whether it holds a slice
(:func:`manual_shard_mode`, ``models.blocks._tp_axis``).

Differentiability: a partial-sum region is fenced by an adjoint pair,
:func:`region_in` (identity forward, sum backward) on every replicated
tensor entering it and :func:`region_out` (sum forward, identity backward)
on the combine, so the gradients of the sharded weights and of every
replicated upstream parameter equal the single-device step's.
:func:`mean_in_fwd` (mean forward, identity backward) makes the router's
load-balance statistics global over the data axes. All three are
``torch.autograd.Function`` s over the mesh's groups.

Layout of the local path: the reference's (B, E, C, d) dispatch buffer is
held expert-major as ``E * B * C`` rows of d (row ``e*B*C + b*C + slot``),
so the expert products are one batched product over E with no copy, plus
one trash row that every dropped assignment is written to and no product
reads. Every kept (b, e, slot) is unique, so the scatter is an indexed
copy (no accumulating atomics) and the result does not depend on the
write order. In the backward the combine's row reads become an index add
whose only repeated rows are dropped assignments' reads of slot 0, which
add exact zeros, so gradients repeat bit for bit as well.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import MODEL_AXIS

Params = Dict[str, Any]
Tensor = torch.Tensor


def ep_applicable(m: MoEConfig, mesh, batch: int, batch_axis: int) -> bool:
    if mesh is None or MODEL_AXIS not in mesh.axis_names:
        return False
    if m.shard_axis != "expert":
        return False
    return m.n_experts % mesh.shape[MODEL_AXIS] == 0


# ---------------------------------------------------------------------------
# manual-region context
# ---------------------------------------------------------------------------


class Manual(NamedTuple):
    model_axis: Optional[str]
    model_size: int
    dp: Tuple[str, ...]
    mesh: Any


_MANUAL: List[Manual] = []


@contextmanager
def manual_mode(model_axis: Optional[str], model_size: int = 1,
                dp: Tuple[str, ...] = (), mesh=None):
    """"The model runs on this rank's slices of a ``mesh`` whose model
    axis is ``model_axis`` of ``model_size`` and whose data axes are
    ``dp``." The MoE layer and the blocks read it (:func:`manual_state`)
    to fence their partial sums and route the expert dispatch through
    :func:`ep_manual_combine`."""
    _MANUAL.append(Manual(model_axis, model_size, tuple(dp), mesh))
    try:
        yield
    finally:
        _MANUAL.pop()


def manual_state() -> Optional[Manual]:
    return _MANUAL[-1] if _MANUAL else None


def manual_shard_mode(m: MoEConfig, params: Params) -> Optional[str]:
    """How the expert weights handed to this manual region are sliced:
    "expert" (E/msize local experts), "ffn" (all E, d_expert/msize hidden)
    or None (whole: the plain local path). Inferred from the leaf shapes,
    so it always agrees with the spec builder
    (:func:`repro_torch.train.parallel.mesh_param_specs`)."""
    st = manual_state()
    if st is None or st.model_axis is None:
        return None
    msize = st.model_size
    E_loc, _, f_loc = params["w_gate"].shape
    if E_loc * msize == m.n_experts:
        return "expert"
    if E_loc == m.n_experts and f_loc * msize == m.d_expert:
        return "ffn"
    return None


def _mesh(mesh):
    if mesh is not None:
        return mesh
    st = manual_state()
    if st is None or st.mesh is None:
        raise RuntimeError("a collective fence outside manual_mode needs "
                           "its mesh")
    return st.mesh


# ---------------------------------------------------------------------------
# adjoint fences around a partial-sum region
# ---------------------------------------------------------------------------


class _RegionIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.psum(g.contiguous(), ctx.axis, ctx.mesh), None, None


class _RegionOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, axis, mesh):
        return C.psum(y.contiguous(), axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MeanInFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return C.pmean(x.contiguous(), axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def region_in(x: Tensor, axis, mesh=None) -> Tensor:
    """Identity forward / sum over ``axis`` backward: wraps every
    replicated differentiable tensor entering a partial computation, whose
    cotangent on each rank covers only that rank's share."""
    return _RegionIn.apply(x, axis, _mesh(mesh))


def region_out(y: Tensor, axis, mesh=None) -> Tensor:
    """Sum over ``axis`` forward / identity backward: the combine. The
    output's cotangent is replicated and each rank's partial wants exactly
    that cotangent."""
    return _RegionOut.apply(y, axis, _mesh(mesh))


def mean_in_fwd(x: Tensor, axes, mesh=None) -> Tensor:
    """Mean over ``axes`` forward / identity backward, for a loss that is
    not linear in per-shard means (the router's ``E * sum_e f_e * P_e``):
    the value is the global one, and each rank's per-token cotangent stays
    unscaled, so after the step's gradient mean over the data axes each
    token's contribution lands exactly once."""
    return _MeanInFwd.apply(x, axes, _mesh(mesh))


# ---------------------------------------------------------------------------
# the dispatch -> expert FF -> combine
# ---------------------------------------------------------------------------


def dispatch_rows(topi: Tensor, slot: Tensor, C_: int) -> Tensor:
    """(B, S, k) routing -> each assignment's row ``e*B*C + b*C + slot`` in
    the expert-major buffer (meaningful where ``slot < C``, the kept
    assignments)."""
    B = topi.shape[0]
    b = torch.arange(B, device=topi.device)[:, None, None]
    return topi * (B * C_) + b * C_ + slot


def scatter(x: Tensor, rows: Tensor, keep: Tensor, n_rows: int) -> Tensor:
    """x (B, S, d) into a zeroed (n_rows + 1, d) buffer, one k-assignment at
    a time: kept assignments at ``rows``, dropped ones at the trash row
    ``n_rows``."""
    d = x.shape[-1]
    src = x.reshape(-1, d)
    dest = torch.where(keep, rows, n_rows)
    buf = x.new_zeros((n_rows + 1, d))
    for j in range(rows.shape[-1]):
        buf.index_copy_(0, dest[:, :, j].reshape(-1), src)
    return buf


def expert_ff(buf: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor
              ) -> Tensor:
    """(E, R, d) rows through each expert's SwiGLU -> (E, R, d): the
    reference's ``becd,edf->becf`` products, batched over E."""
    dt = buf.dtype
    g = F.silu(torch.bmm(buf, w_gate.to(dt)))
    u = torch.bmm(buf, w_up.to(dt))
    return torch.bmm(g * u, w_down.to(dt))


def gather_combine(y_rows: Tensor, rows: Tensor, topw: Tensor,
                   keep: Tensor, slot_zero: Tensor) -> Tensor:
    """Each token's expert outputs weighted by ``topw * keep`` and summed
    over j in order. A dropped assignment reads its expert's slot 0 (as
    the reference does) and weighs it by 0."""
    B, S, k = rows.shape
    d = y_rows.shape[-1]
    dt = y_rows.dtype
    idx = torch.where(keep, rows, slot_zero)
    wk = topw.to(dt) * keep.to(dt)
    y = torch.zeros((B, S, d), dtype=dt, device=y_rows.device)
    for j in range(k):
        yj = y_rows.index_select(0, idx[:, :, j].reshape(-1)).reshape(B, S, d)
        y = y + yj * wk[:, :, j, None]
    return y


def local_combine(x: Tensor, topi: Tensor, topw: Tensor, slot: Tensor,
                  keep: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor,
                  C_: int) -> Tensor:
    """Scatter -> expert SwiGLU -> gather -> combine with every expert of
    ``w_gate`` local. x: (B, S, d) tokens; topi/topw/slot/keep: (B, S, k)
    routing, ``topi`` indexing the experts of the weights given; w_gate/
    w_up (E, d, f), w_down (E, f, d). Returns (B, S, d) in x's dtype,
    without the shared expert."""
    B = x.shape[0]
    E, d = w_gate.shape[0], x.shape[-1]
    n_rows = E * B * C_
    rows = dispatch_rows(topi, slot, C_)
    buf = scatter(x, rows, keep, n_rows)
    y_rows = expert_ff(buf[:n_rows].view(E, B * C_, d), w_gate, w_up, w_down)
    slot_zero = rows - slot
    return gather_combine(y_rows.view(n_rows, d), rows, topw, keep,
                          slot_zero)


def _sharded_combine(x: Tensor, topi: Tensor, topw: Tensor, slot: Tensor,
                     keep: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
                     C_: int, *, axis: str, mode: str, mesh) -> Tensor:
    """One rank's scatter -> expert SwiGLU -> gather, then the combine sum
    over ``axis``. Tokens and routing are replicated over ``axis``; wg/
    wu/wd are the rank's slice: (E/msize, d, f) in "expert" mode, (E, d,
    f/msize) / (E, f/msize, d) in "ffn" mode."""
    x = region_in(x, axis, mesh)
    topw = region_in(topw, axis, mesh)
    if mode == "expert":
        E_loc = wg.shape[0]
        lo = C.axis_index(axis, mesh) * E_loc
        local = (topi >= lo) & (topi < lo + E_loc) & keep
        e_loc = torch.where(local, topi - lo, 0)
    else:                                                   # "ffn"
        local, e_loc = keep, topi
    y = local_combine(x, e_loc, topw, torch.where(local, slot, 0), local,
                      wg, wu, wd, C_)
    return region_out(y, axis, mesh)


def ep_manual_combine(params: Params, m: MoEConfig, x: Tensor, topi: Tensor,
                      topw: Tensor, slot: Tensor, keep: Tensor, C_: int, *,
                      axis: str, mode: str, mesh=None) -> Tensor:
    """Dispatch + combine inside :func:`manual_mode`: the expert weights in
    ``params`` are this rank's slices (:func:`manual_shard_mode`), the
    tokens are replicated over ``axis``, and the one collective is the
    combine's sum over it."""
    return _sharded_combine(x, topi, topw, slot, keep, params["w_gate"],
                            params["w_up"], params["w_down"], C_, axis=axis,
                            mode=mode, mesh=_mesh(mesh))


def ep_dispatch_combine(params: Params, m: MoEConfig, x: Tensor,
                        topi: Tensor, topw: Tensor, slot: Tensor,
                        keep: Tensor, C_: int, mesh, *,
                        batch_axis: int = 0) -> Tensor:
    """Expert-parallel dispatch + combine over ``mesh``'s model axis from
    WHOLE expert weights. The reference runs it as a ``shard_map`` of its
    own over global arrays; with a process a rank it is the same
    computation as :func:`ep_manual_combine`: this rank takes its E/msize
    experts of ``params`` and its own tokens (``x``: (B, S, d), routing
    (B, S, k); ``batch_axis`` is the reference's and selects nothing
    here) and sums the partials over the model group."""
    msize = mesh.shape[MODEL_AXIS]
    E_loc = m.n_experts // msize
    lo = C.axis_index(MODEL_AXIS, mesh) * E_loc
    w = {k: params[k][lo:lo + E_loc] for k in ("w_gate", "w_up", "w_down")}
    return _sharded_combine(x, topi, topw, slot, keep, w["w_gate"],
                            w["w_up"], w["w_down"], C_, axis=MODEL_AXIS,
                            mode="expert", mesh=mesh)
