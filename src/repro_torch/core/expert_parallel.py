"""Expert dispatch and combine of the MoE feed-forward (the port of
``repro.core.expert_parallel``), single-device path.

The reference's production path shards the experts over the mesh's model
axis (``shard_map``, one ``psum`` a layer) and fences the partial sums with
an adjoint pair (``region_in``/``region_out``, ``mean_in_fwd``). Here every
expert is local: :func:`local_combine` is the per-shard scatter -> expert
SwiGLU -> gather of the reference's ``_local_combine`` with the identity in
place of the fences, which is also the reference's no-mesh fallback in
``repro.models.moe.moe_apply``. The sharded entry points
(``ep_applicable``, ``ep_dispatch_combine``, the manual-mode fences) need
``torch.distributed`` and come with the parallel slice (A7 + A14 in
ROADMAP.md).

Layout: the reference's (B, E, C, d) dispatch buffer is held expert-major
as ``E * B * C`` rows of d (row ``e*B*C + b*C + slot``), so the expert
products are one batched product over E with no copy, plus one trash row
that every dropped assignment is written to and no product reads. Every
kept (b, e, slot) is unique, so the scatter is an indexed copy (no
accumulating atomics) and the result does not depend on the write order.
In the backward the combine's row reads become an index add whose only
repeated rows are dropped assignments' reads of slot 0, which add exact
zeros, so gradients repeat bit for bit as well.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def dispatch_rows(topi: Tensor, slot: Tensor, C: int) -> Tensor:
    """(B, S, k) routing -> each assignment's row ``e*B*C + b*C + slot`` in
    the expert-major buffer (meaningful where ``slot < C``, the kept
    assignments)."""
    B = topi.shape[0]
    b = torch.arange(B, device=topi.device)[:, None, None]
    return topi * (B * C) + b * C + slot


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
                  C: int) -> Tensor:
    """Scatter -> expert SwiGLU -> gather -> combine with every expert
    local. x: (B, S, d) tokens; topi/topw/slot/keep: (B, S, k) routing;
    w_gate/w_up (E, d, f), w_down (E, f, d). Returns (B, S, d) in x's
    dtype, without the shared expert."""
    B = x.shape[0]
    E, d = w_gate.shape[0], x.shape[-1]
    n_rows = E * B * C
    rows = dispatch_rows(topi, slot, C)
    buf = scatter(x, rows, keep, n_rows)
    y_rows = expert_ff(buf[:n_rows].view(E, B * C, d), w_gate, w_up, w_down)
    slot_zero = rows - slot
    return gather_combine(y_rows.view(n_rows, d), rows, topw, keep,
                          slot_zero)
