"""The sharded train steps over a process mesh (the port of
``repro.train.parallel``): pod? x data x model, one process a rank.

Every rank runs the single-device code on its own slices, and the
collectives (:mod:`repro_torch.launch.collectives`, all built from
``all_reduce``) sit exactly where the reference's ``shard_map`` regions put
``psum`` / ``pmean`` / ``all_gather``:

- the global batch splits over ``dp_axes(mesh)`` (pod x data), rank order;
- MoE expert weights shard over "model" (the expert axis when it divides,
  else each expert's hidden dim), from the same
  :func:`repro_torch.sharding.rules.param_specs` rules, restricted to what
  the model code handles (:func:`mesh_param_specs`);
- ``tp=True`` also Megatron-shards the attention (head-split q/k/v
  columns, wo rows) and the dense MLP (w_gate/w_up columns, w_down rows);
  the blocks see the slice by its shape and fence the sublayer
  (``models.blocks._tp_axis``), so the one extra collective is a sum a
  fenced sublayer;
- ``fsdp=True`` shards every remaining large parameter, and with it its
  optimizer moments, over the dp axes: the step gathers each such leaf on
  entry to the loss, the gather's backward sums the cotangents and keeps
  this rank's piece (a reduce-scatter), and the sum becomes a mean; the
  optimizers are elementwise per leaf, so each rank's update IS its slice
  of the whole update;
- everything else replicates; gradients of replicated leaves are averaged
  over the dp axes, and grad-clip's global norm is assembled from one sum
  per distinct axis set (:func:`sharded_global_norm`).

Ghost statistics never cross processes: each rank normalizes, and draws
gradient noise, on its own slice. A rank's trees are its slices, made by
:func:`shard_tree` from the whole trees (the same on every rank) and
reassembled by :func:`unshard_tree`.

Not DDP, torch FSDP, SyncBatchNorm or DTensor: each changes what the
reference computes (ghost statistics per rank, FSDP gradients as sums
rescaled to means, the global norm per axis set).
"""
from __future__ import annotations

import re
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core import expert_parallel as EP
from repro_torch.core.clipping import clip_by_global_norm
from repro_torch.core.large_batch import LargeBatchConfig
from repro_torch.core.regime import Regime
from repro_torch.launch import collectives as C
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MODEL_AXIS, spec_axes
from repro_torch.models import transformer as T
from repro_torch.optim import adam, sgd
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P
from repro_torch.train.trainer import _grads, make_vision_loss_fn

Params = Any

_EXPERT_RE = re.compile(r"/ff/w_(gate|up|down)$")
_TP_ATTN_RE = re.compile(r"/mixer/w[qkvo]$")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _spec_axes(spec) -> Tuple[str, ...]:
    """All mesh axis names a spec shards over (tuples flattened)."""
    return tuple(a for e in spec for a in spec_axes(e))


def _fsdp_entry(spec) -> Optional[Tuple[int, Tuple[str, ...]]]:
    """(dim, dp-axes) of a spec's FSDP entry (the first entry naming
    non-model axes), or None for TP-only and replicated leaves."""
    for i, e in enumerate(spec):
        if e is None or e == MODEL_AXIS:
            continue
        return i, spec_axes(e)
    return None


def mesh_param_specs(params: Params, mesh, *, cfg: Optional[ModelConfig] = None,
                     tp: bool = False, fsdp: bool = False) -> Params:
    """The spec tree of a parameter tree on ``mesh``: the
    :func:`repro_torch.sharding.rules.param_specs` rules restricted to what
    the model code handles.

    Default: only the MoE expert tensors keep their "model" entry;
    everything else replicates. ``tp=True`` (needs ``cfg``) also keeps
    "model" on the rank-2 attention projections (``/mixer/w[qkvo]``, when
    both head counts divide the model size) and the dense MLP weights
    (``/ff/w_(gate|up|down)``, when ``d_ff`` divides); embed and head stay
    replicated (no vocab parallelism). ``fsdp=True`` keeps the rules'
    dp-axes entries (large tensors whose dim divides). Works on meshes
    without a "model" axis too (pure-dp FSDP)."""
    if tp and cfg is None:
        raise ValueError("tp=True needs cfg to gate the head/ff splits")
    has_model = MODEL_AXIS in mesh.axis_names
    if not has_model and not fsdp:
        return tree.map(lambda l: P(*([None] * len(l.shape))), params)
    rules_mesh = mesh
    if not has_model:
        # a model=1 view of the mesh for the rules; every "model" entry
        # they produce is dropped below
        rules_mesh = SimpleNamespace(
            axis_names=tuple(mesh.axis_names) + (MODEL_AXIS,),
            shape={**dict(mesh.shape), MODEL_AXIS: 1})
    msize = mesh_lib.axis_size(mesh, MODEL_AXIS)

    fsdp_ent = rules.fsdp_entry(rules_mesh)

    def one(p, leaf):
        spec = rules._param_rule(p, tuple(leaf.shape), rules_mesh, fsdp_ent)
        rank = len(leaf.shape)
        keep_model = bool(_EXPERT_RE.search(p)) and rank == 3
        if tp and has_model and msize > 1 and rank == 2:
            if _TP_ATTN_RE.search(p):
                keep_model = (cfg.n_heads % msize == 0
                              and cfg.n_kv_heads % msize == 0)
            elif _EXPERT_RE.search(p):
                keep_model = cfg.d_ff % msize == 0

        def ent(e):
            if e is None:
                return None
            if e == MODEL_AXIS or (isinstance(e, tuple) and MODEL_AXIS in e):
                return e if (keep_model and has_model) else None
            return e if fsdp else None
        return P(*(ent(e) for e in spec))

    return rules.map_with_path(one, params)


def opt_state_specs(pspecs: Params, optimizer: str = "sgd"):
    """The optimizer state's specs: its moments laid out like the
    parameters, the step counter replicated."""
    if optimizer == "adam":
        return adam.AdamState(mu=pspecs, nu=pspecs, step=P())
    return sgd.SGDState(momentum=pspecs, step=P())


def mesh_compatible(lb: LargeBatchConfig, mesh, *, batch_size: int = 0,
                    cfg: Optional[ModelConfig] = None) -> bool:
    """True when a run's geometry fits ``mesh``: the batch splits evenly
    over the dp axes and each dp shard into whole ghost batches (the
    invariant that keeps sharded statistics those of the single-device
    step); with a >1 model axis and an MoE ``cfg``, the experts shard
    (the expert axis or each expert's hidden dim divides)."""
    b = batch_size or lb.batch_size
    nd = mesh_lib.dp_size(mesh)
    if nd == 0 or b % nd:
        return False
    local = b // nd
    if lb.use_gbn and local % lb.ghost_batch_size:
        return False
    msize = mesh_lib.axis_size(mesh, MODEL_AXIS)
    if msize > 1 and cfg is not None and getattr(cfg, "moe", None) is not None:
        m = cfg.moe
        if m.n_experts % msize and m.d_expert % msize:
            return False
    return True


def shard_tree(mesh, t: Params, specs: Params) -> Params:
    """This rank's slices of a whole tree (the same on every rank), each
    its own contiguous tensor on ``mesh.device``."""
    return tree.map(lambda a, s: mesh_lib.global_array(mesh, a, s), t, specs)


def unshard_tree(mesh, t: Params, specs: Params) -> Params:
    """The whole tree from every rank's slices (gathered along each
    sharded dim); every rank gets it."""
    def one(a, s):
        for dim, e in enumerate(s):
            a = C.all_gather(a.contiguous(), spec_axes(e), mesh, dim)
        return a
    return tree.map(one, t, specs)


def sharded_global_norm(grads: Params, pspecs: Params, mesh) -> torch.Tensor:
    """(The reference's ``_sharded_global_norm``.) The global norm of a
    sharded tree: leaves sharded over a set of axes
    (model for TP and experts, dp for FSDP, both for TP+FSDP) contribute
    their local sum of squares through one sum over that set; replicated
    leaves are counted once."""
    groups: Dict[frozenset, torch.Tensor] = {}
    for g, s in zip(tree.leaves(grads), tree.leaves(pspecs)):
        axes = frozenset(_spec_axes(s))
        ss = g.float().square().sum()
        groups[axes] = groups[axes] + ss if axes in groups else ss
    total = None
    for axes, ss in sorted(groups.items(), key=lambda kv: sorted(kv[0])):
        part = C.psum(ss, tuple(sorted(axes)), mesh) if axes else ss
        total = part if total is None else total + part
    return total.sqrt()



def state_bytes_per_device(t: Params, specs: Params, mesh) -> int:
    """A rank's bytes of a (params or optimizer-state) tree laid out by
    ``specs`` on ``mesh`` (tensors, or anything with ``shape`` and a torch
    ``dtype``)."""
    total = 0
    for leaf, spec in zip(tree.leaves(t), tree.leaves(specs)):
        n = 1
        for a in _spec_axes(spec):
            n *= mesh.shape[a]
        numel = 1
        for d in leaf.shape:
            numel *= d
        total += int(numel * leaf.dtype.itemsize // n)
    return total


# ---------------------------------------------------------------------------
# LM train step (data x model)
# ---------------------------------------------------------------------------


class _FSDPGather(torch.autograd.Function):
    """The whole leaf from its dp pieces; the backward sums the
    cotangents over the same ranks and keeps this rank's piece."""

    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return C.all_gather(x.contiguous(), axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return (C.psum_scatter(g.contiguous(), ctx.axes, ctx.mesh, ctx.dim),
                None, None, None)


def _finalize_grads(grads: List[torch.Tensor], specs: List[P], dp, mesh
                    ) -> List[torch.Tensor]:
    """FSDP leaves arrive as reduce-scattered sums over their gather axes
    (divided here into means); every other leaf is averaged over the dp
    axes it is not sharded on, the leaves sharing those axes in one
    all-reduce."""
    out = list(grads)
    buckets: Dict[Tuple[str, ...], List[int]] = {}
    for i, s in enumerate(specs):
        ent = _fsdp_entry(s)
        scattered = ent[1] if ent is not None else ()
        if scattered:
            out[i] = out[i] / float(mesh.axis_size(scattered))
        rest = tuple(a for a in dp if a not in scattered)
        if rest:
            buckets.setdefault(rest, []).append(i)
    for rest, idx in buckets.items():
        for i, g in zip(idx, C.pmean_many([out[i] for i in idx], rest,
                                          mesh)):
            out[i] = g
    return out


def make_mesh_lm_train_step(cfg: ModelConfig, lb: LargeBatchConfig,
                            regime: Regime, mesh, params: Params, *,
                            weight_decay: float = 0.0,
                            use_kernels: bool = False,
                            momentum_dtype: str = "float32",
                            remat: bool = False, seq_parallel: bool = False,
                            ce_chunk: int = 0, tp: bool = False,
                            fsdp: bool = False,
                            optimizer: str = "sgd") -> Callable:
    """The LM train step sharded pod? x data x model over ``mesh``:
    (params, opt_state, batch, step, generator=None) -> (params,
    opt_state, metrics) on THIS rank's slices: ``params``/``opt_state``
    laid out by the step's ``param_specs``/``opt_specs`` attributes
    (:func:`shard_tree` of the whole trees), ``batch`` this rank's rows
    (``data.pipeline.shard_batch``). ``params`` here is the whole tree
    (or anything with its leaves' shapes) the specs derive from.

    ``seq_parallel`` is the reference's layout hint for GSPMD (the
    residual stream sharded over sequence x model between blocks); it
    changes no value and is accepted and ignored here.

    With ``lb.ghost_noise > 0`` each rank draws noise for its own slices,
    so the realization differs from the unsharded step (the distribution
    does not); equivalence runs are noise-free."""
    if momentum_dtype == "int8":
        raise NotImplementedError(
            "int8 momentum blocks the trailing dim; its quantized buffers "
            "need their own specs — use float32 momentum on a mesh")
    if optimizer not in ("sgd", "adam"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    sigma = lb.effective_noise_sigma()
    if optimizer == "adam" and sigma:
        raise NotImplementedError("ghost noise is wired into sgd.update only")
    dp = mesh_lib.dp_axes(mesh)
    model_ax = MODEL_AXIS if MODEL_AXIS in mesh.axis_names else None
    msize = mesh_lib.axis_size(mesh, MODEL_AXIS)
    pspecs = mesh_param_specs(params, mesh, cfg=cfg, tp=tp, fsdp=fsdp)
    specs = tree.leaves(pspecs)
    gathers = [_fsdp_entry(s) for s in specs]     # None: not FSDP-sharded

    def train_step(params: Params, opt_state, batch: Dict[str, torch.Tensor],
                   step: int, generator: Optional[torch.Generator] = None):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        whole = [l if g is None else _FSDPGather.apply(l, g[0], g[1], mesh)
                 for l, g in zip(leaves, gathers)]
        with EP.manual_mode(model_ax, msize, dp, mesh):
            loss, metrics = T.lm_loss(tree.unflatten(params, whole), cfg,
                                      batch, use_kernels=use_kernels,
                                      remat=remat, ce_chunk=ce_chunk)
        grads = _finalize_grads(_grads(loss, leaves), specs, dp, mesh)
        names = list(metrics)
        scalars = [loss.detach()] + [metrics[k].detach() for k in names]
        if dp:
            scalars = C.pmean_many(scalars, dp, mesh)
        metrics = dict(zip(names, scalars[1:]))
        clip: Dict[str, torch.Tensor] = {}
        if lb.grad_clip and lb.grad_clip > 0:
            norm = sharded_global_norm(grads, specs, mesh)
            gtree, gnorm = clip_by_global_norm(
                tree.unflatten(params, grads), lb.grad_clip, norm=norm)
            clip["grad_norm"] = gnorm
        else:
            gtree = tree.unflatten(params, grads)
        detached = tree.unflatten(params, [p.detach() for p in leaves])
        lr = regime.lr_at(step).to(loss.device)
        if optimizer == "adam":
            params2, opt_state2, m = adam.update(
                gtree, opt_state, detached, lr=lr,
                weight_decay=weight_decay, grad_clip=0.0)
        else:
            params2, opt_state2, m = sgd.update(
                gtree, opt_state, detached, lr=lr, momentum=lb.momentum,
                nesterov=lb.nesterov, weight_decay=weight_decay,
                grad_clip=0.0, noise_sigma=sigma, generator=generator)
        return params2, opt_state2, {"loss": scalars[0], "lr": lr,
                                     **metrics, **m, **clip}

    train_step.param_specs = pspecs
    train_step.opt_specs = opt_state_specs(pspecs, optimizer)
    return train_step


def make_mesh_lm_eval_step(cfg: ModelConfig, mesh, *,
                           use_kernels: bool = False) -> Callable:
    """(params, batch) -> mean next-token CE on this rank's parameter
    slices (no FSDP) and a batch every rank holds whole: the model runs in
    the manual region with no data axes, so the experts' partial outputs
    sum over the model axis and nothing else crosses ranks."""
    model_ax = MODEL_AXIS if MODEL_AXIS in mesh.axis_names else None
    msize = mesh_lib.axis_size(mesh, MODEL_AXIS)

    @torch.no_grad()
    def eval_step(params: Params, batch: Dict[str, torch.Tensor]):
        with EP.manual_mode(model_ax, msize, (), mesh):
            _, metrics = T.lm_loss(params, cfg, batch,
                                   use_kernels=use_kernels)
        return metrics["ce"]

    return eval_step


# ---------------------------------------------------------------------------
# vision train step (dp over any mesh; a model axis replicates)
# ---------------------------------------------------------------------------


def make_mesh_vision_grads(model_apply: Callable, cfg, lb: LargeBatchConfig,
                           mesh, *, use_kernels: bool = False) -> Callable:
    """(params, bn_state, x, y) on this rank's rows -> (loss, acc,
    new_bn_state, grads), each averaged over the dp axes in ONE
    all-reduce: every gradient, the two metrics and the running-statistics
    EMA (each rank folds its own ghosts first; the boolean
    ``initialized`` flag is the same everywhere and not reduced). The
    ghost statistics that normalize the activations stay on the rank."""
    loss_fn = make_vision_loss_fn(model_apply, cfg, lb,
                                  use_kernels=use_kernels)
    dp = mesh_lib.dp_axes(mesh)

    def grads_fn(params: Params, bn_state: Params, x: torch.Tensor,
                 y: torch.Tensor):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        loss, (new_state, acc) = loss_fn(tree.unflatten(params, leaves),
                                         bn_state, x, y)
        grads = list(torch.autograd.grad(loss, leaves))
        st = tree.leaves(new_state)
        fl = [i for i, s in enumerate(st) if s.dtype != torch.bool]
        if dp:
            n = len(grads)
            red = C.pmean_many(grads + [loss.detach(), acc.float()]
                               + [st[i] for i in fl], dp, mesh)
            grads, loss, acc = red[:n], red[n], red[n + 1]
            for i, s in zip(fl, red[n + 2:]):
                st[i] = s
            new_state = tree.unflatten(new_state, st)
        return (loss.detach(), acc, new_state,
                tree.unflatten(params, grads))

    return grads_fn


def make_mesh_vision_train_step(model_apply: Callable, cfg,
                                lb: LargeBatchConfig, regime: Regime, mesh,
                                *, weight_decay: float = 5e-4,
                                use_kernels: bool = False) -> Callable:
    """The per-rank twin of :func:`repro_torch.train.trainer.
    make_vision_train_step` over any mesh: (params, bn_state, opt_state,
    x, y, step, generator=None) -> (params, bn_state, opt_state, metrics),
    with ``x``/``y`` this rank's rows and everything else replicated. The
    SGD update runs on every rank from the same averaged gradients (and a
    generator seeded alike everywhere for the noise), so the ranks'
    parameters stay bit-identical."""
    sigma = lb.effective_noise_sigma()
    grads_fn = make_mesh_vision_grads(model_apply, cfg, lb, mesh,
                                      use_kernels=use_kernels)

    def train_step(params: Params, bn_state: Params,
                   opt_state: sgd.SGDState, x: torch.Tensor,
                   y: torch.Tensor, step: int,
                   generator: Optional[torch.Generator] = None):
        loss, acc, new_state, grads = grads_fn(params, bn_state, x, y)
        lr = regime.lr_at(step).to(x.device)
        params2, opt_state2, m = sgd.update(
            grads, opt_state, tree.map(lambda p: p.detach(), params),
            lr=lr, momentum=lb.momentum, weight_decay=weight_decay,
            grad_clip=lb.grad_clip, noise_sigma=sigma, generator=generator)
        return params2, new_state, opt_state2, {
            "loss": loss, "acc": acc, "lr": lr, **m}

    return train_step
