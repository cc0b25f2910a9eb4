"""Parameter and batch partition specs (the port of
``repro.sharding.rules``): Megatron over the mesh's ``model`` axis and
FSDP over its data axes.

A spec (:class:`P`) holds one entry per dim of its leaf, as the
reference's ``PartitionSpec``: None (replicated), an axis name, or a tuple
of names (sharded over their product). Every rule degrades: an axis is
applied to a dim only if the dim divides by its size, else that dim
replicates (qwen2's 60 experts, phi3's 40 heads).

Specs are derived from the leaves' path strings (dict keys and list
indices joined by "/"), so the naming conventions (wq/wk/wv/wo,
w_gate/w_up/w_down, in_proj/out_proj, embed/head) pick the rules. The
port's decoder holds one tree per body layer
(``stack/body/<slot>/<layer>/...``) where the reference stacks them on a
leading axis, so a port leaf's spec is the reference's without that
leading None; the same holds for :func:`cache_specs` (the serving
caches), and :func:`cache_slice` cuts a whole cache into a rank's slice.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Tuple

from repro_torch.launch.mesh import dp_axes, fsdp_axes, spec_axes


class P:
    """A partition spec: one entry per dim (None, an axis name or a tuple
    of names). Iterates, indexes and compares like the tuple of its
    entries, but is a leaf of the port's trees (which recurse into
    tuples)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        try:
            return self.entries == tuple(other)
        except TypeError:
            return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def map_with_path(fn: Callable[[str, Any], Any], t: Any,
                  prefix: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists, the path as
    :func:`path_str` renders it."""
    if isinstance(t, dict):
        return {k: map_with_path(fn, v, prefix + (str(k),))
                for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(map_with_path(fn, x, prefix + (str(i),))
                       for i, x in enumerate(t))
    return None if t is None else fn(path_str(prefix), t)


def path_str(path) -> str:
    """Render a path (a sequence of keys and indices) as "a/b/c"."""
    return "/".join(str(p) for p in path)


def _fits(dim: int, mesh, axis) -> bool:
    """Is ``dim`` divisible by the (possibly tuple) mesh axis size?"""
    if axis is None:
        return True
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= mesh.shape[a]
    return dim % size == 0


def _spec(mesh, shape, *axes) -> P:
    """A spec, dropping axes that don't divide evenly."""
    return P(*(ax if _fits(dim, mesh, ax) else None
               for dim, ax in zip(shape, axes)))


def _param_rule(path: str, shape: Tuple[int, ...], mesh, fsdp) -> P:
    ndim = len(shape)

    def spec(*axes):
        return _spec(mesh, shape, *axes)

    # embeddings / unembedding: (V, D) -> vocab on model, D fsdp
    if re.search(r"(^|/)(embed|head)$", path) and ndim == 2:
        return spec("model", fsdp)
    # norms, biases, small vectors: replicated
    if re.search(r"(norm|scale|bias|gamma|beta|dt_bias|(^|/)D$)", path):
        return P(*([None] * ndim))
    # MoE
    if "/ff/router" in path:
        return P(*([None] * ndim))
    if re.search(r"/ff/w_(gate|up)$", path) and ndim == 3:
        # (E, D, d_expert): expert-sharded (or ffn-sharded fallback)
        if _fits(shape[0], mesh, "model"):
            return spec("model", fsdp, None)
        return spec(None, fsdp, "model")
    if re.search(r"/ff/w_down$", path) and ndim == 3:
        if _fits(shape[0], mesh, "model"):
            return spec("model", None, fsdp)
        return spec(None, "model", fsdp)
    # dense mlp / shared expert: (D, F) and (F, D)
    if re.search(r"w_(gate|up)$", path) and ndim == 2:
        return spec(fsdp, "model")
    if re.search(r"w_down$", path) and ndim == 2:
        return spec("model", fsdp)
    # attention: fused (D, H*hd) / (H*hd, D)
    if re.search(r"w[qkv]$", path) and ndim == 2:
        return spec(fsdp, "model")
    if re.search(r"wo$", path) and ndim == 2:
        return spec("model", fsdp)
    # mamba
    if re.search(r"in_proj$", path):
        return spec(fsdp, "model")
    if re.search(r"out_proj$", path):
        return spec("model", fsdp)
    if re.search(r"conv_w$", path):
        return spec(None, "model")
    if re.search(r"x_proj$", path):
        return spec("model", None)
    if re.search(r"dt_proj$", path):
        return spec(None, "model")
    if re.search(r"A_log$", path):
        return spec("model", None)
    # vision heads and anything else: replicated
    return P(*([None] * ndim))


def fsdp_entry(mesh):
    """The FSDP axes as one spec entry: the bare name, or the tuple."""
    fsdp = fsdp_axes(mesh)
    return fsdp if len(fsdp) > 1 else fsdp[0]


def param_specs(params: Any, mesh, cfg=None) -> Any:
    """The spec tree matching the parameter tree (tensors, or anything
    with a ``shape``)."""
    fsdp = fsdp_entry(mesh)
    return map_with_path(
        lambda p, leaf: _param_rule(p, tuple(leaf.shape), mesh, fsdp),
        params)


def batch_spec(mesh, global_batch: int, ndim: int = 2) -> P:
    """Shard the batch dim over the data(+pod) axes when divisible."""
    dp = dp_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    if not _fits(global_batch, mesh, dp):
        dp = None
    return P(dp, *([None] * (ndim - 1)))


def cache_specs(cache: Any, mesh, global_batch: int) -> Any:
    """KV/SSM/cross cache specs (the reference's ``cache_specs``): the
    batch over the data axes when ``global_batch`` divides; kv heads over
    "model" when they divide, else the cache's sequence (the
    reference's all-reduced decode softmax; the port serves no such
    layout, see ``serving.ContinuousEngine``); Mamba state's d_inner over
    "model". The page pool (``kp``/``vp`` and its int8 scales ``ks``/
    ``vs``) is row-agnostic, so it never splits over the batch: kv heads
    over "model" when they divide, else replicated. The block table's
    rows split like the batch."""
    dp = dp_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    b_ax = dp if _fits(global_batch, mesh, dp) else None

    def one(p: str, leaf) -> P:
        core = tuple(leaf.shape)
        if p.endswith("/h"):              # (B, d_inner, d_state)
            return _spec(mesh, core, b_ax, "model", None)
        if p.endswith("/conv"):           # (B, k-1, d_inner)
            return _spec(mesh, core, b_ax, None, "model")
        if "cross_" in p:                 # (B, mem, kv, hd)
            return _spec(mesh, core, b_ax, None, "model", None)
        if re.search(r"/(kh|vh)$", p):    # head-major k/v: (B, kv, S, hd)
            if _fits(core[1], mesh, "model"):
                return _spec(mesh, core, b_ax, "model", None, None)
            return _spec(mesh, core, b_ax, None, "model", None)
        if re.search(r"/(kp|vp)$", p):    # page pool: (pages, kv, ps, hd)
            if _fits(core[1], mesh, "model"):
                return _spec(mesh, core, None, "model", None, None)
            return P(*([None] * len(core)))
        if re.search(r"/(ks|vs)$", p):    # int8 scales: (pages, kv, ps)
            if _fits(core[1], mesh, "model"):
                return _spec(mesh, core, None, "model", None)
            return P(*([None] * len(core)))
        if p.endswith("/pt"):             # block table: (B, n_blocks)
            return _spec(mesh, core, b_ax, None)
        if _fits(core[2], mesh, "model"):  # k/v: (B, S, kv, hd)
            return _spec(mesh, core, b_ax, None, "model", None)
        return _spec(mesh, core, b_ax, "model", None, None)

    return map_with_path(one, cache)


def cache_slice(mesh, cache: Any, specs: Any) -> Any:
    """This rank's slice of a whole cache (the same on every rank), each
    leaf cut by its spec onto ``mesh.device`` (``global_array``). A leaf
    that several layers share (the paged layout's one block table) is cut
    once and stays shared. A leaf on the "meta" device (a cache built for
    its shapes only) gives zeros of the slice's shape."""
    import torch
    from repro_torch.launch.mesh import global_array
    done = {}

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, sv) for v, sv in zip(t, s))
        if id(t) not in done:
            if t.device.type == "meta":
                shape = [d // mesh.axis_size(spec_axes(e))
                         for d, e in zip(t.shape, s)]
                done[id(t)] = torch.zeros(shape, dtype=t.dtype,
                                          device=mesh.device)
            else:
                done[id(t)] = global_array(mesh, t, s)
        return done[id(t)]

    return walk(cache, specs)
