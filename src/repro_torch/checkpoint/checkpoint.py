"""Run-state checkpoints in the JAX package's npz layout (the port of
``repro.checkpoint``).

A checkpoint directory holds, for each saved step, ``params_{step}.npz``,
``opt_{step}.npz`` and ``state_{step}.npz`` (BN running statistics), the
step's ``meta_{step}.json`` and the ``latest`` pointer. Entries are named
and laid out as the JAX package writes them, so a checkpoint written by
either package restores in the other:

- names are ``jax.tree_util`` key paths joined by "/": dict keys, list
  indices, and ``.<field>`` for a NamedTuple field (``SGDState`` writes
  ``.momentum/...`` and ``.step``);
- convolution weights are HWIO, and a decoder's body layers are stacked on
  a leading ``body_repeats`` axis (:mod:`repro_torch.convert`).

The sharded layout (``save(..., sharded=True)``): each rank of a
``torch.distributed`` world writes its own ``{kind}_{step}.shard{rank}.npz``
holding its slices, each entry named ``<key>##<start:stop,...>`` after the
slice's global index (a body layer's slice also carries its
``i:i+1`` span on the stacked axis); after every rank has written, rank 0
writes the meta (with ``sharded`` and ``num_processes``) and then the
``latest`` pointer. ``restore`` (this one and the JAX package's) pastes
the pieces into full arrays: geometry-free, so a checkpoint saved by four
ranks restores in one process.
"""
from __future__ import annotations

import glob
import json
import os
import types
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert, tree
from repro_torch.device import process_index_count
from repro_torch.launch import collectives
from repro_torch.launch.mesh import spec_axes

_KINDS = ("params", "opt", "state")


def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _to_reference(t: Any) -> Any:
    """The port's tree -> numpy in the JAX package's layout."""
    if _is_namedtuple(t):
        return type(t)(*(_to_reference(x) for x in t))
    return (convert.lm_to_numpy if convert.is_decoder_tree(t)
            else convert.to_numpy)(t)


def _body_repeats(t: Any) -> int:
    """The layers a body slot of the decoder tree ``t`` holds."""
    if isinstance(t, dict):
        if set(t) == {"head", "body", "tail"}:
            return len(t["body"][0]) if t["body"] else 1
        t = list(t.values())
    return next(_body_repeats(x) for x in t if convert.is_decoder_tree(x))


def _from_reference(ref: Any, like: Any) -> Any:
    """numpy in the JAX package's layout -> tensors of ``like``'s structure,
    dtypes and device."""
    if _is_namedtuple(like):
        return type(like)(*(_from_reference(r, l) for r, l in zip(ref, like)))
    dev = tree.leaves(like)[0].device
    if convert.is_decoder_tree(like):
        # lm_to_torch reads only the body's repeats and the encoder's
        enc = like.get("encoder") if isinstance(like, dict) else None
        decoder = {k: v for k, v in like.items() if k != "encoder"} \
            if enc is not None else like
        repeats = types.SimpleNamespace(
            body_repeats=_body_repeats(decoder),
            encoder=None if enc is None else types.SimpleNamespace(
                n_layers=_body_repeats(enc)))
        out = convert.lm_to_torch(ref, repeats, dev)
    else:
        out = convert.to_torch(ref, dev)
    return tree.map(lambda t, l: t.to(l.dtype), out, like)


def _map_with_path(fn: Callable[[str, Any], Any], t: Any,
                   prefix: Tuple[str, ...] = ()) -> Any:
    """``fn(key, leaf)`` over a tree, the key as the JAX package names it."""
    if isinstance(t, dict):
        return {k: _map_with_path(fn, v, prefix + (str(k),))
                for k, v in t.items()}
    if _is_namedtuple(t):
        return type(t)(*(_map_with_path(fn, x, prefix + (f".{f}",))
                         for f, x in zip(t._fields, t)))
    if isinstance(t, (list, tuple)):
        return type(t)(_map_with_path(fn, x, prefix + (str(i),))
                       for i, x in enumerate(t))
    return None if t is None else fn("/".join(prefix), t)


def _flatten(t: Any) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    _map_with_path(flat.__setitem__, _to_reference(t))
    return flat


def _flatten_shards(t: Any, specs: Any, mesh) -> Dict[str, np.ndarray]:
    """This rank's slices of ``t`` (laid out by ``specs`` on ``mesh``;
    None: whole leaves) as ``<key>##<start:stop,...>`` entries in the JAX
    package's layout: HWIO convolutions, body layers at their index on the
    stacked axis, bf16 as f32."""
    flat: Dict[str, np.ndarray] = {}
    decoder = convert.is_decoder_tree(t)

    def leaf(key, a, s, lead):
        a = a.detach().cpu()
        a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
        spans = []
        for dim, size in enumerate(a.shape):
            axes = spec_axes(s[dim]) if s is not None else ()
            i = mesh.index(axes) if axes else 0
            spans.append((i * size, (i + 1) * size))
        if not decoder and a.ndim == 4:                   # OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
            spans = [spans[2], spans[3], spans[1], spans[0]]
        if lead is not None:
            a, spans = a[None], [lead] + spans
        tag = ",".join(f"{lo}:{hi}" for lo, hi in spans)
        flat[f"{key}##{tag}"] = np.array(a, order="C")

    def walk(x, s, prefix, lead=None):
        def sub(k):
            return None if s is None else s[k]
        if isinstance(x, dict):
            if set(x) == {"head", "body", "tail"}:
                for k in ("head", "tail"):
                    for i, b in enumerate(x[k]):
                        walk(b, None if s is None else s[k][i],
                             prefix + (k, str(i)))
                for j, layers in enumerate(x["body"]):
                    for i, b in enumerate(layers):
                        walk(b, None if s is None else s["body"][j][i],
                             prefix + ("body", str(j)), (i, i + 1))
                return
            for k, v in x.items():
                walk(v, sub(k), prefix + (str(k),), lead)
        elif _is_namedtuple(x):
            for f, v in zip(x._fields, x):
                walk(v, None if s is None else getattr(s, f),
                     prefix + (f".{f}",), lead)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, sub(i), prefix + (str(i),), lead)
        elif x is not None:
            leaf("/".join(prefix), x, s, lead)

    walk(t, specs, ())
    return flat


def save(path: str, step: int, params: Any, opt_state: Any = None,
         extra: Optional[Dict[str, Any]] = None,
         bn_state: Any = None, *, sharded: bool = False,
         layout=None) -> None:
    """Write ``step``'s trees and meta, then point ``latest`` at it.

    ``sharded=True``: every rank of the world calls ``save`` alike and
    writes its own shard files (see the module docstring); ``layout`` is
    (mesh, param specs, optimizer specs) when the trees are this rank's
    slices (:func:`repro_torch.train.parallel.shard_tree`), else the trees
    are whole on every rank."""
    os.makedirs(path, exist_ok=True)
    rank, world = process_index_count() if sharded else (0, 1)
    trees = (params, opt_state, bn_state)
    if sharded:
        mesh, pspecs, ospecs = layout if layout is not None \
            else (None, None, None)
        for kind, t, specs in zip(_KINDS, trees, (pspecs, ospecs, None)):
            if t is not None:
                np.savez(os.path.join(path, f"{kind}_{step}.shard{rank}.npz"),
                         **_flatten_shards(t, specs, mesh))
        collectives.barrier()
        if rank != 0:
            return
    else:
        for kind, t in zip(_KINDS, trees):
            if t is not None:
                np.savez(os.path.join(path, f"{kind}_{step}.npz"),
                         **_flatten(t))
    meta = {"step": step, **(extra or {})}
    if sharded:
        meta["sharded"] = True
        meta["num_processes"] = world
    with open(os.path.join(path, f"meta_{step}.json"), "w") as f:
        json.dump(meta, f)
    # the pointer last and atomically (temp + rename): a kill at any point
    # mid-save leaves either the previous pointer or the new one, never a
    # truncated "latest"
    tmp = os.path.join(path, "latest.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(path, "latest"))


def latest_step(path: str) -> Optional[int]:
    p = os.path.join(path, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _step_or_latest(path: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    return step


def load_meta(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    step = _step_or_latest(path, step)
    with open(os.path.join(path, f"meta_{step}.json")) as f:
        return json.load(f)


def _assemble_sharded(files: List[str]) -> Dict[str, np.ndarray]:
    """Reassemble full arrays from per-process shard files. Every shard
    carries its global index in the entry name
    (``<leaf-path>##<start:stop,...>``), so assembly is "allocate the
    largest extent, paste each piece": no mesh or topology knowledge."""
    pieces: Dict[str, List[Tuple[List[Tuple[int, int]], np.ndarray]]] = {}
    for fname in files:
        with np.load(fname) as data:
            for name in data.files:
                key, _, tag = name.partition("##")
                spans = [tuple(int(x) for x in p.split(":"))
                         for p in tag.split(",")] if tag else []
                pieces.setdefault(key, []).append((spans, data[name]))
    out: Dict[str, np.ndarray] = {}
    for key, parts in pieces.items():
        spans0, arr0 = parts[0]
        if not spans0:                                    # 0-d scalar
            out[key] = arr0
            continue
        shape = tuple(max(sp[d][1] for sp, _ in parts)
                      for d in range(len(spans0)))
        full = np.zeros(shape, dtype=arr0.dtype)
        for spans, piece in parts:
            full[tuple(slice(a, b) for a, b in spans)] = piece
        out[key] = full
    return out


def _load(path: str, kind: str, step: int) -> Dict[str, np.ndarray]:
    fname = os.path.join(path, f"{kind}_{step}.npz")
    if os.path.exists(fname):
        with np.load(fname) as data:
            return dict(data)
    shard_files = sorted(glob.glob(os.path.join(
        path, f"{kind}_{step}.shard*.npz")))
    if not shard_files:
        raise FileNotFoundError(fname)
    return _assemble_sharded(shard_files)


def restore(path: str, template: Any, *, step: Optional[int] = None,
            kind: str = "params") -> Tuple[Any, int]:
    """Restore a tree shaped like ``template`` (its dtypes and devices
    too). Returns (tree, step). Takes the consolidated ``{kind}_{step}.npz``
    if there is one, else the ``{kind}_{step}.shard*.npz`` files."""
    if kind not in _KINDS:
        raise ValueError(f"unknown checkpoint kind {kind!r}; have {_KINDS}")
    step = _step_or_latest(path, step)
    data = _load(path, kind, step)

    def entry(key: str, like: np.ndarray) -> np.ndarray:
        if key not in data:
            raise KeyError(f"{kind}_{step}: no entry {key!r}")
        arr = data[key]
        if arr.shape != like.shape:
            raise ValueError(f"{kind}_{step}: {key!r} has shape {arr.shape}, "
                             f"the template {like.shape}")
        return arr

    ref = _map_with_path(entry, _to_reference(template))
    return _from_reference(ref, template), step
