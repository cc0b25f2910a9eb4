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

``restore`` also reads the JAX package's sharded layout (one
``{kind}_{step}.shard{proc}.npz`` a process, each entry name carrying its
shard's global index) and reassembles full arrays. Writing that layout
comes with the parallel slice.
"""
from __future__ import annotations

import glob
import json
import os
import types
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import convert, tree

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


def save(path: str, step: int, params: Any, opt_state: Any = None,
         extra: Optional[Dict[str, Any]] = None,
         bn_state: Any = None, *, sharded: bool = False) -> None:
    """Write ``step``'s trees and meta, then point ``latest`` at it."""
    if sharded:
        raise NotImplementedError("the sharded checkpoint layout comes with "
                                  "the parallel slice (train/parallel.py)")
    os.makedirs(path, exist_ok=True)
    for kind, t in zip(_KINDS, (params, opt_state, bn_state)):
        if t is not None:
            np.savez(os.path.join(path, f"{kind}_{step}.npz"), **_flatten(t))
    with open(os.path.join(path, f"meta_{step}.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f)
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
