"""Parameter trees: nested dicts and lists of tensors, as in the JAX package.

Leaves are visited in ``jax.tree.flatten`` order (dict keys sorted, lists in
order), so per-leaf work such as noise draws follows the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def leaves(tree: Tree) -> List[Any]:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in leaves(t)]
    if tree is None:
        return []
    return [tree]


def unflatten(like: Tree, flat: List[Any]) -> Tree:
    """Rebuild ``like``'s structure from leaves in :func:`leaves` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):   # NamedTuple
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        if t is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of one structure."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
