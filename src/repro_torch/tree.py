"""Minimal pytree helpers over nested dicts / lists / tuples of tensors.

The port keeps the reference's parameter layout (``state_tree``: dicts
of arrays, lists of per-layer dicts), so optimizer states and the numpy
bridge walk the same structures.  Dict keys are visited in sorted order,
like ``jax.tree_util``, so leaf lists line up with the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of ``tree`` in canonical (sorted-key) order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """Rebuild ``like``'s structure from ``leaves`` (canonical order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)
