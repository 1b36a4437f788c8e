"""Nested-dict parameter trees (the port's stand-in for JAX pytrees).

A tree is a dict whose values are trees or leaves (tensors, arrays).  Keys
are walked in sorted order, the order ``jax.tree_util`` flattens dicts in,
so leaf lists line up with the reference's."""
from __future__ import annotations

from typing import Callable, List


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf-wise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree, prefix: str = "") -> List[str]:
    """Leaf paths in ``jax.tree_util.keystr`` form (``['heads']['w0']``)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    return [prefix]


def tree_unflatten(template, leaves: List):
    """Rebuild ``template``'s structure from leaves in :func:`tree_leaves`
    order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out
