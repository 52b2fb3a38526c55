"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

Leaves are visited in ``jax.tree.flatten`` order for dicts (keys sorted,
recursively), so a flattened list lines up with mmtpu's.
"""

from __future__ import annotations

from typing import Callable, Mapping


def tree_leaves(tree) -> list:
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> object:
    """Rebuild ``like``'s structure from ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}  # keep the caller's key order
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)
