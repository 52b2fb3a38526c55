"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``, and
the config axis's broadcast rule.

Leaves are visited in ``jax.tree.flatten`` order for dicts (keys sorted,
recursively), so a flattened list lines up with mmtpu's.

The config axis (the sweep's K configs trained as one program) is a leading
axis on every per-config tensor: latents ``(K, B, D)``, weights ``(K, D,
F)``, biases ``(K, F)``, and per-config scalars ``(K,)``.  The step math
counts dims from the end, so the same functions serve one config (no
leading axis) and K; :func:`per_config` views a ``(K,)`` value to an
operand's rank.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch


def per_config(value, ndim: int):
    """``value`` shaped to broadcast against a rank-``ndim`` operand whose
    leading axis is the config axis: a ``(K,)`` tensor becomes ``(K, 1, ...,
    1)``; a number or a 0-d tensor (one config) is returned as it is."""
    if isinstance(value, torch.Tensor) and value.ndim == 1 and ndim > 1:
        return value.reshape(value.shape[0], *([1] * (ndim - 1)))
    return value


def rowwise(v: torch.Tensor) -> torch.Tensor:
    """A bias or feature vector against ``(..., B, F)`` rows: a per-config
    ``(K, F)`` one gains the row axis; one config's ``(F,)`` broadcasts as
    it is."""
    return v.unsqueeze(-2) if v.ndim > 1 else v


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
