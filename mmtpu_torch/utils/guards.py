"""Numeric failure detection (port of :mod:`mmtpu.utils.guards`).

The reference's failure handling is ``print`` + ``sys.exit()`` on infinite
losses (``losses.py:258-264``, ``simplesif.py:515-537``): it kills the whole
process mid-sweep.  The port raises a typed exception that the caller can
catch, and offers an in-step check that warns and goes on.
"""

from __future__ import annotations

import warnings

import torch


class FiniteError(RuntimeError):
    """Raised when a tensor that must be finite holds inf or NaN."""


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite(tree, where: str = "") -> None:
    """Raise :class:`FiniteError` naming every floating leaf of ``tree``
    (nested dicts, lists and tuples of tensors or arrays) that holds a
    non-finite value (a check after a fit)."""
    bad = []
    for path, leaf in _leaves(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point():
            n_bad = int((~torch.isfinite(t)).sum())
            if n_bad:
                bad.append(f"{path}: {n_bad}/{t.numel()} non-finite")
    if bad:
        prefix = f"{where}: " if where else ""
        raise FiniteError(prefix + "; ".join(bad))


def debug_assert_finite(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """Warn when ``x`` holds a non-finite value and return it unchanged:
    as mmtpu's, it does not abort (pair it with :func:`check_finite` on the
    outputs to fail).  Reading the flag waits for the device."""
    if not bool(torch.isfinite(x).all()):
        warnings.warn(f"[mmtpu_torch] {name} non-finite", RuntimeWarning, stacklevel=2)
    return x
