"""SGD/Adam over parameter trees (port of :mod:`mmtpu.train.optim`).

The update laws are mmtpu's, written out rather than taken from
``torch.optim``: Adam with ``betas=(0.9, 0.999)``, ``eps=1e-8`` added after
the sqrt, bias corrections by ``pow`` of the step count; SGD is ``p -= lr*g``
with no moment buffers.  ``active=False`` makes a step a no-op.  A dense Adam
step over a table moves every row, including rows whose gradient is zero
(torch-Adam's "stale momentum").  Per-leaf ``gates`` freeze single leaves
(parameter and moments).  Lazy Adam is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mmtpu_torch.tree import tree_map

OPT_SGD = 0
OPT_ADAM = 1
OPT_CODES = {"sgd": OPT_SGD, "adam": OPT_ADAM}
OPT_KINDS = {v: k for k, v in OPT_CODES.items()}

_B1 = 0.9
_B2 = 0.999
_EPS = 1e-8


class OptState(NamedTuple):
    m: object  # first-moment tree (same structure as params); None for SGD
    v: object  # second-moment tree; None for SGD
    count: torch.Tensor  # 0-d int32 step counter


def _device_of(params) -> torch.device:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.device


def init_opt_state(params, kind: str | None = None) -> OptState:
    """Moment buffers for Adam (and for ``kind=None``); none for ``"sgd"``."""
    count = torch.zeros((), dtype=torch.int32, device=_device_of(params))
    if kind == "sgd":
        return OptState(m=None, v=None, count=count)
    return OptState(m=tree_map(torch.zeros_like, params),
                    v=tree_map(torch.zeros_like, params), count=count)


def _select(active, new, old):
    if isinstance(active, bool):
        return new if active else old
    return torch.where(active, new, old)


def _gated(active, gate):
    """``active and gate > 0``: a bool while both are Python values, else a
    0-d bool tensor."""
    if isinstance(gate, torch.Tensor):
        on = gate > 0
        return on if active is True else on & torch.as_tensor(active, device=on.device)
    if isinstance(active, torch.Tensor):
        return active & (gate > 0)
    return bool(active) and gate > 0


@torch.no_grad()
def opt_update(params, grads, state: OptState, lr, opt_code, active=True,
               kind: str | None = None, gates=None):
    """One optimizer step; returns ``(new_params, new_state)``.

    ``kind`` ("sgd" | "adam") fixes the law; without it ``opt_code``
    (``OPT_SGD`` | ``OPT_ADAM``) picks it.  ``active`` is a bool or a 0-d
    bool tensor; when false, parameters, moments and the count stay.
    ``lr`` is a float or a 0-d float32 tensor.  ``gates``, a tree like
    ``params`` of 0/1 scalars (numbers or 0-d tensors), freezes each leaf
    whose gate is 0: neither the parameter nor its moments move, as for a
    torch parameter with ``requires_grad=False``.  The count advances with
    ``active`` alone, as in mmtpu.
    """
    kind = kind or OPT_KINDS[int(opt_code)]
    count = state.count + 1
    new_count = _select(active, count, state.count)
    if gates is None:
        gates = tree_map(lambda _: 1.0, params)
    if kind == "sgd":
        new_params = tree_map(lambda p, g, gt: _select(_gated(active, gt), p - lr * g, p),
                              params, grads, gates)
        return new_params, OptState(m=None, v=None, count=new_count)
    if kind != "adam":
        raise NotImplementedError(f"optimizer kind {kind!r}")

    bc1 = 1.0 - torch.pow(_B1, count.to(torch.float32))
    bc2 = 1.0 - torch.pow(_B2, count.to(torch.float32))

    def leaf(p, g, m, v, gt):
        on = _gated(active, gt)
        m2 = _B1 * m + (1.0 - _B1) * g
        v2 = _B2 * v + (1.0 - _B2) * torch.square(g)
        p2 = p - lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + _EPS)
        return _select(on, p2, p), _select(on, m2, m), _select(on, v2, v)

    out = tree_map(leaf, params, grads, state.m, state.v, gates)
    pick = lambda i: tree_map(lambda t: t[i], out) if isinstance(out, dict) else out[i]
    return pick(0), OptState(m=pick(1), v=pick(2), count=new_count)
