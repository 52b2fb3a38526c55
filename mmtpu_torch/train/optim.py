"""SGD/Adam over parameter trees (port of :mod:`mmtpu.train.optim`).

The update laws are mmtpu's, written out rather than taken from
``torch.optim``: Adam with ``betas=(0.9, 0.999)``, ``eps=1e-8`` added after
the sqrt, bias corrections by ``pow`` of the step count; SGD is ``p -= lr*g``
with no moment buffers.  ``active=False`` makes a step a no-op.  A dense Adam
step over a table moves every row, including rows whose gradient is zero
(torch-Adam's "stale momentum").  Per-leaf ``gates`` freeze single leaves
(parameter and moments).

Epoch-level lazy Adam (mmtpu's sweep default, ``LatentFitSpec.lazy_adam``):
in a permuted epoch each latent row is in exactly one minibatch, and every
other step of the epoch moves it by stale momentum alone.  Those zero-gradient
steps have a closed form in the row's moments, so the fits step only the
batch's rows: :func:`lazy_adam_catch_up` applies a block's ``s`` pending
steps before its forward, :func:`lazy_adam_touch` its real step, and
:func:`lazy_adam_epilogue`, once per epoch, every block's remaining steps.
The values are dense Adam's up to float rounding (``beta**k`` by ``pow``, a
summed subtraction in place of ``k`` separate ones).

Under the sweep's config axis every leaf has a leading ``(K,)`` axis, and
``lr``, ``active``, the gates and the step count are ``(K,)`` tensors, each
viewed to a leaf's rank (:func:`mmtpu_torch.tree.per_config`): config k
steps with its own rate and only when its own mask is on.

The Adam law of :func:`opt_update` and :func:`lazy_adam_touch` goes through
:mod:`mmtpu_torch.kernels.adam`: on the card one hand-written kernel launch
for a whole tree; on the CPU :func:`adam_plain` and :func:`adam_leaf`, the
law in plain PyTorch and the kernel's twin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mmtpu_torch.kernels import adam as adam_kernel
from mmtpu_torch.tree import per_config, tree_map

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


def init_opt_state(params, kind: str | None = None, n_configs: int | None = None) -> OptState:
    """Moment buffers for Adam (and for ``kind=None``); none for ``"sgd"``.
    With ``n_configs`` the step count is one per config."""
    shape = () if n_configs is None else (n_configs,)
    count = torch.zeros(shape, dtype=torch.int32, device=_device_of(params))
    if kind == "sgd":
        return OptState(m=None, v=None, count=count)
    return OptState(m=tree_map(torch.zeros_like, params),
                    v=tree_map(torch.zeros_like, params), count=count)


def _select(active, new, old):
    if isinstance(active, bool):
        return new if active else old
    return torch.where(per_config(active, new.ndim), new, old)


def _gated(active, gate):
    """``active and gate > 0``: a bool while both are Python values, else a
    bool tensor (0-d, or ``(K,)`` per config).  No tensor is read on the
    host and none is made from host data, so a captured step may call it."""
    if isinstance(gate, torch.Tensor):
        on = gate > 0
        if isinstance(active, bool):
            return on if active else torch.zeros_like(on)
        return on & active
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
    ``lr`` is a float or a 0-d float32 tensor.  Under a config axis ``lr``,
    ``active``, the gates and ``state.count`` are ``(K,)``.  ``gates``, a tree like
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
        new_params = tree_map(
            lambda p, g, gt: _select(_gated(active, gt), p - per_config(lr, p.ndim) * g, p),
            params, grads, gates)
        return new_params, OptState(m=None, v=None, count=new_count)
    if kind != "adam":
        raise NotImplementedError(f"optimizer kind {kind!r}")

    bc1 = 1.0 - torch.pow(_B1, count.to(torch.float32))
    bc2 = 1.0 - torch.pow(_B2, count.to(torch.float32))
    new_params, m, v = adam_kernel.adam_tree(params, grads, state.m, state.v, lr, bc1, bc2,
                                             active, gates)
    return new_params, OptState(m=m, v=v, count=new_count)


def adam_leaf(p, g, m, v, lr, bc1, bc2):
    """One tensor's Adam step, ungated: ``(p2, m2, v2)``.  ``lr`` and the
    bias corrections are numbers, 0-d tensors or ``(K,)`` per config."""
    nd = p.ndim
    m2 = _B1 * m + (1.0 - _B1) * g
    v2 = _B2 * v + (1.0 - _B2) * torch.square(g)
    b1, b2 = per_config(bc1, nd), per_config(bc2, nd)
    return p - per_config(lr, nd) * (m2 / b1) / (torch.sqrt(v2 / b2) + _EPS), m2, v2


def adam_plain(params, grads, m, v, lr, bc1, bc2, active=True, gates=None):
    """``(params2, m2, v2)``: :func:`opt_update`'s Adam law over a tree in
    plain PyTorch (about 18 elementwise kernels a leaf), with the caller's
    bias corrections; each leaf moves where ``active`` and its gate are on.
    The twin of :func:`mmtpu_torch.kernels.adam.adam_tree`."""
    if gates is None:
        gates = tree_map(lambda _: 1.0, params)

    def leaf(p, g, m, v, gt):
        on = _gated(active, gt)
        p2, m2, v2 = adam_leaf(p, g, m, v, lr, bc1, bc2)
        return _select(on, p2, p), _select(on, m2, m), _select(on, v2, v)

    out = tree_map(leaf, params, grads, m, v, gates)
    pick = lambda i: tree_map(lambda t: t[i], out) if isinstance(out, dict) else out[i]
    return pick(0), pick(1), pick(2)


def lazy_adam_coeffs(count0: torch.Tensor, n_steps: int, lr):
    """Per-epoch coefficients of the lazy-Adam closed forms, each ``(n_steps,)``
    (``(K, n_steps)`` for a ``(K,)`` count and rate; entry ``j-1`` is epoch
    step ``j``, global step ``count0 + j``):
    ``(A1, A2, bc1, bc2, s)`` with ``A1 = lr * beta1**j / bc1`` and
    ``A2 = beta2**j / bc2``, so that the zero-gradient step ``j`` moves a
    parameter by ``A1 * m0 / (sqrt(A2 * v0) + eps)``, and ``s`` the block
    indices ``0 .. n_steps-1`` as float32 on the device, the exponents of
    :func:`lazy_adam_catch_up`'s moment decays.  Powers and bias corrections
    in float32 on ``count0``'s device, as mmtpu's."""
    j = torch.arange(1, n_steps + 1, dtype=torch.float32, device=count0.device)
    t = per_config(count0.to(torch.float32), 2) + j
    bc1 = 1.0 - torch.pow(_B1, t)
    bc2 = 1.0 - torch.pow(_B2, t)
    return (per_config(lr, 2) * torch.pow(_B1, j) / bc1, torch.pow(_B2, j) / bc2, bc1, bc2,
            j - 1.0)


@torch.no_grad()
def lazy_adam_catch_up(p0, m0, v0, s: int, coeffs):
    """A block's state after its ``s`` pending zero-gradient steps of the
    epoch (``s = 0``: unchanged).  The decays' exponent is entry ``s`` of
    the coefficients' device vector: nothing is copied from the host, so a
    captured epoch may call it.

    The pending steps' terms go to buffers of one size for every block (the
    epoch's last block's ``S - 1`` steps), in the layout that the operations
    would give them (a config axis outside the steps), so the sum reads the
    same values in the same order.  Terms sized by ``s`` would grow at each
    step of the epoch, each larger than any block freed before it, and take
    a new segment of a captured epoch's memory pool at every step."""
    if s == 0:
        return p0, m0, v0
    # (s, [K,] 1, 1): the pending steps lead, against (..., B, D) blocks
    a1, a2 = (c[..., :s].movedim(-1, 0)[..., None, None] for c in coeffs[:2])
    work = m0.new_empty(2, *m0.shape[:-2], coeffs[0].shape[-1] - 1, *m0.shape[-2:])
    den, terms = (w[..., :s, :, :].movedim(-3, 0) for w in work)
    torch.mul(a2, v0, out=den)
    den.sqrt_().add_(_EPS)
    torch.mul(a1, m0, out=terms)
    p_s = p0 - torch.sum(terms.div_(den), dim=0)
    sf = coeffs[4][s]
    return p_s, torch.pow(_B1, sf) * m0, torch.pow(_B2, sf) * v0


@torch.no_grad()
def lazy_adam_touch(p_s, m_s, v_s, g, s: int, lr, coeffs):
    """The block's real Adam step at epoch step index ``s`` (0-based; global
    step ``count0 + s + 1``), :func:`opt_update`'s law: on the card one
    launch of :func:`mmtpu_torch.kernels.adam.adam_touch`."""
    return adam_kernel.adam_touch(p_s, m_s, v_s, g, lr, coeffs[2][..., s], coeffs[3][..., s])


@torch.no_grad()
def lazy_adam_epilogue(p, m, v, n_steps: int, bsz: int, lr, coeffs):
    """Every block's remaining ``S-1-s`` zero-gradient steps, once per epoch.

    ``p, m, v`` are the permuted ``(S*B, D)`` tables after the epoch's steps
    (``(K, S*B, D)`` under a config axis): block ``s`` (rows ``[s*B,
    (s+1)*B)``) holds its just-stepped state.  The ``S-1`` decay offsets are
    added one ``(S, B, D)`` pass at a time (offset ``k`` reaches blocks ``s <
    S-k``), so nothing ``S``-fold is materialised at table scale."""
    S, B = n_steps, bsz
    if S <= 1:
        return p, m, v
    bc1, bc2 = coeffs[2], coeffs[3]
    lead, D = p.shape[:-2], p.shape[-1]
    mb, vb = m.reshape(*lead, S, B, D), v.reshape(*lead, S, B, D)
    k = torch.arange(1, S, dtype=torch.float32, device=p.device)
    b1k, b2k = torch.pow(_B1, k), torch.pow(_B2, k)
    lr = per_config(lr, 2)
    delta = torch.zeros_like(mb)
    for i in range(1, S):  # offset k = i: block s's step s + i, for s < S - i
        c1 = (lr * b1k[i - 1] / bc1[..., i:])[..., None, None]
        c2 = (b2k[i - 1] / bc2[..., i:])[..., None, None]
        delta[..., :S - i, :, :] += c1 * mb[..., :S - i, :, :] / (
            torch.sqrt(c2 * vb[..., :S - i, :, :]) + _EPS)
    rest = torch.arange(S - 1, -1, -1, dtype=torch.float32, device=p.device)[:, None, None]
    flat = lambda t: t.reshape(*lead, S * B, D)
    return (p - flat(delta), flat(torch.pow(_B1, rest) * mb), flat(torch.pow(_B2, rest) * vb))
