"""The comparison that decides ``correct``: the program's answers at the
picked configs of the window's first call against the plain reference's,
stage by stage, each number beside its limit.

A whole grid run cannot be held to a reference coordinate by coordinate:
2,100 Adam steps carry any difference of rounding into the trained state
(Adam's first step moves a coordinate by ``lr * sign(g)``, which flips
where ``g`` is within rounding of zero; a one-ulp change of the SIF init
and TF32 products each moved the final losses by 0.02-2.4 % on the CPU).
So the reference runs the whole joint fit from the seed, and each later
phase from what the program's phase before it handed on; the numbers that
hold those hand-offs to the seed are norms and losses, which rounding
moves little and a fault moves much:

- ``train_loss_gap``: the joint fit's first ``check_epochs`` epoch losses
  (the decoder and heads, the word likelihood's K1 and per-token term, the
  e2e sentiment head and lazy Adam, from the SIF init and the draws),
  relative to the reference's;
- ``train_change_gap``: the trained state that the joint fit hands on
  after all its epochs (the train latents and each leaf of the decoder):
  the gap between the norm of the program's change from the initial value
  and the reference's, by the worst leaf, relative to the reference's norm
  of that leaf or of the median leaf, whichever is larger.  Its final loss
  is not compared: the loss, a weighted negative log-likelihood plus an L1
  term, can end near 0, where a relative gap of rounding reads 3-6;
- ``infer_change_gap``: the valid and test latents fitted against the
  program's trained decoder, whole fits: the gap of the norm of their
  change from the SIF init, relative to the reference's;
- ``senti_loss_gap``: the sentiment fit on the program's train latents,
  from its initial draw: its first ``check_epochs`` epoch losses, relative
  to the reference's;
- ``pred_gap``: the test predictions from the program's sentiment
  parameters and test latents: the largest gap, in the label's units;
- ``metric_gap``: the test MAE and correlation: the largest gap.

A value that is not finite in the program's answers is an infinite gap,
except at a config that the program flagged ``diverged`` and whose joint
fit the reference's own, from the seed, ends not finite too: there a
value not finite on both sides is a gap of 0.  A test metric that is not
finite on both sides from finite predictions (the correlation of constant
predictions) is a gap of 0 too: the predictions are held by ``pred_gap``.
The limits of a cell are in ``benchmark/limits/<cell>.json``, set between
the sound runs' largest reading and the control's and the faults'
smallest (``PERF.md`` gives both).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return (x.to(torch.float64).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float64))


def _gap(a, b, scale, excused: bool) -> float:
    """``max |a - b| / scale``; where ``a`` is not finite the gap is
    infinite unless ``excused`` and ``b`` is not finite either (then 0);
    where only ``b`` is not finite it is infinite."""
    a, b, scale = np.broadcast_arrays(_np(a), _np(b), _np(scale))
    fa, fb = np.isfinite(a), np.isfinite(b)
    with np.errstate(invalid="ignore", divide="ignore"):
        g = np.abs(a - b) / np.maximum(scale, 1e-30)
    g = np.where(fa & fb, g, np.where(~fa & ~fb & excused, 0.0, np.inf))
    return float(np.max(g, initial=0.0))


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float64)))


def _change_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                init: Dict[str, torch.Tensor], excused: bool) -> float:
    """The worst leaf's gap between the norms of the program's and the
    reference's change from ``init``, relative to the larger of the
    reference's norm of that leaf and of the median leaf."""
    dp = {k: _norm(prog[k] - init[k]) for k in ref}
    dr = {k: _norm(ref[k] - init[k]) for k in ref}
    median = float(np.median([v for v in dr.values() if np.isfinite(v)] or [np.nan]))
    return max(_gap(dp[k], dr[k], max(dr[k], median), excused) for k in ref)


def _stack(trees: List[dict]) -> Dict[str, torch.Tensor]:
    return {k: torch.cat([t[k] for t in trees]) for k in trees[0]}


def numbers(prog: Dict, ref: Dict, check_epochs: int) -> Dict[str, float]:
    """The compared numbers of the program's answers against the reference's,
    each the worst over the picked configs."""
    lp, lr = torch.stack(prog["losses"]), ref["losses"]
    n = len(prog["losses"])
    # a config may be not finite on both sides only where both say it diverged
    excused = [bool(prog["diverged"][i]) and not bool(torch.isfinite(lr[i, -1]))
               for i in range(n)]
    dec = _stack(prog["decoder"])
    sp = torch.stack(prog["senti_losses"])[:, :check_epochs]
    sr = ref["senti_losses"][:, :check_epochs]
    rows: Dict[str, list] = {k: [] for k in (
        "train_loss_gap", "train_change_gap", "infer_change_gap",
        "senti_loss_gap", "pred_gap", "metric_gap")}
    for i, ex in enumerate(excused):
        first = lr[i, :check_epochs]
        rows["train_loss_gap"].append(_gap(lp[i, :check_epochs], first, first.abs(), ex))
        trained = {"latents": prog["train"][i], **{k: v[i] for k, v in dec.items()}}
        own = {"latents": ref["latents"][i], **{k: v[i] for k, v in ref["decoder"].items()}}
        start = {"latents": ref["init"]["train"], **{k: v[i] for k, v in ref["decoder0"].items()}}
        rows["train_change_gap"].append(_change_gap(trained, own, start, ex))
        for split in ("valid", "test"):
            init = ref["init"][split]
            dr = _norm(ref[split][i] - init)
            rows["infer_change_gap"].append(_gap(_norm(prog[split][i] - init), dr, dr, ex))
        rows["senti_loss_gap"].append(_gap(sp[i], sr[i], sr[i].abs(), ex))
        pred = prog["pred"][i]
        rows["pred_gap"].append(_gap(pred, ref["pred"][i], 1.0, ex))
        scored = ex or bool(torch.isfinite(pred).all())
        rows["metric_gap"].append(max(_gap(prog["metrics"][i][k], ref["metrics"][k][i], 1.0,
                                           scored) for k in ("mae", "corr")))
    return {k: max(v) for k, v in rows.items()}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[tuple]]:
    """``(correct, [(name, value, limit), ...])``: correct where every
    number is at or under its limit (a NaN is not)."""
    rows = [(name, float(values[name]), float(limit)) for name, limit in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
