"""Evaluation metrics on numpy predictions (the part of
:mod:`mmtpu.eval.metrics` that the reports use).

``weighted_f1`` is sklearn's ``f1_score(..., average='weighted')`` over
rounded integer classes, computed in float32 over the bin range [-20, 20] as
mmtpu computes it.  Callers keep the reference's swapped argument order
(predictions in the ``y_true`` slot, ``losses.py:291``).
"""

from __future__ import annotations

import numpy as np

_BIN_LO, _BIN_HI = -20, 20


def _class_index(labels: np.ndarray) -> np.ndarray:
    """Bin of each rounded label; NaN (a diverged run's prediction) falls in
    bin 0, as in mmtpu's float-to-int conversion."""
    n_bins = _BIN_HI - _BIN_LO + 1
    shifted = np.clip(labels - _BIN_LO, 0, n_bins - 1)
    return np.where(np.isnan(shifted), 0, shifted).astype(np.int64)


def weighted_f1(y_true: np.ndarray, y_pred: np.ndarray) -> np.float32:
    n_bins = _BIN_HI - _BIN_LO + 1
    t = np.round(np.asarray(y_true, np.float32).reshape(-1))
    p = np.round(np.asarray(y_pred, np.float32).reshape(-1))
    t_idx = _class_index(t)
    true_c = np.bincount(t_idx, minlength=n_bins).astype(np.float32)
    pred_c = np.bincount(_class_index(p), minlength=n_bins).astype(np.float32)
    tp = np.bincount(t_idx, weights=(t == p), minlength=n_bins).astype(np.float32)
    precision = np.where(pred_c > 0, tp / np.maximum(pred_c, 1.0), 0.0).astype(np.float32)
    recall = np.where(true_c > 0, tp / np.maximum(true_c, 1.0), 0.0).astype(np.float32)
    f1 = np.where(precision + recall > 0,
                  2.0 * precision * recall / np.maximum(precision + recall, 1e-30),
                  0.0).astype(np.float32)
    return np.float32(np.sum(f1 * true_c) / np.maximum(np.sum(true_c), 1.0))
