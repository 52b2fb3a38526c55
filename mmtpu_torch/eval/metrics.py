"""Evaluation metrics (port of :mod:`mmtpu.eval.metrics`).

``weighted_f1`` is sklearn's ``f1_score(..., average='weighted')`` over
rounded integer classes, computed in float32 over the bin range [-20, 20] as
mmtpu computes it, on numpy predictions (the reports' form).  Callers keep
the reference's swapped argument order (predictions in the ``y_true`` slot,
``losses.py:291``).

:func:`mosi_metrics`, :func:`pom_metrics` and :func:`iemocap_metrics` are
the sweep's score phase: torch on the predictions' device, one value per
config when the predictions lead with a config axis (``(K, N)``, ``(K, N,
T)``, ``(K, N, C)`` against shared ``(N,)``, ``(N, T)``, ``(N, C)`` labels).
"""

from __future__ import annotations

import numpy as np
import torch

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


def _class_bins(x: torch.Tensor) -> torch.Tensor:
    """One-hot ``(..., N, n_bins)`` of the rounded-class bin of each value;
    NaN falls in bin 0, as in :func:`_class_index`."""
    n_bins = _BIN_HI - _BIN_LO + 1
    shifted = torch.clamp(x - _BIN_LO, 0, n_bins - 1)
    idx = torch.where(torch.isnan(shifted), 0.0, shifted).to(torch.long)
    return (idx[..., None] == torch.arange(n_bins, device=x.device)).to(torch.float32)


def device_weighted_f1(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """:func:`weighted_f1` over the last axis of torch tensors (leading axes
    broadcast, one score each)."""
    t, p = torch.round(y_true), torch.round(y_pred)
    t_bins = _class_bins(t)
    true_c = torch.sum(t_bins, dim=-2)
    pred_c = torch.sum(_class_bins(p), dim=-2)
    tp = torch.sum(t_bins * (t == p).to(torch.float32)[..., None], dim=-2)
    precision = torch.where(pred_c > 0, tp / torch.clamp_min(pred_c, 1.0), 0.0)
    recall = torch.where(true_c > 0, tp / torch.clamp_min(true_c, 1.0), 0.0)
    f1 = torch.where(precision + recall > 0,
                     2.0 * precision * recall / torch.clamp_min(precision + recall, 1e-30), 0.0)
    return torch.sum(f1 * true_c, dim=-1) / torch.clamp_min(torch.sum(true_c, dim=-1), 1.0)


def _pearson(pred: torch.Tensor, y: torch.Tensor, dim: int) -> torch.Tensor:
    pc = pred - torch.mean(pred, dim=dim, keepdim=True)
    tc = y - torch.mean(y, dim=dim, keepdim=True)
    return torch.sum(pc * tc, dim=dim) / torch.sqrt(
        torch.sum(pc * pc, dim=dim) * torch.sum(tc * tc, dim=dim))


def _match(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.mean((a == b).to(torch.float32), dim=dim)


def mosi_metrics(pred: torch.Tensor, y: torch.Tensor) -> dict:
    """mae / corr / mult_acc / f_score / accuracy of ``(..., N)`` predictions
    (reference ``full_loss``, ``losses.py:276-315``; f_score in its swapped
    order)."""
    return {
        "mae": torch.mean(torch.abs(pred - y), dim=-1),
        "corr": _pearson(pred, y, -1),
        "mult_acc": _match(torch.round(pred), torch.round(y), -1),
        "f_score": device_weighted_f1(pred, y),  # sic: losses.py:291
        "accuracy": _match(pred >= 0, y >= 0, -1),
    }


def iemocap_metrics(pred: torch.Tensor, y: torch.Tensor) -> dict:
    """Argmax accuracy and weighted F1 over class indices of ``(..., N, C)``
    predictions (``iemocap_loss``, ``losses.py:317-340``)."""
    t = torch.argmax(y, dim=-1).to(torch.float32)
    p = torch.argmax(pred, dim=-1).to(torch.float32)
    return {"accuracy": _match(t, p, -1), "f_score": device_weighted_f1(t, p)}


def pom_metrics(pred: torch.Tensor, y: torch.Tensor) -> dict:
    """Per-trait mae / corr / mult_acc / f_score of ``(..., N, T)``
    predictions, each ``(..., T)`` (``pom_loss``, ``losses.py:342-366``)."""
    return {
        "mae": torch.mean(torch.abs(pred - y), dim=-2),
        "corr": _pearson(pred, y, -2),
        "mult_acc": _match(torch.round(pred), torch.round(y), -2),
        # sic: predictions first (losses.py:353-356)
        "f_score": device_weighted_f1(pred.transpose(-1, -2), y.transpose(-1, -2)),
    }
