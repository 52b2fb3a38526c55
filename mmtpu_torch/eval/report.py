"""Host-side result reports with the reference's output contract (port of
:mod:`mmtpu.eval.report`, whose module imports mmtpu's jax metrics).

``full_loss`` (MOSI), ``iemocap_loss`` and ``pom_loss`` take numpy
predictions and return the same keys, rounding and swapped-F1 quirk as
mmtpu's (``losses.py:276-366``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from mmtpu_torch.eval.metrics import weighted_f1


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """sklearn-compatible confusion matrix over the sorted union of labels."""
    labels = np.unique(np.concatenate([y_true, y_pred]))
    index = {v: i for i, v in enumerate(labels)}
    out = np.zeros((len(labels), len(labels)), dtype=np.int64)
    for t, p in zip(y_true, y_pred):
        out[index[t], index[p]] += 1
    return out


def classification_report_dict(y_true: np.ndarray, y_pred: np.ndarray) -> Dict:
    """sklearn ``classification_report(..., output_dict=True)`` equivalent."""
    labels = np.unique(np.concatenate([y_true, y_pred]))
    report: Dict = {}
    precisions, recalls, f1s, supports = [], [], [], []
    for lab in labels:
        tp = np.sum((y_true == lab) & (y_pred == lab))
        pred_c = np.sum(y_pred == lab)
        true_c = np.sum(y_true == lab)
        precision = tp / pred_c if pred_c else 0.0
        recall = tp / true_c if true_c else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        report[str(lab)] = {
            "precision": float(precision),
            "recall": float(recall),
            "f1-score": float(f1),
            "support": float(true_c),
        }
        precisions.append(precision)
        recalls.append(recall)
        f1s.append(f1)
        supports.append(true_c)
    supports_arr = np.asarray(supports, dtype=np.float64)
    total = supports_arr.sum()
    report["accuracy"] = float(np.mean(y_true == y_pred))
    report["macro avg"] = {
        "precision": float(np.mean(precisions)),
        "recall": float(np.mean(recalls)),
        "f1-score": float(np.mean(f1s)),
        "support": float(total),
    }
    wts = supports_arr / total if total else supports_arr
    report["weighted avg"] = {
        "precision": float(np.sum(np.asarray(precisions) * wts)),
        "recall": float(np.sum(np.asarray(recalls) * wts)),
        "f1-score": float(np.sum(np.asarray(f1s) * wts)),
        "support": float(total),
    }
    return report


def full_loss(predictions: np.ndarray, y_test: np.ndarray, verbose: bool = True) -> Dict:
    """MOSI regression metrics + binary-classification report."""
    predictions = np.asarray(predictions).flatten()
    y_test = np.asarray(y_test).flatten()
    mae = float(np.mean(np.absolute(predictions - y_test)))
    corr = float(np.corrcoef(predictions, y_test)[0][1])
    mult = round(float(np.sum(np.round(predictions) == np.round(y_test)) / len(y_test)), 5)
    # sic: predictions occupy the y_true slot (losses.py:291)
    f_score = round(float(weighted_f1(predictions, y_test)), 5)

    true_label = y_test >= 0
    predicted_label = predictions >= 0
    accuracy = float(np.mean(true_label == predicted_label))
    conf = confusion_matrix(true_label, predicted_label)
    report = classification_report_dict(true_label, predicted_label)
    if verbose:
        print(f"mae: {mae}\ncorr: {corr}\nmult_acc: {mult}\nmult f_score: {f_score}")
        print(f"Confusion Matrix :\n{conf}\nAccuracy {accuracy}")
    return {
        "mae": mae,
        "accuracy": accuracy,
        "corr": corr,
        "mult_acc": mult,
        "f_score": f_score,
        "confusion_matrix": conf.tolist(),
        "class_report": report,
    }


def iemocap_loss(predictions: np.ndarray, y_test: np.ndarray, verbose: bool = True) -> Dict:
    """Argmax accuracy + weighted F1 over class indices."""
    t = np.argmax(np.asarray(y_test), axis=1)
    p = np.argmax(np.asarray(predictions), axis=1)
    f_score = float(weighted_f1(t.astype(float), p.astype(float)))
    accuracy = float(np.mean(t == p))
    conf = confusion_matrix(t, p)
    report = classification_report_dict(t, p)
    if verbose:
        print(f"F1 score: {f_score}\nAccuracy: {accuracy}")
    return {
        "accuracy": accuracy,
        "f_score": f_score,
        "confusion_matrix": conf.tolist(),
        "class_report": report,
    }


def pom_loss(predictions: np.ndarray, y_test: np.ndarray, verbose: bool = True) -> Dict:
    """Per-trait metric lists with the reference's rounding."""
    predictions = np.asarray(predictions)
    y_test = np.asarray(y_test)
    n_traits = y_test.shape[1]
    mae = [float(np.float32(round(float(a), 3)))
           for a in np.mean(np.absolute(predictions - y_test), axis=0)]
    corr = [
        round(float(np.corrcoef(predictions[:, i], y_test[:, i])[0][1]), 3)
        for i in range(n_traits)
    ]
    mult = [
        round(float(np.sum(np.round(predictions[:, i]) == np.round(y_test[:, i])) / len(y_test)), 3)
        for i in range(n_traits)
    ]
    f_score: List[float] = [
        round(float(weighted_f1(predictions[:, i], y_test[:, i])), 5)
        for i in range(n_traits)
    ]
    if verbose:
        print(f"mae: {mae}\ncorr: {corr}\nmult_acc: {mult}\nf_score: {f_score}")
    return {"mae": mae, "corr": corr, "mult_acc": mult, "f_score": f_score}
