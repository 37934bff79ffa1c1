"""IoU-family metrics of a confusion matrix, numpy float64 (own copy of
``flairtpu/ops/confmat.py:46-90``; reference flair/metrics.py:14-84).

Rows are targets, columns predictions (sklearn's convention).
"""

from __future__ import annotations

import numpy as np


def class_iou(cm: np.ndarray) -> tuple[np.ndarray, float]:
    """Per-class IoU in % + mean (reference flair/metrics.py:14-21)."""
    cm = np.asarray(cm, np.float64)
    denom = cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm)
    with np.errstate(divide="ignore", invalid="ignore"):
        ious = 100.0 * np.diag(cm) / denom
    ious = np.nan_to_num(ious)
    return ious, float(ious.mean())


def overall_accuracy(cm: np.ndarray) -> float:
    cm = np.asarray(cm, np.float64)
    return float(100.0 * np.trace(cm) / cm.sum()) if cm.sum() else 0.0


def class_precision(cm: np.ndarray) -> tuple[np.ndarray, float]:
    cm = np.asarray(cm, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = 100.0 * np.diag(cm) / cm.sum(axis=0)
    p = np.nan_to_num(p)
    return p, float(p.mean())


def class_recall(cm: np.ndarray) -> tuple[np.ndarray, float]:
    cm = np.asarray(cm, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = 100.0 * np.diag(cm) / cm.sum(axis=1)
    r = np.nan_to_num(r)
    return r, float(r.mean())


def class_fscore(precision: np.ndarray, recall: np.ndarray) -> tuple[np.ndarray, float]:
    with np.errstate(divide="ignore", invalid="ignore"):
        f = 2 * precision * recall / (precision + recall)
    f = np.nan_to_num(f)
    return f, float(f.mean())


def drop_zero_weight_classes(cm: np.ndarray, weights) -> np.ndarray:
    """Remove rows+cols of weight-0 classes (reference flair/metrics.py:76-84)."""
    unused = np.where(np.asarray(weights) == 0)[0]
    cm = np.delete(np.asarray(cm), unused, axis=0)
    return np.delete(cm, unused, axis=1)
