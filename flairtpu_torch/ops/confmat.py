"""Confusion matrix and the IoU-family metrics of one (counterpart of
``flairtpu/ops/confmat.py``; reference flair/metrics.py:14-84 and the
torchmetrics Jaccard of task_module.py:31-59).

Rows are targets, columns predictions (sklearn's convention). The per-class
metrics of the metrics stage are numpy float64; ``weighted_jaccard`` and
``per_class_jaccard`` (the train loop's epoch mIoU) are float32, as
``flairtpu`` computes them. The train and eval steps count their matrix in
the weighted cross-entropy's pass (``ops/weighted_ce.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(preds: torch.Tensor, targets: torch.Tensor, num_classes: int,
                     dtype=torch.int32) -> torch.Tensor:
    """(K, K) counts, rows = target, cols = pred; values outside [0, K) of
    either are ignored (``flairtpu/ops/confmat.py:19-41``)."""
    t, p, k = targets.reshape(-1).long(), preds.reshape(-1).long(), num_classes
    valid = (t >= 0) & (t < k) & (p >= 0) & (p < k)
    return torch.bincount(t[valid] * k + p[valid], minlength=k * k).reshape(k, k).to(dtype)


def weighted_jaccard(cm) -> float:
    """torchmetrics MulticlassJaccardIndex(average='weighted') of a confusion
    matrix, in float32: per-class IoU weighted by the targets' share; a class
    with no union counts 0 (``flairtpu/ops/confmat.py:91-104``)."""
    cm = torch.as_tensor(np.asarray(cm)).float()
    inter = torch.diagonal(cm)
    union = cm.sum(dim=1) + cm.sum(dim=0) - inter
    iou = torch.where(union > 0, inter / torch.clamp_min(union, 1), torch.zeros_like(union))
    support = cm.sum(dim=1)
    total = torch.clamp_min(support.sum(), 1)
    return float((iou * support / total).sum())


def per_class_jaccard(cm) -> np.ndarray:
    """torchmetrics MulticlassJaccardIndex(average=None), float32
    (``flairtpu/ops/confmat.py:107-111``)."""
    cm = torch.as_tensor(np.asarray(cm)).float()
    inter = torch.diagonal(cm)
    union = cm.sum(dim=1) + cm.sum(dim=0) - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1),
                       torch.zeros_like(union)).numpy()


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
