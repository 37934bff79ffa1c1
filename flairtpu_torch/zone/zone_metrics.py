"""Per-patch zone metrics of the compare sweep (counterpart of
``flairtpu/zone/zone_metrics.py:29-82``; reference
src/zone_detect/test/metrics.py:32-44, :124-192 and utils.py:282-297), with
the same JSON record shape. Batch-mode metrics are not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Window
from flairtpu_torch.ops.confmat import (class_fscore, class_iou, class_precision,
                                        class_recall, drop_zero_weight_classes,
                                        overall_accuracy)


def fast_confusion(target: np.ndarray, pred: np.ndarray, k: int) -> np.ndarray:
    t, p = target.reshape(-1).astype(np.int64), pred.reshape(-1).astype(np.int64)
    valid = (t >= 0) & (t < k) & (p >= 0) & (p < k)
    return np.bincount(t[valid] * k + p[valid], minlength=k * k).reshape(k, k)


def valid_truth(config: dict) -> Path:
    """dpt/zone coherence between input and truth paths (test/metrics.py:32-44)."""
    truth_path = Path(config["truth_path"])
    sanity = str(config["input_img_path"]).split("/")[-3:-1]
    if list(truth_path.parts[-3:-1]) != sanity:
        raise ValueError(
            f"Ground truth path {truth_path} does not match input path "
            f"{config['input_img_path']}")
    return truth_path


def open_images(config: dict, local_out: Path, get_truth: bool):
    """Truth raster (0-based) + metrics json path (reference utils.py:282-297)."""
    if get_truth:
        with TiffReader(config["truth_path"]) as src:
            truth = src.read(1).astype(np.int64) - 1
        dpt, zone = Path(config["input_img_path"]).parts[-3:-1]
        return truth, local_out / f"metrics_per-patch_{dpt}_{zone}.json"
    return np.zeros((1, 1), np.uint8), Path()


def compute_metrics_patch(pred_patch: np.ndarray, truth: np.ndarray,
                          window: Window, config: dict, method: str) -> dict:
    valid_truth(config)
    c0, r0, w, h = window.rounded()
    target = truth[r0:r0 + h, c0:c0 + w]
    if target.shape != pred_patch.shape:
        pred_patch = pred_patch[0]

    classes = config["classes"]
    k = len(classes)
    cm = fast_confusion(target, pred_patch, k)
    cleaned = drop_zero_weight_classes(cm, [classes[i][0] for i in sorted(classes)])
    per_iou, miou = class_iou(cleaned)
    oa = overall_accuracy(cleaned)
    per_p, _ = class_precision(cleaned)
    per_r, _ = class_recall(cleaned)
    per_f, mf = class_fscore(per_p, per_r)

    key = f"{method}_{c0}_{r0}"
    return {key: {
        "Avg_metrics_name": ["mIoU", "Overall Accuracy", "Fscore"],
        "Avg_metrics": [miou, oa, mf],
        "classes": [classes[i][1] for i in sorted(classes)],
        "per_class_iou": list(map(float, per_iou)),
        "per_class_fscore": list(map(float, per_f)),
    }}
