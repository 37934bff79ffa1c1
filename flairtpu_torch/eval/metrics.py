"""Patch metrics stage (counterpart of ``flairtpu/eval/metrics.py:32-117``;
reference src/flair/metrics.py:44-164).

Reads PRED_*.tif against the test CSV's truth masks, sums per-patch
confusion matrices, removes the weight-0 classes, and writes
``metrics/confmat.npy`` and ``metrics/metrics.json`` with the reference's
schema, and the console tables.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

from flairtpu_torch import config as cfgmod
from flairtpu_torch.data.manifest import read_split_csv
from flairtpu_torch.io import TiffReader
from flairtpu_torch.ops.confmat import (class_fscore, class_iou, class_precision,
                                        class_recall, drop_zero_weight_classes,
                                        overall_accuracy)


def patch_confusion(target: np.ndarray, pred: np.ndarray, k: int) -> np.ndarray:
    t, p = target.reshape(-1).astype(np.int64), pred.reshape(-1).astype(np.int64)
    valid = (t >= 0) & (t < k) & (p >= 0) & (p < k)
    return np.bincount(t[valid] * k + p[valid], minlength=k * k).reshape(k, k)


def metrics(config: dict, path_preds: str | Path, remove_preds: bool = False) -> dict:
    path_preds = Path(path_preds)
    images, msks = read_split_csv(config["paths"]["test_csv"], "test")
    preds = [path_preds / f"PRED_{img.split('/')[-1]}" for img in images]
    on_disk = len(list(path_preds.glob("PRED_*.tif")))
    if len(msks) != on_disk:
        raise RuntimeError(
            f"[WARNING !] mismatch number of predictions and test files: "
            f"{on_disk} PRED_*.tif on disk vs {len(msks)} truth masks.")

    print("-- Calculating metrics --")
    k = cfgmod.num_classes(config)
    total = np.zeros((k, k), np.int64)
    for u, (truth_path, pred_path) in enumerate(zip(msks, preds)):
        try:
            with TiffReader(truth_path) as r:
                target = r.read(1).astype(np.int64) - 1  # classes start at 1 on disk
            with TiffReader(pred_path) as r:
                pred = r.read(1).astype(np.int64)
            total += patch_confusion(target, pred, k)
        except Exception as e:  # skip-and-log like the reference (:61-74)
            print(f"Error at index {u}: {e}")

    weights = np.asarray(cfgmod.class_weights(config))
    names = cfgmod.class_names(config)
    cleaned = drop_zero_weight_classes(total, weights)
    per_iou, miou = class_iou(cleaned)
    oa = overall_accuracy(cleaned)
    per_p, mp = class_precision(cleaned)
    per_r, mr = class_recall(cleaned)
    per_f, mf = class_fscore(per_p, per_r)

    used_names = [n for n, w in zip(names, weights) if w != 0]
    result = {
        "Avg_metrics_name": ["mIoU", "Overall Accuracy", "Fscore", "Precision", "Recall"],
        "Avg_metrics": [miou, oa, mf, mp, mr],
        "classes": used_names,
        "per_class_iou": list(map(float, per_iou)),
        "per_class_fscore": list(map(float, per_f)),
        "per_class_precision": list(map(float, per_p)),
        "per_class_recall": list(map(float, per_r)),
    }

    out_folder = path_preds.parent / "metrics"
    out_folder.mkdir(exist_ok=True, parents=True)
    np.save(out_folder / "confmat.npy", total)
    with open(out_folder / "metrics.json", "w") as f:
        json.dump(result, f)

    print("\nGlobal Metrics: ")
    print("-" * 90)
    for name, value in zip(result["Avg_metrics_name"], result["Avg_metrics"]):
        print(f"{name:<20s} {value:<20.4f}")
    print("-" * 90 + "\n\n")
    print("{:<25} {:<15} {:<10} {:<10} {:<10} {:<10}".format(
        "Class", "Weight", "IoU", "F-score", "Precision", "Recall"))
    print("-" * 65)
    for name, w in zip(names, weights):
        if w != 0:
            i = used_names.index(name)
            print("{:<25} {:<15} {:<10.4f} {:<10.4f} {:<10.4f} {:<10.4f}".format(
                name, w, per_iou[i], per_f[i], per_p[i], per_r[i]))
    print("\nNot learned Classes:")
    print("{:<25} {:<15}".format("Class", "Weight"))
    print("-" * 65)
    for name, w in zip(names, weights):
        if w == 0:
            print("{:<25} {:<15}".format(name, w))
    print("\n")

    if remove_preds:
        shutil.rmtree(path_preds)
    return result
