"""Zone metrics (counterpart of ``flairtpu/zone/zone_metrics.py``): the
compare sweep's per-patch records (reference src/zone_detect/test/
metrics.py:32-44, :124-192 and utils.py:282-297) and batch mode's
per-method aggregates (:61-84, :195-287), with the same JSON record shapes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Window
from flairtpu_torch.ops.confmat import (class_fscore, class_iou, class_precision,
                                        class_recall, drop_zero_weight_classes,
                                        overall_accuracy)
from flairtpu_torch.zone.naming import extract_method, info_extract


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


def collect_paths_truth(config: dict, truth_dir: Path) -> list[dict]:
    """pred/truth/method triples from the output folder and its timestamped
    folders (test/metrics.py:61-84). As in flairtpu, the rasters written at
    the folder's root form one group, matched to the truth of the first
    one's zone."""
    records = []
    pred_dir = Path(config["output_path"])
    groups = [sorted(p.rglob("*.tif")) for p in sorted(pred_dir.iterdir()) if p.is_dir()]
    root_tifs = sorted(pred_dir.glob("*.tif"))  # non-compare runs write here
    if root_tifs:
        groups.append(root_tifs)
    for pred_files in groups:
        if not pred_files:
            continue
        zone = info_extract(pred_files[0])["zone"]
        truth_path = next((truth_dir / zone).glob("*.tif"), None)
        if truth_path is None:
            raise FileNotFoundError(f"Ground truth file not found in {truth_dir / zone}.")
        for pred_path in pred_files:
            records.append({"pred_path": str(pred_path), "truth_path": str(truth_path),
                            "method": info_extract(pred_path)["method"]})
    return records


def batch_metrics(config: dict, truth_dir: Path) -> list[dict]:
    """Per-method summed-confmat metrics and timing (test/metrics.py:195-287)."""
    records = collect_paths_truth(config, truth_dir)
    classes = config["classes"]
    k = len(classes)
    weights = [classes[i][0] for i in sorted(classes)]

    by_method: dict[str, list[dict]] = {}
    for r in records:
        by_method.setdefault(r["method"], []).append(r)

    out = []
    print("Computing metrics...")
    for method, group in sorted(by_method.items()):
        cm = np.zeros((k, k), np.int64)
        for rec in group:
            try:
                with TiffReader(rec["pred_path"]) as src:
                    preds = src.read(1)
                with TiffReader(rec["truth_path"]) as src:
                    target = src.read(1).astype(np.int64) - 1
                cm += fast_confusion(target, preds, k)
            except Exception as e:
                print(f"Error processing {rec['pred_path']}: {e}")
        cleaned = drop_zero_weight_classes(cm, weights)
        per_iou, miou = class_iou(cleaned)
        oa = overall_accuracy(cleaned)
        per_p, _ = class_precision(cleaned)
        per_r, _ = class_recall(cleaned)
        per_f, mf = class_fscore(per_p, per_r)
        times = config.get("times", {}).get(method, [])
        info = extract_method(str(method))
        out.append({
            "Method parameters": ["model name", "patch size", "stride", "margin",
                                  "padding", "stitching method"],
            "Parameters values": [config.get("model_name", "model"),
                                  info.get("patch_size"), info.get("stride"),
                                  info.get("margin"), info.get("padding"),
                                  info.get("stitching")],
            "Avg_metrics_name": ["mIoU", "Overall Accuracy", "Fscore", "Time in ms"],
            "Avg_metrics": [miou, oa, mf, float(np.mean(times)) if len(times) else 0.0],
            "classes": [classes[i][1] for i in sorted(classes)],
            "per_class_iou": list(map(float, per_iou)),
            "per_class_fscore": list(map(float, per_f)),
        })
    return out
