"""CSV split manifests (own copy of ``flairtpu/data/manifest.py``; reference
src/flair/tasks_utils.py:127-155).

Header-less two-column CSVs: ``img_path,msk_path``. Returns the reference's
``{'IMG': [...], 'MSK': [...], 'MTD': [...]}`` dict; with ``use_metadata``
set, ``MTD`` holds each image's 45-d vector from
``paths.path_metadata_aerial`` (``data/metadata.py``), else it is empty.
"""

from __future__ import annotations

import csv
import os

from flairtpu_torch.data.metadata import encode_metadata_for_paths


class ManifestError(SystemExit):
    """Invalid CSV path — the reference's SystemExit behaviour."""


def read_split_csv(path: str | None, split: str) -> tuple[list[str], list[str]]:
    if not (path and os.path.isfile(path) and str(path).endswith(".csv")):
        raise ManifestError(f"Invalid .csv {split} file path: {path!r}")
    images, labels = [], []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            images.append(row[0].strip())
            labels.append(row[1].strip() if len(row) > 1 else "")
    return images, labels


def gather_paths(config: dict, split: str = "train") -> dict:
    key = {"train": "train_csv", "val": "val_csv", "test": "test_csv"}[split]
    images, labels = read_split_csv(config["paths"].get(key), split)
    if config.get("use_metadata"):
        metadata = encode_metadata_for_paths(images, config["paths"]["path_metadata_aerial"])
    else:
        metadata = []
    return {"IMG": images, "MSK": labels, "MTD": metadata}
