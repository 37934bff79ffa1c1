"""Utility CLI: a synthetic toy dataset (counterpart of
``flairtpu/tools.py:22-97, 233-240``).

The reference ships csv_toy manifests of a downloadable toy dataset to
smoke-test installations (reference README:148). With no download,
``python -m flairtpu_torch.tools make-toy-dataset`` writes an equivalent
local set: GeoTIFF patches and masks with a learnable pixel-class signal,
CSV splits and a ready-to-run YAML, the same arrays and rows as
``flairtpu``'s from the same seed. The YAML's ``accelerator`` is ``gpu``,
which names the CUDA card here (``train/loop.py:resolve_device``); set it to
``cpu`` to run on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import yaml

from flairtpu_torch.io.tiff import Affine, write_array


def make_patch(rng, size: int, n_classes: int, n_channels: int):
    blocks = max(size // 8, 1)
    cls = rng.integers(0, n_classes, size=(blocks, blocks))
    msk = np.kron(cls, np.ones((size // blocks, size // blocks), np.int64))[:size, :size]
    img = rng.integers(0, 40, size=(n_channels, size, size)).astype(np.uint8)
    img[0] = (msk * (200 // max(n_classes - 1, 1)) + 20).astype(np.uint8)
    return img, (msk + 1).astype(np.uint8)


def make_toy_dataset(root: Path, n_train: int = 32, n_val: int = 8, n_test: int = 8,
                     size: int = 512, n_classes: int = 13, n_channels: int = 5,
                     seed: int = 2022) -> Path:
    root = Path(root)
    rng = np.random.default_rng(seed)
    splits = {"train": n_train, "val": n_val, "test": n_test}
    csvs = {}
    counter = 0
    for split, n in splits.items():
        img_dir = root / split / "img"
        msk_dir = root / split / "msk"
        img_dir.mkdir(parents=True, exist_ok=True)
        msk_dir.mkdir(parents=True, exist_ok=True)
        rows = []
        for _ in range(n):
            img, msk = make_patch(rng, size, n_classes, n_channels)
            tr = Affine.from_origin(700000.0 + counter * size * 0.2, 6600000.0, 0.2, 0.2)
            ip = img_dir / f"IMG_{counter:06d}.tif"
            mp = msk_dir / f"MSK_{counter:06d}.tif"
            write_array(ip, img, transform=tr, crs=2154)
            write_array(mp, msk, transform=tr, crs=2154)
            rows.append(f"{ip},{mp}")
            counter += 1
        csv_path = root / f"flair-1-paths-toy-{split}.csv"
        csv_path.write_text("\n".join(rows) + "\n")
        csvs[split] = csv_path

    config = {
        "paths": {
            "out_folder": str(root / "out"),
            "out_model_name": "toy-model",
            "train_csv": str(csvs["train"]),
            "val_csv": str(csvs["val"]),
            "test_csv": str(csvs["test"]),
            "ckpt_model_path": "",
            "path_metadata_aerial": "",
        },
        "tasks": {"train": True,
                  "train_tasks": {"init_weights_only_from_ckpt": False,
                                  "resume_training_from_ckpt": False},
                  "predict": True, "metrics": True, "delete_preds": False},
        "model_framework": {
            "model_provider": "SegmentationModelsPytorch",
            "SegmentationModelsPytorch": {"encoder_decoder": "resnet34_unet"},
        },
        "use_augmentation": True, "use_metadata": False,
        "channels": list(range(1, n_channels + 1)),
        "norm_type": "scaling", "norm_means": [], "norm_stds": [],
        "seed": seed, "batch_size": 4, "learning_rate": 0.02, "num_epochs": 3,
        "use_weights": True,
        "classes": {i + 1: [1, f"class_{i}"] for i in range(n_classes)},
        "georeferencing_output": True,
        "accelerator": "gpu", "num_nodes": 1, "gpus_per_node": 1,
        "strategy": "auto", "num_workers": 4,
        "ckpt_save_also_last": True, "ckpt_verbose": False,
        "ckpt_weights_only": False, "ckpt_monitor": "val_loss",
        "ckpt_monitor_mode": "min", "ckpt_earlystopping_patience": 30,
        "cp_csv_and_conf_to_output": True, "enable_progress_bar": True,
    }
    conf_path = root / "toy-config.yaml"
    with open(conf_path, "w") as f:
        yaml.safe_dump(config, f)
    print(f"toy dataset written under {root}")
    print(f"run: python -m flairtpu_torch.cli flair --conf={conf_path}")
    return conf_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="flairtpu_torch.tools")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("make-toy-dataset",
                       help="generate a synthetic FLAIR-style toy dataset")
    p.add_argument("--root", default="toy_dataset")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--classes", type=int, default=13)
    p.add_argument("--channels", type=int, default=5)
    p.add_argument("--train", type=int, default=32)
    p.add_argument("--val", type=int, default=8)
    p.add_argument("--test", type=int, default=8)
    p.add_argument("--seed", type=int, default=2022)
    args = parser.parse_args(argv)
    make_toy_dataset(Path(args.root), args.train, args.val, args.test,
                     args.size, args.classes, args.channels, args.seed)


if __name__ == "__main__":
    main()
