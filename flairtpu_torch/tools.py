"""Utility CLI (counterpart of ``flairtpu/tools.py``).

- ``make-toy-dataset``: the reference ships csv_toy manifests of a
  downloadable toy dataset to smoke-test installations (reference
  README:148). With no download, this writes an equivalent local set:
  GeoTIFF patches and masks with a learnable pixel-class signal, CSV splits
  and a ready-to-run YAML, the same arrays and rows as ``flairtpu``'s from
  the same seed. The YAML's ``accelerator`` is ``gpu``, which names the CUDA
  card here (``train/loop.py:resolve_device``); set it to ``cpu`` to run on
  the CPU.
- ``make-toy-zone``: the ``flair-detect`` quickstart, a georeferenced zone
  and truth raster, random resnet34-unet weights as native ``.msgpack`` and
  the detect and compare YAMLs; the rasters and YAMLs are ``flairtpu``'s for
  the same seed, the weights the port's own initialization (JAX's random
  bits are not reproduced) in ``flairtpu``'s tree, which it loads strictly.
- ``convert-weights``: an smp ``.pth`` / ``.ckpt`` to native ``.msgpack``.
- ``error-maps`` and ``analyze-compare``: the compare sweep's error-rate
  heat maps and metric curves (matplotlib draws the PNGs; it is imported
  where it draws and raises its ``ImportError`` where it is missing).
- ``export-model`` (``jax.export`` of the serving forward) is not ported
  (slice 8).
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


def make_toy_zone(root: Path, zone: int = 2048, n_classes: int = 13,
                  n_channels: int = 5, seed: int = 2022) -> Path:
    """The ``flair-detect`` quickstart (``flairtpu/tools.py:99-191``): a
    georeferenced zone raster and its truth, random resnet34-unet weights
    as native ``.msgpack`` (``models/factory.py:init_weights`` seeded with
    ``seed``), and the detect and compare YAMLs."""
    from flairtpu_torch.models.factory import create_model, init_weights
    from flairtpu_torch.train.checkpoints import save_weights_msgpack

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    # zone image: blockwise class map with the same learnable channel-0 signal
    # as the toy patches, so a model trained on the toy dataset transfers
    blocks = max(zone // 64, 1)
    cls = rng.integers(0, n_classes, size=(blocks, blocks))
    msk = np.kron(cls, np.ones((zone // blocks, zone // blocks), np.int64))
    msk = msk[:zone, :zone]
    img = rng.integers(0, 40, size=(n_channels, zone, zone)).astype(np.uint8)
    img[0] = (msk * (200 // max(n_classes - 1, 1)) + 20).astype(np.uint8)
    tr = Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2)
    zone_path = root / "toy-zone.tif"
    truth_path = root / "toy-zone-truth.tif"
    write_array(zone_path, img, transform=tr, crs=2154, blockxsize=512, blockysize=512)
    # truth classes are 1-based on disk; zone metrics read truth - 1
    # (reference zone_detect/utils.py:282-297)
    write_array(truth_path, (msk + 1).astype(np.uint8), transform=tr, crs=2154)

    config = {
        "model_framework": {
            "model_provider": "SegmentationModelsPytorch",
            "SegmentationModelsPytorch": {"encoder_decoder": "resnet34_unet"},
        },
        "channels": list(range(1, n_channels + 1)),
        "n_classes": n_classes,
    }
    model = create_model(config)
    init_weights(model, seed)
    weights_path = root / "toy-weights.msgpack"
    save_weights_msgpack(weights_path, model)

    detect = {
        "output_path": str(root / "out"),
        "output_name": "toy-zone-ARGMAX-S",
        "input_img_path": str(zone_path),
        "channels": list(range(1, n_channels + 1)),
        "img_pixels_detection": 512,
        "margin": 128,
        "output_type": "argmax",
        "n_classes": n_classes,
        "model_weights": str(weights_path),
        "model_framework": config["model_framework"],
        "batch_size": 8,
        "use_gpu": True,
        "num_worker": 4,
        "write_dataframe": False,
        "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
    }
    conf_path = root / "toy-config-detect.yaml"
    with open(conf_path, "w") as f:
        yaml.safe_dump(detect, f)

    compare = dict(
        detect,
        output_path=str(root / "out-compare"),
        truth_path=str(truth_path),
        metrics_out=str(root / "out-compare" / "metrics.json"),
        overlap_strat=True,
        strategies={
            "tiling": {"enabled": True, "size_range": [512], "stride_range": [0.75]},
            "stitching": {"enabled": True, "methods": ["average", "exact-clipping"],
                          "margin": [0.25]},
            "padding_overall": None,
        },
        classes={i + 1: [1, f"class_{i}"] for i in range(n_classes)},
    )
    compare_path = root / "toy-config-detect-compare.yaml"
    with open(compare_path, "w") as f:
        yaml.safe_dump(compare, f)

    print(f"toy zone written under {root}")
    print(f"run: python -m flairtpu_torch.cli flair-detect --conf={conf_path}")
    print(f"     python -m flairtpu_torch.cli flair-detect --conf={compare_path} -c -m")
    return conf_path


# key prefixes of the HuggingFace checkpoints flairtpu converts
# (flairtpu/models/convert.py:911-956)
_HF_PREFIXES = ("backbone.", "dpt.", "mobilenet_v2.", "mobilevitv2.", "mobilevit.", "beit.",
                "data2vec_vision.", "segformer.", "decode_head.")


def checkpoint_arch(sd: dict) -> str:
    """The smp architecture whose keys ``sd`` holds, over an encoder the port
    builds; ``not_ported`` for the HuggingFace families (slice 7) and the
    other smp encoders (slice 6)."""
    from flairtpu_torch.config import SMP_ARCHS, not_ported
    from flairtpu_torch.models.convert import _flax_module

    if any(k.startswith(_HF_PREFIXES) for k in sd):
        raise not_ported("converting a HuggingFace checkpoint", "slice 7: the HF provider")

    def maps(arch: str, key: str) -> bool:
        try:
            _flax_module(key.rsplit(".", 1)[0], arch)
            return True
        except KeyError:
            return False

    keys = [k for k in sd if not k.endswith("num_batches_tracked")
            and not k.startswith(("criterion.", "optimizer."))]
    if not all(maps("unet", k) for k in keys if k.startswith("encoder.")):
        raise not_ported("converting a checkpoint of this smp encoder",
                         "slice 6: other smp encoders")
    for arch in SMP_ARCHS:
        if all(maps(arch, k) for k in keys):
            return arch
    raise ValueError("convert-weights: the checkpoint's keys are not those of an smp model "
                     f"the port builds ({', '.join(SMP_ARCHS)})")


def convert_weights(src: Path, dst: Path, conf: Path | None) -> None:
    """An smp ``.pth`` / ``.ckpt`` -> native ``.msgpack`` weights in
    ``flairtpu``'s tree (``flairtpu/tools.py:194-215``); with ``conf``, held
    strictly against the model that config describes first."""
    from flairtpu_torch.models.convert import (load_torch_state_dict, load_weights,
                                               normalize_keys, write_native)

    if conf is not None:
        from flairtpu_torch import config as cfgmod
        from flairtpu_torch.models.factory import create_model

        model = create_model(cfgmod.read_config(conf))
        load_weights(model, src)
        print("    [x] checkpoint matches the configured model (strict)")
        sd, arch = model.state_dict(), model.arch
    else:
        sd = {k: v for k, v in normalize_keys(load_torch_state_dict(src)).items()
              if not k.startswith(("criterion.", "optimizer."))}
        arch = checkpoint_arch(sd)
    write_native(dst, sd, arch)
    print(f"    [x] wrote {dst}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m flairtpu_torch.tools")
    sub = parser.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("error-maps", help="per-method error-rate heat maps from predictions")
    e.add_argument("--truth-dir", required=True)
    e.add_argument("--pred-dir", required=True)
    e.add_argument("--out-dir", required=True)
    e.add_argument("--sigma", type=float, default=2.0)
    a = sub.add_parser("analyze-compare",
                       help="aggregate + plot compare-sweep metrics by parameter")
    a.add_argument("metrics_json")
    a.add_argument("--param", default="size")
    a.add_argument("--metric", default="mIoU")
    a.add_argument("--out-png", default=None)
    x = sub.add_parser("export-model", help="not ported (slice 8)")
    x.add_argument("--conf", required=True)
    x.add_argument("--out", required=True)
    z = sub.add_parser("make-toy-zone",
                       help="generate a synthetic flair-detect quickstart "
                            "(zone raster + truth + weights + configs)")
    z.add_argument("--root", default="toy_zone")
    z.add_argument("--zone", type=int, default=2048)
    z.add_argument("--classes", type=int, default=13)
    z.add_argument("--channels", type=int, default=5)
    z.add_argument("--seed", type=int, default=2022)
    c = sub.add_parser("convert-weights", help="convert a torch .pth/.ckpt to native .msgpack")
    c.add_argument("src")
    c.add_argument("dst")
    c.add_argument("--conf", default=None,
                   help="YAML config to strict-validate the checkpoint against")
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
    if args.cmd == "export-model":
        from flairtpu_torch.config import not_ported

        raise not_ported("tools export-model (a jax.export serving artifact)",
                         "slice 8: multi-device and serving")
    if args.cmd == "make-toy-dataset":
        make_toy_dataset(Path(args.root), args.train, args.val, args.test,
                         args.size, args.classes, args.channels, args.seed)
    elif args.cmd == "make-toy-zone":
        make_toy_zone(Path(args.root), args.zone, args.classes, args.channels, args.seed)
    elif args.cmd == "convert-weights":
        convert_weights(Path(args.src), Path(args.dst), Path(args.conf) if args.conf else None)
    elif args.cmd == "error-maps":
        from flairtpu_torch.zone.error_maps import error_rate_loop

        out = error_rate_loop(Path(args.truth_dir), Path(args.out_dir), Path(args.pred_dir),
                              sigma=args.sigma)
        for method, png in out.items():
            print(f"    [x] {method}: {png}")
    elif args.cmd == "analyze-compare":
        from flairtpu_torch.zone.analysis import (analyze_param, flatten_metrics,
                                                  load_metrics_json, plot_metrics)

        rows = flatten_metrics(load_metrics_json(args.metrics_json))
        points = analyze_param(rows, args.param, args.metric)
        for value, mean in points:
            print(f"    {args.param}={value:g}: {args.metric}={mean:.4f}")
        if points:
            plot_metrics(points, args.param, args.metric, out_png=args.out_png)


if __name__ == "__main__":
    main()
