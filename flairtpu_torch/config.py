"""YAML config loading and flair-detect validation
(counterpart of ``flairtpu/config.py:26-33, 259-375``).

Same YAML surface and the same checks as the reference package. What this
port does not run yet raises ``NotImplementedError`` naming the slice of the
port that brings it, instead of failing later or running something else.
"""

from __future__ import annotations

import os
from pathlib import Path

import yaml


class ConfigError(ValueError):
    """Raised when a config file fails validation."""


def read_config(path: str | os.PathLike) -> dict:
    """Load a YAML config file into a plain dict."""
    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ConfigError(f"Config file {path} did not parse to a mapping.")
    return cfg


def _require(cfg: dict, key: str, ctx: str = "config"):
    if key not in cfg:
        raise ConfigError(f"Missing required key '{key}' in {ctx}.")
    return cfg[key]


# encoders of the resnet family the port's models/resnet.py builds
RESNET_ENCODERS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")

_OUTPUT_TYPES = ("class_prob", "argmax")


def not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to flairtpu_torch yet ({where}).")


def check_smp(encoder_decoder: str) -> tuple[str, str]:
    """Split ``<encoder>_<arch>``; only the resnet U-Nets are ported."""
    if "_" not in encoder_decoder:
        raise ConfigError(
            f"encoder_decoder {encoder_decoder!r} is not of the form "
            "'<encoder>_<architecture>' (e.g. resnet34_unet)")
    encoder, arch = encoder_decoder.rsplit("_", 1)
    if arch != "unet":
        raise not_ported(f"smp architecture {arch!r}", "slice 5: other smp decoders")
    if encoder not in RESNET_ENCODERS:
        raise not_ported(f"smp encoder {encoder!r}", "slice 6: other smp encoders")
    return encoder, arch


def validate_model_framework(mf: dict) -> tuple[str, str]:
    provider = mf.get("model_provider")
    if provider == "HuggingFace":
        raise not_ported("the HuggingFace model provider", "slice 7")
    if provider != "SegmentationModelsPytorch":
        raise ConfigError(
            "model_provider should be either HuggingFace or "
            f"SegmentationModelsPytorch, got {provider!r}.")
    try:
        return check_smp(mf["SegmentationModelsPytorch"]["encoder_decoder"])
    except KeyError as e:
        raise ConfigError(f"model_framework is missing key {e}.") from None


def validate_detect_config(cfg: dict) -> dict:
    """Validate the `flair-detect` YAML (reference zone_detect/utils.py:26-94)."""
    cfg.setdefault("metrics", False)
    cfg.setdefault("batch_mode", False)
    cfg.setdefault("compare", False)
    cfg.setdefault("write_dataframe", False)
    # use_gpu true (the default) selects the CUDA card and raises without
    # one; false selects the CPU (reference src/zone_detect/main.py:239)
    cfg.setdefault("use_gpu", True)
    cfg.setdefault("num_worker", 2)
    cfg.setdefault("batch_size", 4)

    for knob, where in (("compare", "slice 2: compare sweep"),
                        ("batch_mode", "slice 2: batch mode"),
                        ("metrics", "slice 2: zone metrics"),
                        ("bn_fold", "slice 3: bn_fold"),
                        ("quantize", "slice 3: int8")):
        if cfg.get(knob):
            raise not_ported(f"flair-detect {knob}", where)

    Path(_require(cfg, "output_path")).mkdir(parents=True, exist_ok=True)
    in_path = _require(cfg, "input_img_path")
    if not os.path.exists(in_path):
        raise ConfigError(f"Input image path does not exist: {in_path}")

    channels = _require(cfg, "channels")
    if not (isinstance(channels, list) and all(isinstance(c, int) for c in channels)):
        raise ConfigError("Channels should be a list of integers.")

    size = _require(cfg, "img_pixels_detection")
    margin = _require(cfg, "margin")
    if not isinstance(size, int):
        raise ConfigError("img_pixels_detection should be an integer.")
    if not (isinstance(margin, int) and 2 * margin < size):
        raise ConfigError("margin should be an integer and less than half of img_pixels_detection.")

    output_type = _require(cfg, "output_type")
    if output_type not in _OUTPUT_TYPES:
        raise ConfigError("Invalid output type: should be argmax or class_prob.")
    if output_type == "class_prob":
        raise not_ported("output_type class_prob", "slice 2")
    if not isinstance(_require(cfg, "n_classes"), int):
        raise ConfigError("n_classes should be an integer.")

    norma = _require(cfg, "norma_task")
    if norma[0]["norm_type"] not in ("custom", "scaling"):
        raise ConfigError("Invalid normalization type: should be custom or scaling.")

    validate_model_framework(_require(cfg, "model_framework"))

    weights = _require(cfg, "model_weights")
    if not os.path.isfile(weights):
        raise ConfigError(f"Model weights file does not exist: {weights}")
    ext = os.path.splitext(str(weights))[1]
    if ext in (".msgpack", ".flax"):
        raise not_ported("native .msgpack/.flax weights", "a later slice; use .pth")
    if ext not in (".pth", ".pt", ".ckpt"):
        raise ConfigError(
            f"Model weights should be a .pth/.pt/.ckpt (torch) file. Got {ext!r}")
    return cfg
