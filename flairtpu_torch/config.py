"""YAML config loading, flair and flair-detect validation and the compare
sweep's combinations (counterpart of ``flairtpu/config.py:26-257, 259-424``).

Same YAML surface and the same checks as the reference package. What this
port does not run yet raises ``NotImplementedError`` naming the slice of the
port that brings it, instead of failing later or running something else.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

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


def _coerce_list(value: Any, expected_type: type) -> list:
    """Coerce scalars to single-element lists; filter/validate element types.

    Mirrors ``check_list_type`` semantics (reference zone_detect/utils.py:97-107).
    """
    if isinstance(value, expected_type):
        value = [value]
    elif value is None:
        value = []
    elif hasattr(value, "__iter__"):
        value = [expected_type(v) if isinstance(v, (int, float)) else v for v in value]
    for v in value:
        if not isinstance(v, expected_type):
            raise ConfigError(f"List element {v!r} is not of type {expected_type.__name__}.")
    return value


# encoders of the resnet family the port's models/resnet.py builds: the
# resnets and the resnexts (flairtpu/models/resnet.py:23-37)
RESNET_ENCODERS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
                   "resnext50_32x4d", "resnext101_32x4d", "resnext101_32x8d",
                   "resnext101_32x16d", "resnext101_32x32d", "resnext101_32x48d")

# the efficientnet-b0..b7 encoders (models/efficientnet.py; flairtpu/models/
# registry.py:30); no arch refuses them (flairtpu/models/registry.py:78-82)
EFFICIENTNET_ENCODERS = tuple(f"efficientnet-b{i}" for i in range(8))

# torchvision's MobileNetV2 at width 1.0, smp's one entry (models/mobilenet.py;
# flairtpu/models/registry.py:31); no arch refuses it either
MOBILENET_ENCODERS = ("mobilenet_v2",)

# Apple's MobileOne s0..s4 in smp's unfused training form (models/mobileone.py;
# flairtpu/models/registry.py:32); no arch refuses them either
MOBILEONE_ENCODERS = tuple(f"mobileone_s{i}" for i in range(5))

# every encoder the port builds
PORTED_ENCODERS = (RESNET_ENCODERS + EFFICIENTNET_ENCODERS + MOBILENET_ENCODERS
                   + MOBILEONE_ENCODERS)

_OUTPUT_TYPES = ("class_prob", "argmax")
_STITCH_METHODS = ("exact-clipping", "average", "average_weights", "max")


def not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to flairtpu_torch yet ({where}).")


# the nine smp architectures the port builds over them, as
# flairtpu/models/registry.py lists them
SMP_ARCHS = ("unet", "unetplusplus", "manet", "linknet", "fpn", "pspnet", "deeplabv3",
             "deeplabv3plus", "pan")


def check_smp(encoder_decoder: str) -> tuple[str, str]:
    """Split ``<encoder>_<arch>``; the resnet, resnext, efficientnet,
    mobilenet_v2 and mobileone encoders under ``SMP_ARCHS`` are ported. An
    arch smp does not have raises as ``flairtpu/models/registry.py:98-100``
    does, with the supported list."""
    if "_" not in encoder_decoder:
        raise ConfigError(
            f"encoder_decoder {encoder_decoder!r} is not of the form "
            "'<encoder>_<architecture>' (e.g. resnet34_unet)")
    encoder, arch = encoder_decoder.rsplit("_", 1)
    if arch not in SMP_ARCHS:
        raise NotImplementedError(
            f"architecture {arch!r} not ported (supported: {', '.join(SMP_ARCHS)})")
    if encoder not in PORTED_ENCODERS:
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


def validate_knobs(cfg: dict, arch: str) -> None:
    """``quantize``, ``int8_decoder`` and ``bn_fold`` as
    ``flairtpu/config.py:306-318`` checks them. ``int8_decoder: 5`` puts
    the U-Net's decoder block 4 in int8, which the fused tail does not run;
    the other archs fold and quantize their encoder only, as ``flairtpu``
    does, and ignore ``int8_decoder``. ``s2d_stem`` (read as ``bool(...)``, as
    ``flairtpu/models/factory.py:325`` does) computes the resnet stem on a
    space-to-depth repack in the float models of ``flair`` and
    ``flair-detect``; the folded and int8 walks compute their stem as the
    7 x 7 conv whatever it says, as ``flairtpu``'s walk (``flairtpu/models/
    quantize.py:107``) does, which does not go through ``StemConv``."""
    quant = cfg.get("quantize")
    if quant not in (None, False, "int8"):
        raise ConfigError("quantize: 'int8' is the only supported value (or omit the key).")
    dec_blocks = cfg.get("int8_decoder", True)
    if not (isinstance(dec_blocks, bool)
            or (isinstance(dec_blocks, int) and 0 <= dec_blocks <= 5)):
        raise ConfigError(f"int8_decoder: expected a bool or a block count 0..5 "
                          f"(got {dec_blocks!r}).")
    fold = cfg.get("bn_fold", False)
    if not isinstance(fold, bool):
        raise ConfigError(f"bn_fold: expected a bool (got {fold!r}).")
    if quant and arch == "unet" and dec_blocks is not True and dec_blocks == 5:
        raise not_ported("int8_decoder: 5 (decoder block 4 in int8)",
                         "slice 3 item 10b: a head-only fused_tail mode")


# ---------------------------------------------------------------------------
# classes / weights helpers (shared by the train and metrics paths)
# ---------------------------------------------------------------------------

def class_weights(cfg: dict) -> list[float]:
    """Per-class weights in class-id order (reference tasks_utils.py:88-93)."""
    classes = _require(cfg, "classes")
    return [float(classes[k][0]) for k in classes]


def class_names(cfg: dict) -> list[str]:
    classes = _require(cfg, "classes")
    return [str(classes[k][1]) for k in classes]


def num_classes(cfg: dict) -> int:
    return len(_require(cfg, "classes"))


# ---------------------------------------------------------------------------
# flair (patch train / predict / metrics) config
# ---------------------------------------------------------------------------

_NORM_TYPES = ("scaling", "custom", "without")


def _not_ported_train_knobs(cfg: dict) -> None:
    """The train knobs of ``flairtpu`` this port does not run yet raise here,
    naming where they come."""
    if cfg["param_sharding"] != "replicated":
        raise not_ported(f"param_sharding: {cfg['param_sharding']}", "slice 8: multi-device")
    for key in ("tensor_parallel", "spatial_parallel"):
        if cfg[key] > 1:
            raise not_ported(f"{key}: {cfg[key]}", "slice 8: multi-device")
    if cfg["remat_policy"] is not None or cfg["remat"]:
        raise not_ported("remat / remat_policy (rematerialization)", "a later slice")
    if cfg["bn_dtype"] == "bfloat16":
        raise not_ported("bn_dtype: bfloat16 (the BatchNorm kernels reduce in float32)",
                         "a later slice")
    if cfg["init_hf_pretrained"]:
        raise not_ported("init_hf_pretrained", "slice 7: the HF provider")
    if cfg.get("auxiliary_loss_weight"):
        raise not_ported("auxiliary_loss_weight (UperNet auxiliary heads)",
                         "slice 7: the HF provider")
    if cfg.get("loader_backend", "threads") != "threads":
        raise not_ported(f"loader_backend: {cfg['loader_backend']} (grain is not "
                         "installed beside the card)", "a later slice")


def validate_train_config(cfg: dict) -> dict:
    """Validate the ``flair --conf`` YAML (schema: reference
    configs/flair-1-config.yaml) with ``flairtpu/config.py:100-257``'s checks
    and defaults; the knobs the port lacks raise ``NotImplementedError``."""
    paths = _require(cfg, "paths")
    tasks = _require(cfg, "tasks")
    mf = _require(cfg, "model_framework")
    provider = _require(mf, "model_provider", "model_framework")
    if provider not in ("SegmentationModelsPytorch", "HuggingFace"):
        raise ConfigError(
            "model_provider should be either HuggingFace or SegmentationModelsPytorch, "
            f"got {provider!r}.")
    channels = _require(cfg, "channels")
    if not (isinstance(channels, list) and all(isinstance(c, int) for c in channels)):
        raise ConfigError("channels should be a list of 1-based integers.")
    encoder, _ = validate_model_framework(mf)

    norm_type = cfg.get("norm_type", "scaling")
    if norm_type not in _NORM_TYPES:
        raise ConfigError(f"norm_type should be one of {_NORM_TYPES}, got {norm_type!r}.")
    if norm_type == "custom":
        means, stds = cfg.get("norm_means", []), cfg.get("norm_stds", [])
        if len(means) != len(stds):
            raise ConfigError("custom normalization means and stds must be the same length.")
        if len(means) != len(channels):
            raise ConfigError("custom normalization means/stds must match len(channels).")

    classes = _require(cfg, "classes")
    for k, v in classes.items():
        if not (isinstance(v, (list, tuple)) and len(v) == 2):
            raise ConfigError(f"classes[{k}] must be [weight, name], got {v!r}.")

    cfg.setdefault("use_metadata", False)
    cfg.setdefault("use_augmentation", False)
    cfg.setdefault("use_weights", True)
    cfg.setdefault("accumulate_steps", 1)
    cfg.setdefault("remat", False)
    cfg.setdefault("remat_policy", None)
    if not (isinstance(cfg["accumulate_steps"], int) and cfg["accumulate_steps"] >= 1):
        raise ConfigError("accumulate_steps must be an integer >= 1.")
    cfg.setdefault("bn_dtype", "float32")
    if cfg["bn_dtype"] not in ("float32", "bfloat16"):
        raise ConfigError(f"bn_dtype must be float32 or bfloat16, got {cfg['bn_dtype']!r}.")
    cfg.setdefault("param_sharding", "replicated")
    if cfg["param_sharding"] not in ("replicated", "fsdp", "tensor"):
        raise ConfigError("param_sharding must be one of replicated/fsdp/tensor, "
                          f"got {cfg['param_sharding']!r}.")
    for key in ("tensor_parallel", "spatial_parallel"):
        cfg.setdefault(key, 1)
        if not (isinstance(cfg[key], int) and cfg[key] >= 1):
            raise ConfigError(f"{key} must be an integer >= 1.")
    if cfg.get("batch_size") and cfg["accumulate_steps"] > 1 \
            and int(cfg["batch_size"]) % cfg["accumulate_steps"]:
        raise ConfigError(f"batch_size {cfg['batch_size']} is not divisible by "
                          f"accumulate_steps {cfg['accumulate_steps']}.")
    cfg.setdefault("autosave_every_steps", 0)
    if not (isinstance(cfg["autosave_every_steps"], int) and cfg["autosave_every_steps"] >= 0):
        raise ConfigError("autosave_every_steps must be an integer >= 0.")
    cfg.setdefault("autosave_resume", True)
    # pretrained-encoder init from a bare ImageNet classifier state dict
    # (the explicit analog of smp's encoder_weights='imagenet' default;
    # models/pretrained.py)
    cfg.setdefault("init_encoder_weights", "")
    if cfg["init_encoder_weights"]:
        if cfg["model_framework"]["model_provider"] != "SegmentationModelsPytorch":
            raise ConfigError(
                "init_encoder_weights applies to the SegmentationModelsPytorch "
                "provider only (HuggingFace models: use init_hf_pretrained "
                "with a local transformers checkpoint).")
        if not Path(str(cfg["init_encoder_weights"])).exists():
            raise ConfigError(
                f"init_encoder_weights file not found: {cfg['init_encoder_weights']!r}")
    cfg.setdefault("init_hf_pretrained", "")
    cfg.setdefault("seed", 2022)
    cfg.setdefault("georeferencing_output", True)
    # any value but cpu selects the CUDA card (flairtpu's 'tpu' included) and
    # raises without one; cpu is the only route to the CPU
    cfg.setdefault("accelerator", "tpu")
    cfg.setdefault("num_nodes", 1)
    cfg.setdefault("strategy", "auto")
    cfg.setdefault("num_workers", 4)
    cfg.setdefault("ckpt_save_also_last", True)
    cfg.setdefault("ckpt_weights_only", False)
    cfg.setdefault("ckpt_monitor", "val_loss")
    cfg.setdefault("ckpt_monitor_mode", "min")
    cfg.setdefault("ckpt_earlystopping_patience", 30)
    cfg.setdefault("cp_csv_and_conf_to_output", True)
    cfg.setdefault("enable_progress_bar", True)
    if cfg["ckpt_monitor_mode"] not in ("min", "max"):
        raise ConfigError("ckpt_monitor_mode must be 'min' or 'max'.")
    _not_ported_train_knobs(cfg)

    train_tasks = tasks.get("train_tasks", {}) or {}
    tasks.setdefault("train", False)
    tasks.setdefault("predict", False)
    tasks.setdefault("metrics", False)
    tasks.setdefault("delete_preds", False)
    train_tasks.setdefault("init_weights_only_from_ckpt", False)
    train_tasks.setdefault("resume_training_from_ckpt", False)
    tasks["train_tasks"] = train_tasks

    paths.setdefault("out_folder", "")
    paths.setdefault("out_model_name", "flair-model")
    if tasks["train"] and encoder in MOBILEONE_ENCODERS:
        raise not_ported(f"training the {encoder!r} encoder (predict and metrics run)",
                         "slice 6: MobileOne training")
    return cfg


# ---------------------------------------------------------------------------
# flair-detect (zone inference) config
# ---------------------------------------------------------------------------

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

    Path(_require(cfg, "output_path")).mkdir(parents=True, exist_ok=True)
    # batch mode finds its zones and truths under input_path and truth_root
    in_path = _require(cfg, "input_img_path")
    if not cfg["batch_mode"] and not os.path.exists(in_path):
        raise ConfigError(f"Input image path does not exist: {in_path}")

    if cfg["metrics"]:
        cfg["metrics_out"] = str(Path(cfg["output_path"]) / "metrics.json")
        if not cfg["batch_mode"]:
            truth = _require(cfg, "truth_path")
            if not os.path.exists(truth):
                raise ConfigError(f"Ground truth path does not exist: {truth}")

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
    if not isinstance(_require(cfg, "n_classes"), int):
        raise ConfigError("n_classes should be an integer.")

    norma = _require(cfg, "norma_task")
    if norma[0]["norm_type"] not in ("custom", "scaling"):
        raise ConfigError("Invalid normalization type: should be custom or scaling.")

    # the resnet encoders under the ported smp archs pass here, with the
    # knobs (flairtpu/config.py:319-346; MiT encoders fail as slice 6 / 7)
    _, arch = validate_model_framework(_require(cfg, "model_framework"))
    validate_knobs(cfg, arch)
    if arch == "pan":  # FPA pools the stride-16 map three times
        tiling = (cfg.get("strategies") or {}).get("tiling") or {}
        sizes = [size] + list((tiling.get("size_range") or []) if cfg["compare"] else [])
        if min(sizes) < 128:
            raise ConfigError(f"pan needs tiles of at least 128 pixels (got {min(sizes)}).")

    weights = _require(cfg, "model_weights")
    if not os.path.isfile(weights):
        raise ConfigError(f"Model weights file does not exist: {weights}")
    ext = os.path.splitext(str(weights))[1]
    if ext not in (".pth", ".pt", ".ckpt", ".msgpack", ".flax"):
        raise ConfigError(
            "Model weights should be a .pth/.ckpt (torch) or .msgpack/.flax (native) file. "
            f"Got {ext!r}")

    if cfg["compare"]:
        strat = _require(cfg, "strategies")
        tiling = strat.setdefault("tiling", {})
        tiling["size_range"] = _coerce_list(tiling.get("size_range"), int)
        tiling["stride_range"] = _coerce_list(tiling.get("stride_range"), float)
        if not all(0 <= s <= 1 for s in tiling["stride_range"]):
            raise ConfigError("Stride should be a percentage in [0, 1].")
        stitching = strat.setdefault("stitching", {})
        stitching["methods"] = _coerce_list(
            stitching.get("methods", stitching.get("method")), str)
        for m in stitching["methods"]:
            if m not in _STITCH_METHODS:
                raise ConfigError(f"Unknown stitching method {m!r}; valid: {_STITCH_METHODS}.")
        stitching["margin"] = _coerce_list(stitching.get("margin"), float)
        if not all(0 <= m <= 1 for m in stitching["margin"]):
            raise ConfigError("Margin should be a percentage in [0, 1].")
    return cfg


def gen_param_combination(cfg: dict) -> list[dict]:
    """Cross-product of compare-mode strategies (reference zone_detect/utils.py:110-167).

    padding x tile sizes x margins (fractional margins resolved against the tile
    size) x strides x stitching methods; combos with size <= 2*margin are skipped.
    """
    from flairtpu_torch.zone.grid import get_stride

    strat = cfg.get("strategies") or {}
    padding_list = strat.get("padding_overall") or ["no-padding"]
    if isinstance(padding_list, str):
        padding_list = [padding_list]

    tiling = strat.get("tiling") or {}
    sizes = tiling.get("size_range") if tiling.get("enabled") else None
    sizes = sizes or [cfg["img_pixels_detection"]]

    stitching = strat.get("stitching") or {}
    if stitching.get("enabled"):
        margins = stitching.get("margin") or [cfg["margin"]]
        methods = stitching.get("methods") or ["exact-clipping"]
    else:
        margins = [cfg["margin"]]
        methods = ["exact-clipping"]

    combos = []
    for padding in padding_list:
        for size in sizes:
            for margin in margins:
                if margin < 1:
                    margin = int(margin * size)
                if size <= 2 * margin:
                    print(f"    [x] skipping {size} pixels detection size with {margin} margin...")
                    continue
                geometry = dict(cfg, margin=margin, img_pixels_detection=size)
                for stride in get_stride(geometry):
                    for stitch in methods:
                        combos.append({"img_pixels_detection": size, "margin": margin,
                                       "padding": padding, "stitching": stitch,
                                       "stride": stride})
    return combos
