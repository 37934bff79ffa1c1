"""flair-detect pipeline (counterpart of ``flairtpu/zone/engine.py:47-78,
245-506``): model preparation, output paths, zone staging, one device-resident
pass over the zone and the GeoTIFF write, or with ``compare`` the sweep of
``zone/compare.py``.

``use_gpu: true`` (the default) runs on the CUDA card and raises if there is
none; ``use_gpu: false`` runs on the CPU, where the kernels' plain PyTorch
versions run. There is no other route to the CPU.
"""

from __future__ import annotations

import datetime
import json
import time
from pathlib import Path

import numpy as np
import torch

from flairtpu_torch.config import not_ported
from flairtpu_torch.io import TiffReader, TiffWriter
from flairtpu_torch.models.convert import load_weights
from flairtpu_torch.models.factory import create_model
from flairtpu_torch.ops.fused_tail import tail_params
from flairtpu_torch.utils.logger import tee_stdout, untee_stdout
from flairtpu_torch.zone.device_engine import (DeviceZoneRunner, device_budget_bytes,
                                               estimate_bytes, stage_array)
from flairtpu_torch.zone.grid import TileGrid, get_stride, slice_grid


def resolve_device(config: dict) -> torch.device:
    """``use_gpu`` true -> the CUDA card (raises without one); false -> CPU."""
    if not config.get("use_gpu", True):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "use_gpu is true but CUDA is not available; set use_gpu: false to "
            "run flair-detect on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def compute_dtype(device: torch.device) -> torch.dtype:
    """bfloat16 convolutions on the card, float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


# ---------------------------------------------------------------------------
# model preparation (reference zone_detect/model.py:61-88 + main.py:186-203)
# ---------------------------------------------------------------------------

def prepare_model(config: dict, device: torch.device):
    """Build the model, load its weights strictly, move it to ``device``,
    prepare it for inference (conv weights in the compute dtype, BatchNorm
    (scale, shift) pairs) and derive the fused tail's parameters. Returns
    (model, tail)."""
    dtype = compute_dtype(device)
    model = create_model(config, dtype=dtype)
    load_weights(model, config["model_weights"])
    print("    [x] loaded model and weights...")
    model = model.to(device, memory_format=torch.channels_last).eval()
    model.prepare_inference()
    return model, tail_params(model, dtype)


# ---------------------------------------------------------------------------
# pipeline orchestration (reference main.py:244-436)
# ---------------------------------------------------------------------------

def setup_out_path(config: dict) -> dict:
    """The run's output directory: ``output_path``, or under ``compare`` a
    timestamped directory inside it."""
    out = Path(config["output_path"])
    out.mkdir(parents=True, exist_ok=True)
    if config.get("compare"):
        out = out / datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        out.mkdir(parents=True, exist_ok=True)
        print(f"Creating output directory: {out}")
    config["local_out"] = str(out)
    return config


def setup_indiv_path(config: dict, identifier: str = "") -> str:
    """Collision-avoiding output path (reference utils.py:256-279)."""
    out_name = config["output_name"] + identifier
    if not out_name.endswith(".tif"):
        out_name += ".tif"
    path = Path(config["local_out"]) / out_name
    stem, ext = path.stem, path.suffix
    counter = 1
    while path.exists():
        path = path.with_name(f"{stem}_{counter}{ext}")
        counter += 1
    return str(path)


def describe_device(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)}) x{torch.cuda.device_count()}"
    return "cpu"


def conf_log(config: dict, reader: TiffReader, device: torch.device) -> None:
    mf = config["model_framework"]
    provider = mf["model_provider"]
    tpl = mf.get(provider, {})
    model_template = f"{provider} - " + str(
        tpl.get("org_model") or tpl.get("encoder_decoder") or "?")
    print(f"""
    |- output path: {config['output_path']}
    |- output raster name: {config['output_name']}

    |- input image path: {config['input_img_path']}
    |- channels: {config['channels']}
    |- input image WxH: {reader.width, reader.height}
    |- resolution: {reader.res}
    |- number of classes: {config['n_classes']}
    |- normalization: {config['norma_task'][0]['norm_type']}
    |- output type: {config['output_type']}

    |- model weights path: {config.get('model_weights', '<in-memory>')}
    |- model template: {model_template}
    |- device: {describe_device(device)}
    |- batch size: {config['batch_size']}
    """)


def _make_writer(config: dict, reader: TiffReader, path_out: str) -> TiffWriter:
    n_bands = 2 if config["output_type"] == "argmax" else int(config["n_classes"])
    return TiffWriter(
        path_out, reader.width, reader.height, n_bands, "uint8",
        transform=reader.transform, crs=reader.crs,
        compress="lzw", tiled=True,
        blockxsize=config["img_pixels_detection"],
        blockysize=config["img_pixels_detection"],
        bigtiff="auto",
        # optional COG-style overview pyramid (nearest; class rasters must
        # not blend labels), e.g. output_overviews: [2, 4, 8]
        overviews=config.get("output_overviews"))


def stage_zone(config: dict, device: torch.device) -> dict:
    """Read the zone and start its host-to-device copy without waiting."""
    t0 = time.perf_counter()
    with TiffReader(config["input_img_path"], cache_blocks=128) as r:
        arr = r.read(config["channels"])
    staged = stage_array(arr, device)
    staged["read_seconds"] = time.perf_counter() - t0
    return staged


def run_single(config: dict, model, tail, device: torch.device, stride: int,
               method: str, identifier: str = "",
               staged: dict | None = None) -> tuple[str, dict, TileGrid]:
    """One (grid, stitch, output raster) pass over the zone, device-resident.

    ``staged`` (from :func:`stage_zone`) is a zone already read and on its
    way to the device, which the compare sweep shares across its runs; by
    default the zone is read here. A zone over the device budget raises: the
    streaming route is slice 2."""
    size, margin = config["img_pixels_detection"], config["margin"]
    with TiffReader(config["input_img_path"], cache_blocks=128) as reader:
        grid = slice_grid(reader.width, reader.height, size, margin, stride,
                          reader.transform, reader.crs)
        if config.get("write_dataframe"):
            gj = Path(config["local_out"]) / (
                str(config["output_name"]).split(".tif")[0] + "_slicing_job.geojson")
            gj.write_text(json.dumps(grid.to_geojson()))
        conf_log(config, reader, device)
        print(f"    [x] sliced input raster to {len(grid)} squares...")
        path_out = setup_indiv_path(config, identifier)

        need = estimate_bytes(grid, len(config["channels"]), int(config["n_classes"]),
                              method, config["output_type"], int(config["batch_size"]))
        if need > device_budget_bytes():
            raise not_ported(
                f"the streaming zone route (zone needs {need} bytes, device "
                f"budget {device_budget_bytes()})", "slice 2")
        print("    [x] zone path: device-resident")
        print("    [ ] starting inference...\n")
        runner = DeviceZoneRunner(config, model, tail)
        res = runner.run(grid, method, staged or stage_zone(config, device))
        writer = _make_writer(config, reader, path_out)
        if "probs" in res:
            writer.write_band(list(range(1, config["n_classes"] + 1)), res["probs"])
        else:
            writer.write_band([1, 2], np.stack([res["cls"], res["prob"]]))
        writer.close()
    stats = {k: res[k] for k in ("tiles", "seconds", "patches_per_sec", "read_seconds",
                                 "h2d_seconds", "compute_seconds", "d2h_seconds")}
    # cumulative elapsed time per patch, the reference's timing shape
    # (flairtpu/zone/engine.py:432-437)
    total_ms, n = res["seconds"] * 1000.0, max(res["tiles"], 1)
    stats["patch_times_ms"] = [total_ms * (i + 1) / n for i in range(n)]
    print(f"    [X] done writing to {Path(path_out).name} raster file "
          f"({stats['tiles']} tiles, {stats['patches_per_sec']:.1f} patches/s).\n")
    return path_out, stats, grid


def run_pipeline(config: dict) -> dict:
    """flair-detect entry (reference main.py:244-436); returns the run's
    stats, or with ``compare`` the sweep's stats by method string."""
    device = resolve_device(config)
    config = setup_out_path(config)
    log_file = Path(config["local_out"]) / (
        f"{config['output_name']}_"
        f"{datetime.datetime.now().strftime('%Y%m%d_%H%M%S')}.log")
    tee_stdout(str(log_file), capture_stderr=True)
    print(f"    [LOGGER] Writing logs to: {log_file}")
    try:
        print(f"""
    ##############################################
    ZONE DETECTION
    ##############################################

    PyTorch device: {describe_device(device)}""")
        model, tail = prepare_model(config, device)
        if config.get("compare"):
            from flairtpu_torch.zone.compare import run_compare

            return run_compare(config, model, tail, device)
        _, stats, _ = run_single(config, model, tail, device, get_stride(config)[0],
                                 "exact-clipping")
        return stats
    finally:
        untee_stdout()
