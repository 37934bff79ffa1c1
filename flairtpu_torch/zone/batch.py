"""Department batch mode, ``flair-detect -b`` (counterpart of
``flairtpu/zone/batch.py:16-89``; reference zone_detect/main.py:440-497).

Every zone folder under ``input_path`` that holds a ``*<data_type>.tif``
raster and a truth raster under ``truth_root/<dpt>/<zone>`` runs through the
zone pipeline, all with one model; then the per-method metrics of
``zone_metrics.batch_metrics`` go to the metrics JSON.

Zones are staged one ahead: a worker thread reads zone i + 1 and stages it
(pinned host buffers reused two in turn, and on the card its upload on a
CUDA stream of its own) while zone i computes and writes.
"""

from __future__ import annotations

import contextlib
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from flairtpu_torch.zone.device_engine import PinnedBuffers
from flairtpu_torch.zone.engine import prepare_model, resolve_device, run_pipeline, stage_zone
from flairtpu_torch.zone.grid import get_stride
from flairtpu_torch.zone.naming import method_string
from flairtpu_torch.zone.zone_metrics import batch_metrics

# a zone's stats kept in its record (the banded route's: also its bands and
# the wall time of its pipelined loop)
ZONE_STATS = ("read_seconds", "h2d_seconds", "compute_seconds", "d2h_seconds",
              "write_seconds", "seconds", "patches_per_sec", "tiles", "bands", "wall_seconds")


def find_jobs(config: dict) -> tuple[list[tuple[Path, Path]], Path]:
    """(zone raster, truth raster) of each zone folder, in name order, and
    the department's truth folder; a zone without truth is skipped with
    flairtpu's message."""
    truth_dpt = Path(config["truth_root"]) / Path(config["truth_path"]).parts[-3]
    jobs = []
    for zone_dir in sorted(p for p in Path(config["input_path"]).iterdir() if p.is_dir()):
        img_path = next(zone_dir.glob(f"*{config.get('data_type', '')}.tif"), None)
        if img_path is None:
            continue
        zone = img_path.parts[-2]
        truth_path = next((truth_dpt / zone).glob("*.tif"), None)
        if truth_path is None:
            print(f"No ground truth found for zone: {zone}")
            continue
        jobs.append((img_path, truth_path))
    return jobs, truth_dpt


def _stage_ahead(config: dict, device: torch.device, img_path: Path,
                 buffers: PinnedBuffers, stream) -> dict:
    """The worker's job: read and stage one zone. Its upload runs on
    ``stream``: a thread's current stream is the legacy default stream,
    which would serialise the copy with the zone computing meanwhile."""
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        return stage_zone(config, device, img_path, buffers)


def batch_metrics_pipeline(config: dict) -> dict:
    """Run the department and write the metrics JSON; returns {'zones': one
    record of seconds a zone (``ZONE_STATS``, the wait on the prefetch, and
    the host's span of the zone's run and the card's span of its upload,
    both in seconds since the start), 'metrics', 'seconds'}, and the int8
    model's 'calibration_seconds'."""
    out_json = Path(config["metrics_out"])
    jobs, truth_dpt = find_jobs(config)
    device = resolve_device(config)
    if jobs and config.get("quantize"):
        # int8 activation scales calibrate on the department's first zone and
        # serve all its zones (flairtpu/zone/batch.py:47-50)
        config["input_img_path"] = str(jobs[0][0])
    prepared = prepare_model(config, device)  # one model for the department
    buffers = PinnedBuffers(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    method = method_string(config["img_pixels_detection"], get_stride(config)[0],
                           config["margin"], "no-padding",
                           config.get("stitching", "exact-clipping"))
    if stream is not None:  # the reference for the card's clock: now, on an idle card
        torch.cuda.synchronize(device)
        ref = torch.cuda.Event(enable_timing=True)
        ref.record()
    t0 = time.perf_counter()
    zones, uploads = [], []
    with ThreadPoolExecutor(max_workers=1) as pool:
        def ahead(i: int):
            if i >= len(jobs):
                return None
            return pool.submit(_stage_ahead, dict(config), device, jobs[i][0], buffers, stream)

        pending = ahead(0)
        for i, (img_path, truth_path) in enumerate(jobs):
            tw = time.perf_counter()
            staged = pending.result()  # an error in the worker fails the run here
            wait = time.perf_counter() - tw
            pending = ahead(i + 1)
            # the method suffix makes the rasters parseable by info_extract
            config.update(input_img_path=str(img_path), truth_path=str(truth_path),
                          output_name=f"{img_path.stem}-ARGMAX-S_{method}")
            start = time.perf_counter() - t0
            stats = run_pipeline(config, prepared, staged)
            zones.append({"zone": img_path.parts[-2], "prefetch_wait_seconds": wait,
                          "run_span": (start, time.perf_counter() - t0),
                          **{k: stats[k] for k in ZONE_STATS if k in stats}})
            uploads.append((staged.get("h2d_start"), staged.get("h2d_done")))
    seconds = time.perf_counter() - t0
    for rec, (start, done) in zip(zones, uploads):
        if start is not None:
            rec["h2d_span"] = (ref.elapsed_time(start) / 1e3, ref.elapsed_time(done) / 1e3)

    metrics = batch_metrics(config, truth_dpt)
    out = out_json.with_suffix(".json")
    with open(out, "w") as f:
        json.dump(metrics, f)
    print(f"Metrics saved to {out}")
    out = {"zones": zones, "metrics": metrics, "seconds": seconds}
    if hasattr(prepared[0], "calibration_seconds"):
        out["calibration_seconds"] = prepared[0].calibration_seconds
    return out
