"""Strategy-comparison sweep (counterpart of ``flairtpu/zone/compare.py``;
reference zone_detect/main.py:275-384).

Iterates the padding x tile-size x margin x stride x stitching
cross-product, producing one output raster per combination (method-string
suffixed filename), and with ``metrics`` a per-patch metrics JSON and the
per-method timing, with the reference's record shapes. The zone is read
once for the whole sweep, and copied to the card once unless it is too
large for the device route; each combination takes its own route through
``run_single`` and builds its own runner and tail geometry on the one
prepared model.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from flairtpu_torch.config import gen_param_combination
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Window
from flairtpu_torch.zone.naming import method_string
from flairtpu_torch.zone.zone_metrics import compute_metrics_patch, open_images


def run_compare(config: dict, model, tail, device: torch.device) -> dict:
    """Run every combination; returns each run's stats by method string."""
    from flairtpu_torch.zone.engine import run_single, stage_zone

    local_out = Path(config["local_out"])
    compute_metrics = bool(config.get("metrics"))
    truth_array, metrics_json = open_images(config, local_out, compute_metrics)
    staged = stage_zone(config, device)

    method_times: dict[str, list[float]] = {}
    results: dict[str, dict] = {}
    print("    [ ] starting comparison...\n")
    for combi in gen_param_combination(config):
        size, margin, stride = combi["img_pixels_detection"], combi["margin"], combi["stride"]
        stitch = combi["stitching"]
        config.update(combi)
        method = method_string(size, stride, margin, combi["padding"], stitch)
        path_out, stats, grid = run_single(config, model, tail, device, stride, stitch,
                                           identifier="_" + method, staged=staged)
        method_times[method] = stats["patch_times_ms"]
        results[method] = stats

        if compute_metrics:
            method_metrics = []
            with TiffReader(path_out) as r:
                for tile in grid.tiles:
                    h, w = tile.irow1 - tile.irow0, tile.icol1 - tile.icol0
                    if h <= 0 or w <= 0:
                        continue
                    win = Window(tile.icol0, tile.irow0, w, h)
                    method_metrics.append(compute_metrics_patch(
                        r.read(1, window=win), truth_array, win, config, method))
            config["times"] = method_times
            with open(metrics_json, "w") as f:
                json.dump(method_metrics, f, indent=2)
            print(f"    [X] done writing metrics to {metrics_json.name} file.\n")
    return results
