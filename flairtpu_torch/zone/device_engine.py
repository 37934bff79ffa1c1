"""Device-resident zone inference: gather -> forward -> stitch on the card
(counterpart of ``flairtpu/zone/device_engine.py:56-221, 512-748``).

The whole margin-padded zone (uint8) sits in device memory; each batch of
tiles is gathered and normalized by one kernel (``ops/gather.py``) and runs
through the encoder and all decoder blocks but the last (cuDNN convolutions,
each followed by the conv-epilogue kernel, ``ops/epilogue.py``). Then, by
stitching method and output type:

- exact-clipping, argmax: the fused decoder-tail kernel
  (``ops/fused_tail.py``) writes the uint8 class and probability of each
  tile's owned window straight into two planes. The windows
  (:func:`exact_windows`) give each plane pixel to the tile that the
  reference's tile-order writes leave there (last write wins), so the kernel
  needs no ordering;
- class_prob (any method: the reference forces exact clipping): the tail's
  probs mode writes round(255 * softmax) of each class through the same
  windows into one (H, W, K) plane;
- average, average_weights and max decode the whole tile (margin 0): the
  tail's logits mode writes each batch's float32 logits, and
  ``ops/stitch.py``'s kernels add them, in tile order, into accumulators in
  padded zone coordinates, then crop them to the uint8 class and prob
  planes.

The result comes back to the host in one transfer. The banded and the
sharded programs are not ported yet.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from flairtpu_torch.config import not_ported
from flairtpu_torch.ops import stitch, tile_softmax
from flairtpu_torch.ops.fused_tail import (TailParams, fused_tail, fused_tail_logits,
                                           fused_tail_probs, tail_geometry)
from flairtpu_torch.ops.gather import gather_normalize
from flairtpu_torch.zone.grid import Tile, TileGrid
from flairtpu_torch.zone.weights import patch_weights

DEFAULT_BUDGET = 6 << 30


def device_budget_bytes() -> int:
    return int(os.environ.get("FLAIRTPU_DEVICE_ZONE_BYTES", DEFAULT_BUDGET))


def zone_padding(height: int, width: int, size: int, margin: int) -> tuple[int, int, int]:
    """(pad_lo, pad_hi_rows, pad_hi_cols) of the padded zone: origins live in
    [0, H+2m-S] (the grid clamps the last row/col), so m on each side covers
    every S-row gather; zones smaller than a patch need extra tail padding so
    that the padded extent reaches S."""
    return margin, max(margin, size - height - margin), max(margin, size - width - margin)


def estimate_bytes(grid: TileGrid, n_channels: int, n_classes: int, method: str,
                   output_type: str, batch: int) -> int:
    """Device bytes a zone run allocates beyond the model: the staged zone
    and its padded copy, and the planes and buffers of the program that
    ``method`` and ``output_type`` select."""
    H, W, S, m = grid.height, grid.width, grid.patch_size, grid.margin
    lo, hi_r, hi_c = zone_padding(H, W, S, m)
    Hp, Wp = H + lo + hi_r, W + lo + hi_c
    s = S - 2 * m
    Ho, Wo = max(H, s), max(W, s)
    zone = (H * W + Hp * Wp) * n_channels
    if output_type == "class_prob":
        return zone + Ho * Wo * n_classes
    if method == "exact-clipping":
        return zone + Ho * Wo * 2
    logits = batch * S * S * n_classes * 4
    planes = Hp * Wp * ((n_classes + 1) * 4 if method != "max" else 5)
    return zone + logits + planes + H * W * 2


def require_uint8(dtype, route: str) -> None:
    """Both zone routes take uint8 rasters only (ROADMAP slice 2 item 6)."""
    if np.dtype(dtype) != np.uint8:
        raise not_ported(f"{np.dtype(dtype)} zone rasters on {route}", "slice 2")


def upload_zone(host: torch.Tensor, device: torch.device) -> dict:
    """Start the copy of an (H, W, C) uint8 host zone to ``device``:
    {'zone_dev', 'h2d_done'}. From pinned memory the copy is asynchronous
    and ``h2d_done`` is the event that marks its end; from pageable memory
    it is done when this returns."""
    if device.type != "cuda" or not host.is_pinned():
        return {"zone_dev": host.to(device), "h2d_done": None}
    zone_dev = host.to(device, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return {"zone_dev": zone_dev, "h2d_done": done}


def stage_array(arr: np.ndarray, device: torch.device) -> dict:
    """Keep a (C, H, W) zone read as an (H, W, C) host tensor, ``zone_host``,
    and start its upload to ``device``, unless the zone is too large for the
    device route (``nbytes * 4`` over :func:`device_budget_bytes`, as
    ``flairtpu/zone/engine.py:349-358``): such a zone streams, and a device
    run that takes it after all uploads it then (:meth:`DeviceZoneRunner.run`).

    On the card an uploaded zone sits in pinned host memory, which the
    staged dict keeps beyond the copy."""
    require_uint8(arr.dtype, "the device route")
    upload = arr.nbytes * 4 <= device_budget_bytes()
    host = torch.empty((arr.shape[1], arr.shape[2], arr.shape[0]), dtype=torch.uint8,
                       pin_memory=upload and device.type == "cuda")
    host.numpy()[...] = np.moveaxis(arr, 0, -1)
    staged = {"zone_host": host}
    if upload:
        staged.update(upload_zone(host, device))
    return staged


def _owned(starts: list[int], s: int) -> list[tuple[int, int]]:
    """One axis of last-write-wins: intervals [a, a + s) written in the order
    of ``starts`` -> for each, the [lo, hi) relative to a that no later
    interval overwrites. The starts must be monotone, as the grid's columns
    ascend and its rows descend: then only the next interval cuts, the later
    ones lie further out."""
    out = []
    for a, nxt in zip(starts, starts[1:] + [None]):
        if nxt is None:
            out.append((0, s))
        elif nxt >= a:  # later intervals lie to the right: keep [a, nxt)
            out.append((0, min(s, nxt - a)))
        else:  # later intervals lie to the left: keep [nxt + s, a + s)
            out.append((min(s, max(0, nxt + s - a)), s))
    return out


def exact_windows(tiles: list[Tile], height: int, width: int, s: int,
                  n_total: int) -> np.ndarray:
    """(n_total, 6) int32 (R0, C0, rlo, rhi, clo, chi) per tile: the s x s
    interior's origin in the (max(H, s), max(W, s)) planes, clamped as the
    reference clamps it for zones smaller than a tile, and the window of the
    interior the tile owns when tiles write in grid order, last write wins.

    The grid enumerates columns as the outer loop and rows as the inner one,
    with the same rows in every column, so pixel (y, x) belongs to the last
    column whose interior holds x and, in it, to the last row whose interior
    holds y: the window is the product of two per-axis intervals. Tiles
    beyond ``len(tiles)`` (duplicates that pad the last batch) and tiles that
    own nothing get an empty window."""
    Ho, Wo = max(height, s), max(width, s)
    col_start = {t.col0: min(t.icol0, Wo - s) for t in tiles}
    row_start = {t.row0: min(t.irow0, Ho - s) for t in tiles}
    cols = dict(zip(col_start, _owned(list(col_start.values()), s)))
    rows = dict(zip(row_start, _owned(list(row_start.values()), s)))
    out = np.zeros((n_total, 6), np.int32)
    for i, t in enumerate(tiles):
        (rlo, rhi), (clo, chi) = rows[t.row0], cols[t.col0]
        out[i, :2] = row_start[t.row0], col_start[t.col0]
        if rlo < rhi and clo < chi:
            out[i, 2:] = rlo, rhi, clo, chi
    return out


class DeviceZoneRunner:
    """Runs the zone programs on the model's device. Its per-batch forward
    (``_tail_input`` and the three ``_forward_*``) also serves the streaming
    route (``zone/engine.py:ZoneEngine``)."""

    # the stitch kernels' and the full-tile softmax kernels' wrappers (a
    # subclass may swap in other functions of the same names and arguments)
    stitch_ops = stitch
    tile_ops = tile_softmax

    def __init__(self, config: dict, model, tail: TailParams):
        self.config = config
        self.model = model
        self.tail = tail
        self.size = int(config["img_pixels_detection"])
        self.margin = int(config["margin"])
        self.batch = int(config.get("batch_size", 8))
        self.n_classes = int(config["n_classes"])
        self.output_type = config["output_type"]
        norma = config["norma_task"][0]
        self.norm = dict(norm_type=norma["norm_type"],
                         means=tuple(norma.get("norm_means") or ()),
                         stds=tuple(norma.get("norm_stds") or ()))
        self.geometry = tail_geometry(self.size, self.margin)
        self.full_geometry = tail_geometry(self.size, 0)

    @property
    def device(self) -> torch.device:
        return self.tail.epi.device

    def _tail_input(self, zone: torch.Tensor, origins: torch.Tensor, margin: int):
        """One batch, (B, 2) origins in the padded zone -> the fused tail's
        input, decoded on the interior plan of ``margin``."""
        x = gather_normalize(zone, origins, self.size, out_dtype=self.model.dtype,
                             **self.norm)
        return self.model.tail_input(x, margin)

    def _forward_tiles(self, zone: torch.Tensor, origins: torch.Tensor,
                       planes: torch.Tensor, windows: torch.Tensor) -> None:
        """One batch: each tile's owned window (``windows`` (B, 6)) of class
        and prob goes into the (2, H, W) planes."""
        fused_tail(self._tail_input(zone, origins, self.margin), self.tail, self.geometry,
                   planes, windows)

    def _forward_probs(self, zone: torch.Tensor, origins: torch.Tensor,
                       plane: torch.Tensor, windows: torch.Tensor) -> None:
        """One batch: each tile's owned window of round(255 * softmax) goes
        into the (H, W, K) plane."""
        fused_tail_probs(self._tail_input(zone, origins, self.margin), self.tail,
                         self.geometry, plane, windows)

    def _forward_logits(self, zone: torch.Tensor, origins: torch.Tensor,
                        out: torch.Tensor | None) -> torch.Tensor:
        """One batch -> the whole tiles' float32 logits (B, S, S, K)."""
        return fused_tail_logits(self._tail_input(zone, origins, 0), self.tail,
                                 self.full_geometry, out)

    def _run_exact(self, zone: torch.Tensor, origins: torch.Tensor,
                   windows: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
        """exact-clipping: (n_batches, B, 2) origins and (n_batches, B, 6)
        windows on the device -> the (2, H, W) class and prob planes."""
        planes = torch.zeros((2, *out_hw), dtype=torch.uint8, device=zone.device)
        for org, win in zip(origins, windows):
            self._forward_tiles(zone, org, planes, win)
        return planes

    def _run_exact_probs(self, zone: torch.Tensor, origins: torch.Tensor,
                         windows: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
        """class_prob (``device_engine.py:164-192``): the (H, W, K) uint8
        plane of the interiors' round(255 * softmax), exact clipping."""
        plane = torch.zeros((*out_hw, self.n_classes), dtype=torch.uint8, device=zone.device)
        for org, win in zip(origins, windows):
            self._forward_probs(zone, org, plane, win)
        return plane

    def _run_accumulate(self, zone: torch.Tensor, origins: torch.Tensor,
                        valid: torch.Tensor, footprints: list, weighted: bool,
                        padded_hw: tuple[int, int], crop) -> torch.Tensor:
        """average / average_weights (``device_engine.py:194-221``): whole-tile
        softmax times ``w * valid`` accumulated in tile order into padded
        (Hp, Wp, K) and (Hp, Wp) planes -> (2, h, w) class and prob of the
        crop."""
        dev = zone.device
        acc = torch.zeros((*padded_hw, self.n_classes), dtype=torch.float32, device=dev)
        div = torch.zeros(padded_hw, dtype=torch.float32, device=dev)
        w = (torch.from_numpy(patch_weights(self.size).astype(np.float32)).to(dev)
             if weighted else None)
        logits = None  # one buffer for every batch
        for org, val, fp in zip(origins, valid, footprints):
            logits = self._forward_logits(zone, org, logits)
            self.stitch_ops.accumulate_probs(logits, org, val, w, acc, div, fp)
        return self.stitch_ops.stitch_finalize_mean(acc, div, crop)

    def _run_max(self, zone: torch.Tensor, origins: torch.Tensor, valid: torch.Tensor,
                 footprints: list, padded_hw: tuple[int, int], crop) -> torch.Tensor:
        """max (``device_engine.py:512-539``): whole-tile (argmax, max prob)
        merged in tile order where strictly greater -> (2, h, w) class and
        prob of the crop."""
        dev = zone.device
        best_p = torch.zeros(padded_hw, dtype=torch.float32, device=dev)
        best_c = torch.zeros(padded_hw, dtype=torch.uint8, device=dev)
        logits = None
        for org, val, fp in zip(origins, valid, footprints):
            logits = self._forward_logits(zone, org, logits)
            self.stitch_ops.merge_max(logits, org, val, best_p, best_c, fp)
        return self.stitch_ops.stitch_finalize_max(best_p, best_c, crop)

    def run(self, grid: TileGrid, method: str, staged: dict) -> dict:
        """Returns host arrays, {'cls', 'prob'} (H, W) uint8 or, for
        class_prob, {'probs'} (K, H, W) uint8, and timings.

        ``staged`` (from :func:`stage_array`, via
        :func:`flairtpu_torch.zone.engine.stage_zone`) holds the zone already
        read, with its host-to-device copy in flight, or a zone that staging
        kept on the host, which is copied here (h2d_seconds)."""
        if method not in ("exact-clipping", "average", "average_weights", "max"):
            raise ValueError(f"unknown stitching method {method!r}")
        S, m, B = self.size, self.margin, self.batch
        H, W = grid.height, grid.width
        pad_lo, pad_hi_r, pad_hi_c = zone_padding(H, W, S, m)
        Hp, Wp = H + pad_lo + pad_hi_r, W + pad_lo + pad_hi_c
        tiles = grid.tiles
        n = len(tiles)
        # pad with duplicates of the last tile: their windows are empty, and
        # in the average and max programs their valid is 0
        all_tiles = tiles + [tiles[-1]] * ((-n) % B)
        origins = np.array(
            [(t.row0 + pad_lo, t.col0 + pad_lo) for t in all_tiles], np.int32)
        valid = np.array([1.0] * n + [0.0] * (len(all_tiles) - n), np.float32)
        s = S - 2 * m
        Ho, Wo = max(H, s), max(W, s)
        # class_prob forces exact clipping for every method, as the reference
        # does (compare.py:68); it is checked first
        exact = self.output_type == "class_prob" or method == "exact-clipping"
        if exact:
            windows = exact_windows(tiles, H, W, s, len(all_tiles))
        else:
            fps = [stitch.footprint(o, v, S) for o, v in
                   zip(origins.reshape(-1, B, 2), valid.reshape(-1, B))]

        timings: dict[str, float] = {}
        t0 = time.perf_counter()
        if "zone_dev" not in staged:  # a zone staged for streaming: upload it now
            staged = dict(staged, **upload_zone(staged["zone_host"], self.device))
        zone = staged["zone_dev"]
        if staged["h2d_done"] is not None:
            staged["h2d_done"].synchronize()  # residual wait on the staged copy
        timings["h2d_seconds"] = time.perf_counter() - t0

        with torch.inference_mode():
            tc = time.perf_counter()
            zone_p = torch.zeros((Hp, Wp, zone.shape[2]), dtype=zone.dtype, device=zone.device)
            zone_p[pad_lo:pad_lo + H, pad_lo:pad_lo + W] = zone
            ob = torch.from_numpy(origins.reshape(-1, B, 2)).to(zone.device)
            if exact:
                wb = torch.from_numpy(windows.reshape(-1, B, 6)).to(zone.device)
                if self.output_type == "class_prob":
                    out = self._run_exact_probs(zone_p, ob, wb, (Ho, Wo))
                else:
                    out = self._run_exact(zone_p, ob, wb, (Ho, Wo))
            else:
                vb = torch.from_numpy(valid.reshape(-1, B)).to(zone.device)
                crop = (pad_lo, pad_lo, H, W)
                if method == "max":
                    out = self._run_max(zone_p, ob, vb, fps, (Hp, Wp), crop)
                else:
                    out = self._run_accumulate(zone_p, ob, vb, fps, method == "average_weights",
                                               (Hp, Wp), crop)
            if zone.device.type == "cuda":
                torch.cuda.synchronize(zone.device)
            timings["compute_seconds"] = time.perf_counter() - tc
            td = time.perf_counter()
            host = out.cpu().numpy()  # one device-to-host copy of the result
            timings["d2h_seconds"] = time.perf_counter() - td
        t_run = time.perf_counter() - t0
        if self.output_type == "class_prob":
            result = {"probs": np.moveaxis(host[:H, :W], -1, 0)}
        else:
            result = {"cls": host[0, :H, :W], "prob": host[1, :H, :W]}
        return dict(result, tiles=n, seconds=t_run, read_seconds=staged["read_seconds"],
                    patches_per_sec=n / t_run if t_run else 0.0, **timings)
