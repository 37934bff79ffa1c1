"""Device-resident zone inference: gather -> forward -> stitch on the card
(counterpart of ``flairtpu/zone/device_engine.py:56-162, 543-711``).

The whole margin-padded zone (uint8) sits in device memory; each batch of
tiles is gathered and normalized by one kernel (``ops/gather.py``), runs
through the encoder and all decoder blocks but the last (cuDNN convolutions,
each followed by the conv-epilogue kernel, ``ops/epilogue.py``), and the
fused decoder-tail kernel (``ops/fused_tail.py``) writes the uint8
class and probability of each tile's owned window straight into two
device-resident planes. The windows (:func:`exact_windows`) give each plane
pixel to the tile that the reference's tile-order writes leave there (last
write wins), so the kernel needs no ordering. Both planes come back to the
host in one transfer.

Slice 1 runs exact-clipping with ``output_type: argmax`` on one device. The
other stitching methods, ``class_prob``, the banded and the sharded programs
raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from flairtpu_torch.config import not_ported
from flairtpu_torch.ops.fused_tail import TailParams, fused_tail, tail_geometry
from flairtpu_torch.ops.gather import gather_normalize
from flairtpu_torch.zone.grid import Tile, TileGrid

DEFAULT_BUDGET = 6 << 30


def device_budget_bytes() -> int:
    return int(os.environ.get("FLAIRTPU_DEVICE_ZONE_BYTES", DEFAULT_BUDGET))


def estimate_bytes(grid: TileGrid, n_channels: int) -> int:
    """Device bytes of an exact-clipping argmax zone: the padded uint8 zone
    and its class and probability planes (counted as the reference does)."""
    Hp = grid.height + 2 * grid.margin
    Wp = grid.width + 2 * grid.margin
    return Hp * Wp * (n_channels + 6)


def stage_array(arr: np.ndarray, device: torch.device) -> dict:
    """Start the upload of a (C, H, W) zone read to ``device`` as (H, W, C).

    On the card the zone goes through pinned host memory and an
    asynchronous copy; ``h2d_done`` is the event that marks its end."""
    if arr.dtype != np.uint8:
        raise not_ported(f"{arr.dtype} zone rasters on the device path", "slice 2")
    shape = (arr.shape[1], arr.shape[2], arr.shape[0])
    if device.type != "cuda":
        return {"zone_dev": torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(arr, 0, -1))).to(device), "h2d_done": None}
    host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    host.numpy()[...] = np.moveaxis(arr, 0, -1)
    zone_dev = host.to(device, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    # the pinned buffer must outlive the copy: keep it with the staged zone
    return {"zone_dev": zone_dev, "h2d_done": done, "_pinned": host}


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
    """Runs the exact-clipping zone program on the staged zone's device."""

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

    def _forward_tiles(self, zone: torch.Tensor, origins: torch.Tensor,
                       planes: torch.Tensor, windows: torch.Tensor) -> None:
        """One batch: (B, 2) origins in the padded zone; each tile's owned
        window (``windows`` (B, 6)) goes into the (2, H, W) planes."""
        x = gather_normalize(zone, origins, self.size, out_dtype=self.model.dtype,
                             **self.norm)
        x3 = self.model.tail_input(x, self.margin)
        fused_tail(x3, self.tail, self.geometry, planes, windows)

    def _run_exact(self, zone: torch.Tensor, origins: torch.Tensor,
                   windows: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
        """exact-clipping: (n_batches, B, 2) origins and (n_batches, B, 6)
        windows on the device -> the (2, H, W) class and prob planes."""
        planes = torch.zeros((2, *out_hw), dtype=torch.uint8, device=zone.device)
        for org, win in zip(origins, windows):
            self._forward_tiles(zone, org, planes, win)
        return planes

    def run(self, grid: TileGrid, method: str, staged: dict) -> dict:
        """Returns host arrays {'cls', 'prob'} (H, W) uint8 and timings.

        ``staged`` (from :func:`stage_array`, via
        :func:`flairtpu_torch.zone.engine.stage_zone`) holds the zone already
        read, with its host-to-device copy in flight."""
        if method != "exact-clipping":
            raise not_ported(f"stitching method {method!r}", "slice 2")
        if self.output_type != "argmax":
            raise not_ported(f"output_type {self.output_type!r}", "slice 2")
        S, m, B = self.size, self.margin, self.batch
        H, W = grid.height, grid.width
        # pad so every full patch window is a valid slice: origins live in
        # [0, H+2m-S] (the grid clamps the last row/col), so m on each side
        # covers every S-row gather; zones smaller than a patch need extra
        # tail padding so the padded extent reaches S
        pad_lo = m
        pad_hi_r = max(m, S - H - m)
        pad_hi_c = max(m, S - W - m)
        tiles = grid.tiles
        n = len(tiles)
        # pad with duplicates of the last tile: their windows are empty
        all_tiles = tiles + [tiles[-1]] * ((-n) % B)
        origins = np.array(
            [(t.row0 + pad_lo, t.col0 + pad_lo) for t in all_tiles], np.int32)
        s = S - 2 * m
        windows = exact_windows(tiles, H, W, s, len(all_tiles))
        Ho, Wo = max(H, s), max(W, s)

        timings: dict[str, float] = {}
        t0 = time.perf_counter()
        zone = staged["zone_dev"]
        if staged["h2d_done"] is not None:
            staged["h2d_done"].synchronize()  # residual wait on the staged copy
        timings["h2d_seconds"] = time.perf_counter() - t0

        with torch.inference_mode():
            tc = time.perf_counter()
            zone_p = torch.zeros((H + pad_lo + pad_hi_r, W + pad_lo + pad_hi_c,
                                  zone.shape[2]), dtype=zone.dtype, device=zone.device)
            zone_p[pad_lo:pad_lo + H, pad_lo:pad_lo + W] = zone
            ob = torch.from_numpy(origins.reshape(-1, B, 2)).to(zone.device)
            wb = torch.from_numpy(windows.reshape(-1, B, 6)).to(zone.device)
            planes = self._run_exact(zone_p, ob, wb, (Ho, Wo))
            if zone.device.type == "cuda":
                torch.cuda.synchronize(zone.device)
            timings["compute_seconds"] = time.perf_counter() - tc
            td = time.perf_counter()
            packed = planes.cpu().numpy()  # one device-to-host copy of both planes
            timings["d2h_seconds"] = time.perf_counter() - td
        t_run = time.perf_counter() - t0
        return dict(cls=packed[0, :H, :W], prob=packed[1, :H, :W], tiles=n,
                    seconds=t_run, read_seconds=staged["read_seconds"],
                    patches_per_sec=n / t_run if t_run else 0.0, **timings)
