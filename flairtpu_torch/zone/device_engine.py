"""Device-resident zone inference: gather -> forward -> stitch on the card
(counterpart of ``flairtpu/zone/device_engine.py:56-162, 543-711``).

The whole margin-padded zone (uint8) sits in device memory; each batch of
tiles is gathered and normalized by one kernel (``ops/gather.py``), runs
through the encoder and all decoder blocks but the last (cuDNN convolutions),
and the fused decoder-tail kernel (``ops/fused_tail.py``) turns it into the
uint8 class and probability tiles. Their s x s interiors are written into two
device-resident planes in tile order (last write wins), and both planes come
back to the host in one transfer.

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
from flairtpu_torch.zone.grid import TileGrid

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

    def _forward_tiles(self, zone: torch.Tensor, origins: torch.Tensor):
        """(B, 2) origins in the padded zone -> (class, prob) uint8 (B, s, s)."""
        x = gather_normalize(zone, origins, self.size, out_dtype=self.model.dtype,
                             **self.norm)
        x3 = self.model.tail_input(x, self.margin)
        return fused_tail(x3, self.tail, self.geometry)

    def _run_exact(self, zone: torch.Tensor, origins: torch.Tensor,
                   inner_pos: np.ndarray, out_hw: tuple[int, int]) -> torch.Tensor:
        """exact-clipping: write each tile's s x s interior into the (2, H, W)
        class and prob planes, batch by batch and tile by tile; later tiles win."""
        s = self.size - 2 * self.margin
        planes = torch.zeros((2, *out_hw), dtype=torch.uint8, device=zone.device)
        for org, ipos in zip(origins, inner_pos):
            cls, prob = self._forward_tiles(zone, org)
            for i, (r0, c0) in enumerate(ipos.tolist()):
                planes[0, r0:r0 + s, c0:c0 + s] = cls[i]
                planes[1, r0:r0 + s, c0:c0 + s] = prob[i]
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
        # pad with duplicates of the last tile: they rewrite the same values
        all_tiles = tiles + [tiles[-1]] * ((-n) % B)
        origins = np.array(
            [(t.row0 + pad_lo, t.col0 + pad_lo) for t in all_tiles], np.int32)
        s = S - 2 * m
        inner = np.array([(t.irow0, t.icol0) for t in all_tiles], np.int32)
        # clamp so the s x s write stays in-plane (inner regions of realigned
        # tiles already satisfy this when H, W >= s)
        Ho, Wo = max(H, s), max(W, s)
        inner[:, 0] = np.minimum(inner[:, 0], Ho - s)
        inner[:, 1] = np.minimum(inner[:, 1], Wo - s)

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
            planes = self._run_exact(zone_p, ob, inner.reshape(-1, B, 2), (Ho, Wo))
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
