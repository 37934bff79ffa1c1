"""Host stitchers of the streaming zone route: exact-clipping, average,
average_weights, max (own copy of ``flairtpu/zone/stitch.py``, numpy).

The reference stitches by reading back the partially-written GTiff per patch
(src/zone_detect/compare.py:84-136). Here each strategy owns an accumulator
(RAM or disk memmap, picked by size) fed by the device payloads of
``zone/engine.py:ZoneEngine``, and the raster is written once at finalize —
no per-patch raster read-modify-write. These are the route for zones whose
accumulators do not fit the card: they stay on the host.

Output band layout (reference prepare_output, main.py:206-232): ``argmax`` ->
2 uint8 bands (band 1 = class id, band 2 = confidence scaled to 0..255),
``class_prob`` -> n_classes uint8 bands of probabilities * 255
(dataset.py:16-21).

Deviations from reference bugs, by design (as ``flairtpu``):
- ``average_weights`` divides by the weight-sum map (the reference divides by a
  (map, steps) tuple);
- ``max`` keeps the higher-confidence prediction (the reference compares class
  indices).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from flairtpu_torch.io.tiff import TiffWriter, Window
from flairtpu_torch.zone.grid import Tile, TileGrid
from flairtpu_torch.zone.weights import patch_weights

_RAM_LIMIT_BYTES = 1 << 29  # accumulators larger than 512 MiB go to disk


def _alloc(shape, dtype, tag: str, scratch_dir: str | None):
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if nbytes <= _RAM_LIMIT_BYTES:
        return np.zeros(shape, dtype)
    fd, path = tempfile.mkstemp(prefix=f".flair-acc-{tag}-", dir=scratch_dir)
    os.close(fd)
    mm = np.memmap(path, dtype=dtype, mode="w+", shape=shape)
    mm._flair_path = path  # type: ignore[attr-defined]
    return mm


def _release(arr):
    path = getattr(arr, "_flair_path", None)
    if path is not None:
        arr._mmap.close()  # type: ignore[attr-defined]
        try:
            os.remove(path)
        except OSError:
            pass


def to_uint8_prob(p: np.ndarray) -> np.ndarray:
    # rint (round half to even), as the device route's torch.round: the two
    # zone routes agree bit for bit
    return np.rint(p * 255.0).astype(np.uint8)


class ExactClipStitcher:
    """Default mode: disjoint inner regions, direct writes (compare.py:68-82)."""

    needs = "cropped_argmax"  # device payload: margin-cropped (cls, prob)

    def __init__(self, writer: TiffWriter, grid: TileGrid, config: dict):
        self.writer = writer
        self.grid = grid
        self.output_type = config["output_type"]
        self.n_classes = config["n_classes"]
        if self.output_type == "class_prob":
            self.needs = "cropped_probs"

    def add(self, tile: Tile, payload):
        h = tile.irow1 - tile.irow0
        w = tile.icol1 - tile.icol0
        if h <= 0 or w <= 0:
            return
        win = Window(tile.icol0, tile.irow0, w, h)
        if self.output_type == "argmax":
            cls, prob = payload
            self.writer.write_band([1, 2],
                                   np.stack([cls[:h, :w], prob[:h, :w]]), win)
        else:
            probs = payload  # (K, s, s) uint8
            self.writer.write_band(list(range(1, self.n_classes + 1)),
                                   probs[:, :h, :w], win)

    def finalize(self):
        pass


class _AccumulatorStitcher:
    """Shared machinery for the prob-accumulating overlap modes."""

    needs = "full_probs"  # device payload: full-tile softmax probs (K, S, S) f32

    def __init__(self, writer: TiffWriter, grid: TileGrid, config: dict,
                 weighted: bool):
        self.writer = writer
        self.grid = grid
        self.output_type = config["output_type"]
        k = config["n_classes"]
        H, W = writer.height, writer.width
        scratch = os.path.dirname(os.path.abspath(writer.path))
        self.acc = _alloc((k, H, W), np.float32, "acc", scratch)
        # the divisor accumulates from the tiles actually stitched, so it is
        # exact for any grid law
        self.div = _alloc((H, W), np.float32, "div", scratch)
        self.weighted = weighted
        self.w = patch_weights(grid.patch_size).astype(np.float32) if weighted else None

    def add(self, tile: Tile, probs: np.ndarray):
        S = self.grid.patch_size
        H, W = self.writer.height, self.writer.width
        r0, c0 = tile.row0, tile.col0
        rr0, cc0 = max(r0, 0), max(c0, 0)
        rr1, cc1 = min(r0 + S, H), min(c0 + S, W)
        if rr1 <= rr0 or cc1 <= cc0:
            return
        sub = probs[:, rr0 - r0 : rr1 - r0, cc0 - c0 : cc1 - c0]
        if self.weighted:
            wsub = self.w[rr0 - r0 : rr1 - r0, cc0 - c0 : cc1 - c0]
            sub = sub * wsub
            self.div[rr0:rr1, cc0:cc1] += wsub
        else:
            self.div[rr0:rr1, cc0:cc1] += 1.0
        self.acc[:, rr0:rr1, cc0:cc1] += sub

    def finalize(self):
        div = np.maximum(np.asarray(self.div), 1e-8)
        k = self.acc.shape[0]
        H, W = self.writer.height, self.writer.width
        block = max((1 << 24) // (k * W * 4), 64)  # row-block streaming
        for r0 in range(0, H, block):
            r1 = min(r0 + block, H)
            mean = self.acc[:, r0:r1, :] / div[r0:r1, :]
            win = Window(0, r0, W, r1 - r0)
            if self.output_type == "argmax":
                cls = np.argmax(mean, axis=0).astype(np.uint8)
                prob = to_uint8_prob(np.max(mean, axis=0))
                self.writer.write_band([1, 2], np.stack([cls, prob]), win)
            else:
                self.writer.write_band(list(range(1, k + 1)),
                                       to_uint8_prob(mean), win)
        _release(self.acc)
        _release(self.div)


class AverageStitcher(_AccumulatorStitcher):
    """mean probability over covering tiles (compare.py:118-124 intent)."""

    def __init__(self, writer, grid, config):
        super().__init__(writer, grid, config, weighted=False)


class AverageWeightsStitcher(_AccumulatorStitcher):
    """center-distance-decay weighted mean (compare.py:125-130 intent)."""

    def __init__(self, writer, grid, config):
        super().__init__(writer, grid, config, weighted=True)


class MaxStitcher:
    """Keep the highest-confidence prediction per pixel (compare.py:132-136)."""

    needs = "full_argmax"  # device payload: full-tile (cls u8, prob f32)

    def __init__(self, writer: TiffWriter, grid: TileGrid, config: dict):
        if config["output_type"] != "argmax":
            raise ValueError("max stitching requires output_type=argmax")
        self.writer = writer
        self.grid = grid
        H, W = writer.height, writer.width
        scratch = os.path.dirname(os.path.abspath(writer.path))
        self.best_prob = _alloc((H, W), np.float32, "maxp", scratch)
        self.best_cls = _alloc((H, W), np.uint8, "maxc", scratch)

    def add(self, tile: Tile, payload):
        cls, prob = payload
        S = self.grid.patch_size
        H, W = self.writer.height, self.writer.width
        r0, c0 = tile.row0, tile.col0
        rr0, cc0 = max(r0, 0), max(c0, 0)
        rr1, cc1 = min(r0 + S, H), min(c0 + S, W)
        if rr1 <= rr0 or cc1 <= cc0:
            return
        p = prob[rr0 - r0 : rr1 - r0, cc0 - c0 : cc1 - c0]
        c = cls[rr0 - r0 : rr1 - r0, cc0 - c0 : cc1 - c0]
        better = p > self.best_prob[rr0:rr1, cc0:cc1]
        self.best_prob[rr0:rr1, cc0:cc1] = np.where(
            better, p, self.best_prob[rr0:rr1, cc0:cc1])
        self.best_cls[rr0:rr1, cc0:cc1] = np.where(
            better, c, self.best_cls[rr0:rr1, cc0:cc1])

    def finalize(self):
        self.writer.write_band(
            [1, 2], np.stack([self.best_cls, to_uint8_prob(self.best_prob)]))
        _release(self.best_prob)
        _release(self.best_cls)


STITCHERS = {
    "exact-clipping": ExactClipStitcher,
    "average": AverageStitcher,
    "average_weights": AverageWeightsStitcher,
    "max": MaxStitcher,
}


def make_stitcher(method: str, writer: TiffWriter, grid: TileGrid, config: dict):
    if method not in STITCHERS:
        raise ValueError(f"unknown stitching method {method!r}; valid: {list(STITCHERS)}")
    if config["output_type"] == "class_prob":
        # class_prob short-circuits to exact-clipping for EVERY method in the
        # reference (compare.py:68:
        # `if stitch == "exact-clipping" or output_type == "class_prob"`)
        return ExactClipStitcher(writer, grid, config)
    return STITCHERS[method](writer, grid, config)
