"""Tile starts, the distance-decay weight map of ``average_weights``, and
the overlap counts and summed weights of a tiling (own copy of
``flairtpu/zone/weights.py``, numpy).

The tiling law and weight map are the reference's
(src/zone_detect/test/tiles.py:30-51, :54-169): a regular stride grid with
the last tile clamped inward, a Chebyshev distance-to-centre decay, and
the per-pixel count (``patch_overlap``) and weight sum (``total_weights``)
of the tiles that cover a query window.
"""

from __future__ import annotations

import numpy as np


def tile_starts(extent: int, patch_size: int, stride: int) -> np.ndarray:
    """Unique clamped tile starts covering [0, extent) (test/tiles.py:30-51)."""
    max_start = extent - patch_size
    if max_start < 0:
        return np.array([], np.int64)
    starts = np.arange(0, extent, stride)
    starts = np.minimum(starts, max_start)
    return np.unique(starts)


def patch_weights(patch_size: int, sigma: float = 0.5, mode: str = "exp") -> np.ndarray:
    """Distance-to-center decay map (test/tiles.py:97-108, Chebyshev distance)."""
    center = patch_size // 2
    y = np.abs(np.arange(patch_size) - center)
    dist = np.maximum(y[:, None], y[None, :]).astype(np.float64)
    if mode == "gaussian":
        return np.exp(-dist / dist.max() ** 2) / (2 * sigma**2)
    return np.exp(-dist / dist.max() * sigma)


def _accumulate(image_size: tuple[int, int], patch_size: int,
                query_bounds: list[int], stride: int,
                contribution: np.ndarray | None) -> np.ndarray:
    """Shared overlap/total-weight accumulation over intersecting tiles."""
    x_min, x_max, y_min, y_max = query_bounds
    sx, sy = image_size
    dtype = np.float32 if contribution is not None else np.uint8
    out = np.zeros((y_max - y_min, x_max - x_min), dtype)
    for ty in tile_starts(sy, patch_size, stride):
        iy0, iy1 = max(ty, y_min), min(ty + patch_size, y_max)
        if iy1 <= iy0:
            continue
        for tx in tile_starts(sx, patch_size, stride):
            ix0, ix1 = max(tx, x_min), min(tx + patch_size, x_max)
            if ix1 <= ix0:
                continue
            if contribution is None:
                out[iy0 - y_min: iy1 - y_min, ix0 - x_min: ix1 - x_min] += 1
            else:
                out[iy0 - y_min: iy1 - y_min, ix0 - x_min: ix1 - x_min] += (
                    contribution[iy0 - ty: iy1 - ty, ix0 - tx: ix1 - tx])
    return out


def patch_overlap(image_size: tuple[int, int], patch_size: int,
                  query_bounds: list[int], stride: int) -> np.ndarray:
    """Per-pixel count of covering tiles within the query (pixels)."""
    return _accumulate(image_size, patch_size, query_bounds, stride, None)


def total_weights(image_size: tuple[int, int], patch_size: int,
                  query_bounds: list[int], stride: int,
                  sigma: float = 0.5, mode: str = "exp") -> np.ndarray:
    """Summed decay weights of all covering tiles (the average_weights
    divisor). As ``flairtpu``'s, it returns the map alone, where the
    reference returns a (map, steps) tuple and then divides by the tuple
    (SURVEY.md, bug #2)."""
    w = patch_weights(patch_size, sigma=sigma, mode=mode).astype(np.float32)
    return _accumulate(image_size, patch_size, query_bounds, stride, w)
