"""Tile starts and the distance-decay weight map of ``average_weights``
(own copy of ``flairtpu/zone/weights.py:14-31``, numpy).

The tiling law and weight map are the reference's
(src/zone_detect/test/tiles.py:30-51, :97-108): a regular stride grid with
the last tile clamped inward, and a Chebyshev distance-to-centre decay.
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
