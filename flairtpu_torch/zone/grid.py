"""Tile-grid slicing for zone detection — integer pixel space.

The reference builds its grid in geo coordinates with GeoDataFrame rows
(reference src/zone_detect/slicing_job.py:19-118) and converts back to pixel
windows at read/write time. Pixel-space tile math is exactly equivalent (the
grid is pure arithmetic on the affine transform) and avoids both the GEOS
dependency and float rounding drama; geo bounds are derived on demand from the
transform for export.

Enumeration semantics are kept bit-compatible with ``slice_extent``:

- columns ascend from ``-margin`` in steps of ``stride`` (geo X ascending),
  with the last column realigned to ``W + margin - S``;
- rows are enumerated bottom-up (geo Y ascends from the bottom edge), i.e.
  descending pixel rows from ``H + margin - S`` down, with the last realigned
  to ``-margin``;
- duplicate tiles after realignment are dropped, keeping first occurrence
  (the reference dedups on rounded inner geo bounds, 1:1 with tile origin);
- the default stride is ``size - 2*margin`` so inner regions tile the raster
  exactly (reference test/tiles.py:4-14).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from flairtpu_torch.io.tiff import Affine


def get_stride(config: dict) -> list[int]:
    """Stride law (reference src/zone_detect/test/tiles.py:4-14)."""
    size = config["img_pixels_detection"]
    if not config.get("overlap_strat"):
        return [int(size - 2 * config["margin"])]
    return [int(r * size) for r in config["strategies"]["tiling"]["stride_range"]]


@dataclass
class Tile:
    """One sliding-window tile, all in pixel coordinates of the source raster.

    ``col0/row0`` locate the full patch (size x size, margins included; may be
    negative / exceed the raster: reads are boundless). ``i*`` are the inner
    (margin-stripped, raster-clipped) region the tile is responsible for.
    """

    index: int
    col0: int
    row0: int
    icol0: int
    irow0: int
    icol1: int
    irow1: int


@dataclass
class TileGrid:
    width: int
    height: int
    patch_size: int
    margin: int
    stride: int
    transform: Affine
    crs: int | None
    tiles: list[Tile] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.tiles)

    def tile_origins(self) -> np.ndarray:
        """(N, 2) int32 array of (row0, col0) full-patch origins."""
        return np.array([(t.row0, t.col0) for t in self.tiles], dtype=np.int32)

    def inner_boxes(self) -> np.ndarray:
        """(N, 4) int32 array of (irow0, icol0, irow1, icol1) inner regions."""
        return np.array(
            [(t.irow0, t.icol0, t.irow1, t.icol1) for t in self.tiles], dtype=np.int32
        )

    def geo_bounds(self, tile: Tile) -> tuple[float, float, float, float]:
        """Inner region (left, bottom, right, top) in world coordinates."""
        left, top = self.transform.xy(tile.irow0, tile.icol0)
        right, bottom = self.transform.xy(tile.irow1, tile.icol1)
        return (left, bottom, right, top)

    def to_geojson(self) -> dict:
        """Grid export (stands in for the reference's GPKG slicing-job dump,
        slicing_job.py:110-116; GeoJSON needs no GEOS/OGR)."""
        feats = []
        for t in self.tiles:
            l, b, r, tp = self.geo_bounds(t)
            feats.append(
                {
                    "type": "Feature",
                    "properties": {"id": t.index, "job_done": 0},
                    "geometry": {
                        "type": "Polygon",
                        "coordinates": [[[l, b], [r, b], [r, tp], [l, tp], [l, b]]],
                    },
                }
            )
        out = {"type": "FeatureCollection", "features": feats}
        if self.crs is not None:
            out["crs"] = {"type": "name",
                          "properties": {"name": f"urn:ogc:def:crs:EPSG::{self.crs}"}}
        return out


def _column_starts(extent: int, size: int, margin: int, stride: int) -> list[int]:
    """Ascending starts from -margin, last realigned to extent + margin - size."""
    last = extent + margin - size
    starts = []
    c = -margin
    while c < extent + margin:
        starts.append(min(c, last))
        c += stride
    return starts


def _row_starts(extent: int, size: int, margin: int, stride: int) -> list[int]:
    """Bottom-up enumeration: descending from extent + margin - size, clamped."""
    starts = []
    r = extent + margin - size
    first = extent + margin - size
    k = 0
    while k * stride < extent + 2 * margin:
        starts.append(max(first - k * stride, -margin))
        k += 1
    return starts


def slice_grid(width: int, height: int, patch_size: int, margin: int,
               stride: int | None = None, transform: Affine | None = None,
               crs: int | None = None) -> TileGrid:
    """Build the sliding-window tile grid over a (height, width) raster."""
    if stride is None or stride == 0:
        stride = patch_size - 2 * margin
    if stride <= 0:
        raise ValueError(f"stride must be positive, got {stride}")
    transform = transform or Affine.identity()

    grid = TileGrid(width, height, patch_size, margin, stride, transform, crs)
    seen: set[tuple[int, int]] = set()
    idx = 0
    for col0 in _column_starts(width, patch_size, margin, stride):
        for row0 in _row_starts(height, patch_size, margin, stride):
            key = (col0, row0)
            if key in seen:
                continue
            seen.add(key)
            icol0 = col0 + margin
            irow0 = max(row0 + margin, 0)
            icol1 = min(col0 + patch_size - margin, width)
            irow1 = min(row0 + patch_size - margin, height)
            grid.tiles.append(Tile(idx, col0, row0, icol0, irow0, icol1, irow1))
            idx += 1
    return grid


def slice_pixels(img_size: tuple[int, int], patch_size: int, margin: int,
                 stride: int) -> list[tuple[int, int, int, int]]:
    """Regular inner-patch grid (reference test/pixel_operation.py:1-53).

    Returns sorted (x_min, x_max, y_min, y_max) inner boxes of side
    ``patch_size - 2*margin`` covering the image, with bottom/right edge
    patches realigned inward.
    """
    x_size, y_size = img_size
    inner = patch_size - 2 * margin
    boxes: set[tuple[int, int, int, int]] = set()

    def add(x: int, y: int):
        if x + inner <= x_size and y + inner <= y_size:
            boxes.add((x, x + inner, y, y + inner))

    for y in range(0, y_size + 1, stride):
        for x in range(0, x_size + 1, stride):
            add(x, y)
    if y_size - inner > 0 and (y_size - inner) % stride != 0:
        for x in range(0, x_size - inner + 1, stride):
            add(x, y_size - inner)
    if x_size - inner > 0 and (x_size - inner) % stride != 0:
        for y in range(0, y_size - inner + 1, stride):
            add(x_size - inner, y)
    if (y_size - inner > 0 and (y_size - inner) % stride != 0
            and x_size - inner > 0 and (x_size - inner) % stride != 0):
        add(x_size - inner, y_size - inner)
    return sorted(boxes)
