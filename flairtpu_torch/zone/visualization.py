"""Tile-grid and weight-map drawings (counterpart of
``flairtpu/zone/visualization.py``; reference src/zone_detect/test/
visualization.py): ``viz_slicing`` (:10-56) draws the sliding-window
rectangles over the raster extent, ``visualize_weights`` the per-tile decay
map beside the accumulated weight map (the reference's keyboard stepper
becomes a static two-panel figure). The maps are
``zone/weights.py``'s numpy; matplotlib is imported where it draws.
"""

from __future__ import annotations

from pathlib import Path

from flairtpu_torch.zone.grid import TileGrid
from flairtpu_torch.zone.weights import patch_weights, total_weights


def viz_slicing(grid: TileGrid, out_png: str | Path | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    fig, ax = plt.subplots(figsize=(10, 10 * grid.height / max(grid.width, 1)))
    ax.add_patch(Rectangle((0, 0), grid.width, grid.height,
                           fill=False, edgecolor="black", linewidth=2))
    for t in grid.tiles:
        ax.add_patch(Rectangle((t.col0, t.row0), grid.patch_size, grid.patch_size,
                               fill=False, edgecolor="tab:blue", alpha=0.5))
        ax.add_patch(Rectangle((t.icol0, t.irow0), t.icol1 - t.icol0,
                               t.irow1 - t.irow0, fill=False,
                               edgecolor="tab:red", alpha=0.7, linestyle="--"))
    ax.set_xlim(-grid.margin - 5, grid.width + grid.margin + 5)
    ax.set_ylim(grid.height + grid.margin + 5, -grid.margin - 5)
    ax.set_title(f"{len(grid)} tiles  size={grid.patch_size} "
                 f"margin={grid.margin} stride={grid.stride}")
    if out_png:
        fig.savefig(out_png, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig


def weight_maps(patch_size: int, stride: int, extent: int | None = None):
    """(the per-tile decay map, the accumulated weights over an ``extent``
    square, 3 tiles wide by default): what :func:`visualize_weights` draws."""
    extent = extent or 3 * patch_size
    return (patch_weights(patch_size),
            total_weights((extent, extent), patch_size, [0, extent, 0, extent], stride))


def visualize_weights(patch_size: int, stride: int, extent: int | None = None,
                      out_png: str | Path | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    w, tw = weight_maps(patch_size, stride, extent)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    im0 = axes[0].imshow(w, cmap="viridis")
    axes[0].set_title("per-tile decay weights")
    fig.colorbar(im0, ax=axes[0], shrink=0.8)
    im1 = axes[1].imshow(tw, cmap="viridis")
    axes[1].set_title(f"accumulated weights (stride={stride})")
    fig.colorbar(im1, ax=axes[1], shrink=0.8)
    if out_png:
        fig.savefig(out_png, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig
