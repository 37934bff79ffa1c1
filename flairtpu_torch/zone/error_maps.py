"""Error-rate heat maps per stitching method (counterpart of
``flairtpu/zone/error_maps.py``; reference src/zone_detect/test/
metrics.py:290-443, ``error_rate_patch`` / ``error_rate_loop``).

The per-pixel disagreement between a prediction raster and the truth,
averaged per method over zones, smoothed with a gaussian kernel and drawn
as plasma-colormap PNGs. The maps are numpy; only the drawing needs
matplotlib, imported where it draws (it is not installed beside the card:
there the subcommand raises its ``ImportError`` after the maps).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from flairtpu_torch.io import TiffReader
from flairtpu_torch.zone.naming import info_extract


def error_rate_patch(pred: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Binary disagreement map (1.0 where pred != truth)."""
    if pred.shape != truth.shape:
        raise ValueError(f"shape mismatch {pred.shape} vs {truth.shape}")
    return (pred != truth).astype(np.float32)


def gaussian_smooth(img: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """Separable gaussian blur, reflect-padded (scipy-free)."""
    radius = max(int(3 * sigma), 1)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(img, ((radius, radius), (0, 0)), mode="reflect")
    out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 0, pad)
    pad = np.pad(out, ((0, 0), (radius, radius)), mode="reflect")
    return np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 1, pad)


def save_heatmap_png(err: np.ndarray, out_png: Path, title: str = "") -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    im = ax.imshow(err, cmap="plasma", vmin=0.0, vmax=max(float(err.max()), 1e-6))
    ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)


def method_error_maps(truth_dir: Path, pred_dir: Path, sigma: float = 2.0) -> dict:
    """{method: smoothed mean disagreement map} over the ``*-ARGMAX-S_*.tif``
    rasters under ``pred_dir`` (timestamped compare outputs), each held
    against ``truth_dir/<zone>/*.tif`` (1-based classes on disk)."""
    by_method: dict[str, list[np.ndarray]] = {}
    for pred_path in sorted(Path(pred_dir).rglob("*-ARGMAX-S_*.tif")):
        info = info_extract(pred_path)
        zone = info["zone"]
        truth_path = next((Path(truth_dir) / zone).glob("*.tif"), None)
        if truth_path is None:
            print(f"No ground truth found for zone: {zone}")
            continue
        with TiffReader(pred_path) as r:
            pred = r.read(1)
        with TiffReader(truth_path) as r:
            truth = r.read(1).astype(np.int64) - 1
        if pred.shape != truth.shape:
            print(f"skipping {pred_path.name}: shape mismatch")
            continue
        by_method.setdefault(info["method"], []).append(
            error_rate_patch(pred.astype(np.int64), truth))
    return {method: gaussian_smooth(np.mean(maps, axis=0), sigma=sigma)
            for method, maps in sorted(by_method.items())}


def error_rate_loop(truth_dir: Path, out_dir: Path, pred_dir: Path,
                    sigma: float = 2.0) -> dict[str, Path]:
    """:func:`method_error_maps`, each written to ``error-rate_<method>.png``
    under ``out_dir``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    outputs: dict[str, Path] = {}
    for method, smooth in method_error_maps(truth_dir, pred_dir, sigma).items():
        png = out_dir / f"error-rate_{method}.png"
        save_heatmap_png(smooth, png, title=method)
        outputs[method] = png
    return outputs
