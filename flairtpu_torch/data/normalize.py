"""Channel normalization (counterpart of ``flairtpu/data/normalize.py:52-63``).

The arithmetic is that of the reference's device form as its jitted zone
program runs it, so the two agree bit for bit in float32: XLA rewrites the
division by a constant into a multiply by the float32 reciprocal, so
``scaling`` is ``x * (1/max)`` and ``custom`` is ``(x - mean) * (1/std)``,
each reciprocal taken in float32.
"""

from __future__ import annotations

import numpy as np
import torch


class NormalizationError(SystemExit):
    pass


def _check(norm_type: str, means, stds):
    if norm_type not in ("scaling", "custom", "without"):
        raise NormalizationError(
            "Normalization argument should be 'scaling', 'custom' or 'without'.")
    if norm_type == "custom" and len(means) != len(stds):
        raise NormalizationError(
            "If custom, provided normalization means and stds should be of same length.")


def scale_factor(dtype) -> float:
    """img_as_float: integer types scale by their max; floats pass through."""
    dt = np.dtype(dtype)
    if dt.kind in "ui":
        return float(np.iinfo(dt).max)
    return 1.0


def reciprocal(v) -> np.ndarray:
    """1/v taken in float32, as XLA folds a division by a constant."""
    return np.float32(1.0) / np.asarray(v, np.float32)


def normalize(img: torch.Tensor, norm_type: str, means=(), stds=(),
              src_dtype=np.uint8) -> torch.Tensor:
    """img: (..., C) channels-last tensor -> float32, static norm parameters."""
    _check(norm_type, means, stds)
    x = img.to(torch.float32)
    if norm_type == "custom":
        mean = torch.tensor(means, dtype=torch.float32, device=x.device)
        return (x - mean) * torch.from_numpy(reciprocal(stds)).to(x.device)
    if norm_type == "scaling":
        return x * float(reciprocal(scale_factor(src_dtype)))
    return x
