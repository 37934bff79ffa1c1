"""Tile gather fused with normalization (``csrc/gather_normalize.cu``).

Replaces what XLA fused on the TPU: ``DeviceZoneRunner._gather``
(``flairtpu/zone/device_engine.py:124-129``) followed by ``normalize_device``
(``flairtpu/data/normalize.py:52-63``). The output is (B, S, S, C): NHWC
bytes that the encoder takes as an NCHW ``channels_last`` view, no copy.

``gather_normalize`` runs the plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor; it has no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flairtpu_torch.data.normalize import normalize, reciprocal, scale_factor
from flairtpu_torch.ops import _build

_MODES = {"scaling": 0, "custom": 1, "without": 2}
MAX_CHANNELS = 16
_FLOATS = ctypes.POINTER(ctypes.c_float)
ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _FLOATS, _FLOATS, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p]

# kernel launches on CUDA tensors since the last reset (the CPU path does not count)
launches = 0


def gather_normalize_plain(zone: torch.Tensor, origins: torch.Tensor, size: int,
                           norm_type: str, means=(), stds=(),
                           out_dtype=torch.float32) -> torch.Tensor:
    """zone (Hp, Wp, C) uint8, origins (B, 2) int32 (row, col) -> (B, S, S, C)."""
    tiles = torch.stack([zone[r:r + size, c:c + size]
                         for r, c in origins.tolist()])
    return normalize(tiles, norm_type, means, stds).to(out_dtype)


def gather_normalize(zone: torch.Tensor, origins: torch.Tensor, size: int,
                     norm_type: str, means=(), stds=(),
                     out_dtype=torch.float32) -> torch.Tensor:
    """CPU tensors: the plain version. CUDA tensors: the kernel, or an error.

    ``origins`` must keep every S x S window inside the zone (the caller pads
    the zone; the kernel does not check)."""
    global launches
    if zone.device.type == "cpu":
        return gather_normalize_plain(zone, origins, size, norm_type, means, stds,
                                      out_dtype)
    if zone.device.type != "cuda":
        raise RuntimeError(f"gather_normalize: unsupported device {zone.device}")
    if zone.dtype != torch.uint8 or zone.dim() != 3 or not zone.is_contiguous():
        raise ValueError("gather_normalize: zone must be a contiguous (Hp, Wp, C) uint8 tensor")
    C = zone.shape[2]
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"gather_normalize: {C} channels (at most {MAX_CHANNELS})")
    if (origins.device != zone.device or origins.dtype != torch.int32
            or origins.dim() != 2 or origins.shape[1] != 2 or not origins.is_contiguous()):
        raise ValueError("gather_normalize: origins must be a contiguous (B, 2) int32 "
                         f"tensor on {zone.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gather_normalize: out_dtype {out_dtype} (float32 or bfloat16)")
    if norm_type not in _MODES or (norm_type == "custom" and
                                   not len(means) == len(stds) == C):
        raise ValueError(f"gather_normalize: bad normalization {norm_type!r} "
                         f"for {C} channels")
    B = origins.shape[0]
    out = torch.empty((B, size, size, C), dtype=out_dtype, device=zone.device)
    mean = np.zeros(C, np.float32)
    inv_std = np.zeros(C, np.float32)
    if norm_type == "custom":
        mean[:] = means
        inv_std[:] = reciprocal(stds)
    err = _build.entry("gather_normalize", ARGTYPES)(
        zone.data_ptr(), zone.shape[1], C, origins.data_ptr(), B, size, _MODES[norm_type],
        mean.ctypes.data_as(_FLOATS), inv_std.ctypes.data_as(_FLOATS),
        float(reciprocal(scale_factor(np.uint8))), out.data_ptr(),
        int(out_dtype == torch.bfloat16), _build.stream_handle(zone))
    _build.check(err, "gather_normalize")
    launches += 1
    return out
