"""Activation requantize for the int8 walk (``csrc/quantize_act.cu``).

Replaces the XLA requantize of ``flairtpu/models/quantize.py:223``,
``clip(round(x / sx), -127, 127)`` to int8, where the input of an int8 site
is not the int8 output of the site before it (``ops/int8_conv.py``): the
stem's normalized tile, the max-pooled stem output and the decoder's int8
blocks' ``cat(upsample2x(x), skip)``. In ``flairtpu``'s jitted zone program
``sx`` is a constant, and XLA rewrites ``x / sx`` as ``x * float32(1 / sx)``;
the port computes that form, so that the two agree bit for bit
(``tests/test_torch_quantize.py``). ``round`` is half to even.

``quantize_act`` runs the plain PyTorch version for a CPU tensor and
launches the kernel for a float32 or bfloat16 CUDA tensor; it has no
fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flairtpu_torch.ops import _build

ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]

# kernel launches on CUDA tensors since the last reset (the CPU path does not count)
launches = 0


def inverse_scale(sx: float) -> float:
    """float32(1 / sx), the multiplier XLA puts in place of the division."""
    return float(np.float32(1.0) / np.float32(sx))


def quantize_values(v: torch.Tensor, sx: float) -> torch.Tensor:
    """clip(round(v * float32(1 / sx)), -127, 127) as int8, in float32."""
    t = v.float() * inverse_scale(sx)
    return torch.round(t).clamp_(-127, 127).to(torch.int8)


def padded_channels(c: int) -> int:
    """Channels of the int8 conv's input: c rounded up to 8."""
    return -(-c // 8) * 8


def quantize_act_plain(x: torch.Tensor, sx: float, channels: int | None = None) -> torch.Tensor:
    """x (B, C, H, W) float -> (B, channels, H, W) int8 channels_last, the
    channels past C zero (``channels`` defaults to C)."""
    q = quantize_values(x, sx)
    pad = (channels or x.shape[1]) - x.shape[1]
    if pad:
        q = torch.cat([q, q.new_zeros((q.shape[0], pad, *q.shape[2:]))], dim=1)
    return q.contiguous(memory_format=torch.channels_last)


def quantize_act(x: torch.Tensor, sx: float, channels: int | None = None) -> torch.Tensor:
    """As :func:`quantize_act_plain`; x channels_last. CPU tensors: the plain
    version. float32 or bfloat16 CUDA tensors: the kernel, or an error."""
    global launches
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"quantize_act: unsupported device {x.device}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"quantize_act: x must be a channels_last (B, C, H, W) tensor, "
                         f"got {tuple(x.shape)}")
    B, C, H, W = x.shape
    cp = channels or C
    if cp < C or cp % 8:
        raise ValueError(f"quantize_act: {cp} output channels for {C} (>= C, a multiple of 8)")
    if x.device.type == "cpu":
        return quantize_act_plain(x, sx, channels)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_act: x dtype {x.dtype} (float32 or bfloat16)")
    out = torch.empty((B, cp, H, W), dtype=torch.int8, device=x.device,
                      memory_format=torch.channels_last)
    err = _build.entry("quantize_act", ARGTYPES)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(), B * H * W, C, cp,
        inverse_scale(sx), _build.stream_handle(x))
    _build.check(err, "quantize_act")
    launches += 1
    return out
