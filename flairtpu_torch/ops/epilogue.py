"""Conv epilogue: an inference BatchNorm as a per-channel (scale, shift), an
optional residual or second BatchNorm'd branch, an optional ReLU and the
casts, in one pass over a convolution's output (``csrc/conv_epilogue.cu``).

Replaces what XLA fused into each conv's output on the TPU:
``flairtpu/models/resnet.py:177-189`` (BasicBlock), ``:208-222``
(Bottleneck), ``:269-273`` (stem) and ``flairtpu/models/unet.py:71-76``
(decoder block): BatchNorm in float32 on the compute-dtype conv output, the
residual add, the ReLU, and the cast back to the compute dtype for the next
conv. Each site writes the compute-dtype copy, and the float32 value as well
only where a later op reads float32 (``keep_f32``: the identity of a block
without a downsample).

``conv_epilogue`` runs the plain PyTorch version for a CPU tensor and
launches the kernel for a bfloat16 CUDA tensor; it has no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from flairtpu_torch.ops import _build

ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]

# kernel launches on CUDA tensors since the last reset (the CPU path does not count)
launches = 0


def _chw(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def conv_epilogue_plain(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                        residual: torch.Tensor | None = None, branch=None, relu: bool = True,
                        keep_f32: bool = False):
    """y (B, C, H, W) in the compute dtype -> (out in y's dtype, float32 value
    or None): ``y * scale + shift`` in float32, ``+ residual`` (float32) or
    ``+ d * scale_d + shift_d`` for ``branch = (d, scale_d, shift_d)``, ReLU,
    cast. With a float32 ``y`` both outputs are one tensor."""
    v = y.float() * _chw(scale) + _chw(shift)
    if branch is not None:
        d, scale_d, shift_d = branch
        v = v + (d.float() * _chw(scale_d) + _chw(shift_d))
    elif residual is not None:
        v = v + residual
    if relu:
        v = torch.relu(v)
    return v.to(y.dtype), (v if keep_f32 else None)


def _check_vector(v: torch.Tensor, C: int, device: torch.device, what: str) -> None:
    if (v.device != device or v.dtype != torch.float32 or v.dim() != 1 or v.shape[0] != C
            or not v.is_contiguous()):
        raise ValueError(f"conv_epilogue: {what} must be a contiguous ({C},) float32 "
                         f"tensor on {device}")


def _check_map(t: torch.Tensor, y: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if (t.device != y.device or t.dtype != dtype or t.shape != y.shape
            or not t.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"conv_epilogue: {what} must be a channels_last {dtype} tensor of "
                         f"shape {tuple(y.shape)} on {y.device}")


def conv_epilogue(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  residual: torch.Tensor | None = None, branch=None, relu: bool = True,
                  keep_f32: bool = False):
    """As :func:`conv_epilogue_plain`; every operand channels_last on one
    device. CPU tensors: the plain version. bfloat16 CUDA tensors: the
    kernel, or an error."""
    global launches
    if y.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"conv_epilogue: unsupported device {y.device}")
    if y.dim() != 4 or not y.dtype.is_floating_point:
        raise ValueError(f"conv_epilogue: y must be a floating (B, C, H, W) tensor, "
                         f"got {y.dtype} {tuple(y.shape)}")
    _check_map(y, y, y.dtype, "y")
    C = y.shape[1]
    _check_vector(scale, C, y.device, "scale")
    _check_vector(shift, C, y.device, "shift")
    if residual is not None and branch is not None:
        raise ValueError("conv_epilogue: a residual or a branch, not both")
    if residual is not None:
        _check_map(residual, y, torch.float32, "residual")
    if branch is not None:
        d, scale_d, shift_d = branch
        _check_map(d, y, y.dtype, "branch")
        _check_vector(scale_d, C, y.device, "branch scale")
        _check_vector(shift_d, C, y.device, "branch shift")
    if y.device.type == "cpu":
        return conv_epilogue_plain(y, scale, shift, residual, branch, relu, keep_f32)
    if y.dtype != torch.bfloat16:
        raise TypeError(f"conv_epilogue: y dtype {y.dtype} (the kernel takes bfloat16)")
    out = torch.empty_like(y)
    out32 = torch.empty_like(y, dtype=torch.float32) if keep_f32 else None
    d, scale_d, shift_d = branch if branch is not None else (None, None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.entry("conv_epilogue", ARGTYPES)(
        ptr(y), ptr(scale), ptr(shift), ptr(residual), ptr(d), ptr(scale_d), ptr(shift_d),
        ptr(out), ptr(out32), y.numel() // C, C, int(relu), _build.stream_handle(y))
    _build.check(err, "conv_epilogue")
    launches += 1
    return out, out32
