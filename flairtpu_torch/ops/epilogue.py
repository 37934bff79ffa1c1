"""Conv epilogue: an inference BatchNorm as a per-channel (scale, shift), an
optional residual or second BatchNorm'd branch, an optional ReLU, SiLU or
ReLU6 and the casts, in one pass over a convolution's output
(``csrc/conv_epilogue.cu``).

Replaces what XLA fused into each conv's output on the TPU:
``flairtpu/models/resnet.py:177-189`` (BasicBlock), ``:208-222``
(Bottleneck), ``:269-273`` (stem) and ``flairtpu/models/unet.py:71-76``
(decoder block): BatchNorm in float32 on the compute-dtype conv output, the
residual add, the ReLU, and the cast back to the compute dtype for the next
conv. Each site writes the compute-dtype copy, and the float32 value as well
only where a later op reads float32 (``keep_f32``: the identity of a block
without a downsample). The BatchNorm-folded walk (``models/fold.py``) passes
scale 1, the folded bias as shift, and its identity in the compute dtype,
as ``flairtpu``'s folded walk keeps no float32 copies. SiLU (``v *
sigmoid(v)``) is EfficientNet's activation after the stem's and each
expand conv's BatchNorm (``flairtpu/models/efficientnet.py:182, 244-245``),
ReLU6 (``clip(v, 0, 6)``, NaN passing) MobileNetV2's after the stem's, each
expand's, each depthwise's and ``features.18``'s (``flairtpu/models/
tv_encoders.py:111, 115, 143, 165``).
The ``drop`` operand is EfficientNet's drop-connect at a train-mode project
site with an identity (``flairtpu/models/efficientnet.py:202-211``): each
sample's BatchNorm output divided by the keep probability (a multiply by
its float32 reciprocal, :func:`inverse_keep`, in both versions) and
multiplied by its keep mask, before the identity is added.

``conv_epilogue`` runs the plain PyTorch version for a CPU tensor and
launches the kernel for a bfloat16 CUDA tensor; it has no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flairtpu_torch.ops import _build

ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
                                    ctypes.c_longlong, ctypes.c_void_p]

# a site's activation: ReLU (True, as the sites of slices 1-5 pass it), the
# SiLU, the ReLU6, or none (False or None)
ACTIVATIONS = {True: "relu", "relu": "relu", "silu": "silu", "relu6": "relu6", False: None,
               None: None}
# csrc/conv_epilogue.cu's activation codes (bn_train_backward takes them too)
ACT_CODES = {None: 0, "relu": 1, "silu": 2, "relu6": 3}

# kernel launches on CUDA tensors since the last reset (the CPU path does not
# count); silu_launches: those of them with the SiLU, relu6_launches: with
# the ReLU6, drop_launches: with the drop-connect
launches = 0
silu_launches = 0
relu6_launches = 0
drop_launches = 0


def _chw(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def activation(act) -> str | None:
    """``act``'s name in :data:`ACTIVATIONS` ("relu", "silu", "relu6" or
    None), or a ValueError."""
    try:
        return ACTIVATIONS[act]
    except (KeyError, TypeError):
        names = ", ".join(map(repr, ACTIVATIONS))
        raise ValueError(f"an activation is ReLU or SiLU or ReLU6, or none ({names}), got "
                         f"{act!r}") from None


def inverse_keep(keep: float) -> float:
    """1 / ``keep`` rounded to float32 (and exact as a Python float): the
    drop-connect's division, as PyTorch divides a CUDA tensor by a scalar
    (a multiply by the float32 reciprocal)."""
    return float(np.float32(1) / np.float32(keep))


def conv_epilogue_plain(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                        residual: torch.Tensor | None = None, branch=None, act="relu",
                        keep_f32: bool = False, drop=None):
    """y (B, C, H, W) in the compute dtype -> (out in y's dtype, float32 value
    or None): ``y * scale + shift`` in float32, with ``drop`` = (mask, keep)
    then ``* inverse_keep(keep) * mask[b]`` ((B,) float32 mask), ``+ residual`` (float32
    or y's dtype) or
    ``+ d * scale_d + shift_d`` for ``branch = (d, scale_d, shift_d)``, the
    activation ``act`` (:data:`ACTIVATIONS`: ReLU, SiLU ``v * sigmoid(v)``,
    ReLU6 ``clamp(v, 0, 6)``, or none), cast. With a float32 ``y`` both
    outputs are one tensor."""
    act = activation(act)
    v = y.float() * _chw(scale) + _chw(shift)
    if drop is not None:
        mask, keep = drop
        v = v * inverse_keep(keep) * mask[:, None, None, None]
    if branch is not None:
        d, scale_d, shift_d = branch
        v = v + (d.float() * _chw(scale_d) + _chw(shift_d))
    elif residual is not None:
        v = v + residual.float()
    if act == "relu":
        v = torch.relu(v)
    elif act == "silu":
        v = v * torch.sigmoid(v)
    elif act == "relu6":
        v = torch.clamp(v, 0.0, 6.0)
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
                  residual: torch.Tensor | None = None, branch=None, act="relu",
                  keep_f32: bool = False, drop=None):
    """As :func:`conv_epilogue_plain`; every operand channels_last on one
    device. CPU tensors: the plain version. bfloat16 CUDA tensors: the
    kernel, or an error."""
    global launches, silu_launches, relu6_launches, drop_launches
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
    act = activation(act)
    if residual is not None:
        _check_map(residual, y, torch.float32 if residual.dtype == torch.float32 else y.dtype,
                   "residual")
    if branch is not None:
        d, scale_d, shift_d = branch
        _check_map(d, y, y.dtype, "branch")
        _check_vector(scale_d, C, y.device, "branch scale")
        _check_vector(shift_d, C, y.device, "branch shift")
    mask = keep = None
    if drop is not None:
        mask, keep = drop
        if residual is None or residual.dtype != torch.float32 or act is not None:
            raise ValueError("conv_epilogue: the drop-connect takes a float32 residual and no "
                             "activation")
        if (mask.device != y.device or mask.dtype != torch.float32
                or tuple(mask.shape) != (y.shape[0],) or not mask.is_contiguous()
                or not 0 < keep <= 1):
            raise ValueError(f"conv_epilogue: drop = ((B,) float32 mask on {y.device}, keep "
                             f"in (0, 1]), got {tuple(mask.shape)} {mask.dtype}, {keep}")
    if y.device.type == "cpu":
        return conv_epilogue_plain(y, scale, shift, residual, branch, act, keep_f32, drop)
    if y.dtype != torch.bfloat16:
        raise TypeError(f"conv_epilogue: y dtype {y.dtype} (the kernel takes bfloat16)")
    out = torch.empty_like(y)
    out32 = torch.empty_like(y, dtype=torch.float32) if keep_f32 else None
    d, scale_d, shift_d = branch if branch is not None else (None, None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.entry("conv_epilogue", ARGTYPES)(
        ptr(y), ptr(scale), ptr(shift), ptr(residual), ptr(d), ptr(scale_d), ptr(shift_d),
        ptr(out), ptr(out32), y.numel() // C, C, ACT_CODES[act], int(residual is not None and residual.dtype != torch.float32),
        None if mask is None else mask.data_ptr(), 1.0 if keep is None else inverse_keep(keep),
        y.shape[2] * y.shape[3], _build.stream_handle(y))
    _build.check(err, "conv_epilogue")
    launches += 1
    silu_launches += act == "silu"
    relu6_launches += act == "relu6"
    drop_launches += drop is not None
    return out, out32
