"""GroupNorm + ReLU + the optional 2x nearest upsample of FPN's
``Conv3x3GNReLU`` sites, in two passes over the conv output
(``csrc/group_norm.cu``).

Replaces what XLA fused on the TPU at ``flairtpu/models/smp_extra.py:52-68``
(called at ``:95-100``, seven sites a forward): ``nn.GroupNorm(32,
epsilon=1e-5, dtype=float32)`` on the bf16 conv output, ``nn.relu`` and
``upsample2x_nearest``. The statistics follow Flax, not torch: per sample
and group, in float32, with Flax's fast variance (``use_fast_variance``):
``var = max(0, E[x^2] - E[x]^2)``; then ``(x - mean) * (rsqrt(var + eps) *
gamma) + beta``, ReLU. The output is float32, as ``flairtpu``'s GroupNorm
computes in float32, and FPN adds its levels in float32.

Pass 1 (``group_norm_stats``) sums x and x^2 of each group over a chunk of
pixels a block, in a fixed order, into (B, chunks, G, 2) partials. Pass 2
(``group_norm_apply``) adds each group's partials in chunk order, then
normalizes and writes each pixel, or its 2 x 2 copies.

``group_norm_relu`` runs the plain PyTorch version for a CPU tensor and
launches the two kernels for a bfloat16 CUDA tensor, or raises; it counts
one launch a call.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from flairtpu_torch.ops import _build

GN_GROUPS = 32
GN_EPS = 1e-5  # torch nn.GroupNorm's default (flax's is 1e-6), as flairtpu sets it
PIXELS_PER_BLOCK = 512  # the pixels one block of either pass covers
THREADS = 256
STATS_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]
APPLY_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p]

# calls that launched the kernels on CUDA tensors since the last reset
launches = 0


def group_norm_relu_plain(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                          groups: int = GN_GROUPS, eps: float = GN_EPS,
                          upsample: bool = False) -> torch.Tensor:
    """y (B, C, H, W) -> float32 (B, C, H', W') channels_last: Flax's
    GroupNorm (fast variance) in float32, ReLU, then 2x nearest if
    ``upsample``."""
    B, C, H, W = y.shape
    x = y.float()
    xg = x.reshape(B, groups, -1)
    mean = xg.mean(dim=2)
    var = torch.clamp(xg.square().mean(dim=2) - mean.square(), min=0.0)
    mul = torch.rsqrt(var + eps).repeat_interleave(C // groups, dim=1) * gamma.float()
    mean = mean.repeat_interleave(C // groups, dim=1)
    out = torch.relu((x - mean[:, :, None, None]) * mul[:, :, None, None]
                     + beta.float()[:, None, None])
    if upsample:
        out = F.interpolate(out, scale_factor=2, mode="nearest")
    return out.contiguous(memory_format=torch.channels_last)


def chunks(hw: int) -> int:
    """Blocks a sample takes in either pass."""
    return -(-hw // PIXELS_PER_BLOCK)


def check_channels(C: int, groups: int) -> None:
    """The kernels take whole 8-channel groups of 16 bytes, a block's 256
    threads an integer number of pixels wide, and whole groups."""
    if C % 8 or THREADS % (C // 8) or C % groups:
        raise ValueError(f"group_norm_relu: {C} channels, {groups} groups (the kernel takes "
                         "C a multiple of 8 dividing 2048, and of the group count)")


def group_norm_relu(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    groups: int = GN_GROUPS, eps: float = GN_EPS,
                    upsample: bool = False) -> torch.Tensor:
    """As :func:`group_norm_relu_plain`. CPU tensor: the plain version.
    bfloat16 channels_last CUDA tensor: the kernels, or an error."""
    global launches
    if y.device.type == "cpu":
        return group_norm_relu_plain(y, gamma, beta, groups, eps, upsample)
    if y.device.type != "cuda":
        raise RuntimeError(f"group_norm_relu: unsupported device {y.device}")
    if y.dtype != torch.bfloat16 or y.dim() != 4:
        raise TypeError(f"group_norm_relu: y must be a bfloat16 (B, C, H, W) tensor, got "
                        f"{y.dtype} {tuple(y.shape)}")
    if not y.is_contiguous(memory_format=torch.channels_last) or y.data_ptr() % 16:
        raise ValueError("group_norm_relu: y must be channels_last contiguous, 16-byte aligned")
    B, C, H, W = y.shape
    check_channels(C, groups)
    for v, what in ((gamma, "gamma"), (beta, "beta")):
        if (v.device != y.device or v.dtype != torch.float32 or tuple(v.shape) != (C,)
                or not v.is_contiguous()):
            raise ValueError(f"group_norm_relu: {what} must be a contiguous ({C},) float32 "
                             f"tensor on {y.device}")
    u = 2 if upsample else 1
    n = chunks(H * W)
    partials = torch.empty((B, n, groups, 2), dtype=torch.float32, device=y.device)
    out = torch.empty((B, C, u * H, u * W), dtype=torch.float32, device=y.device,
                      memory_format=torch.channels_last)
    stream = _build.stream_handle(y)
    err = _build.entry("group_norm", STATS_ARGTYPES, "group_norm_stats")(
        y.data_ptr(), partials.data_ptr(), B, H * W, C, groups, n, stream)
    _build.check(err, "group_norm_stats")
    err = _build.entry("group_norm", APPLY_ARGTYPES, "group_norm_apply")(
        y.data_ptr(), partials.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        B, H, W, C, groups, n, float(eps), int(upsample), stream)
    _build.check(err, "group_norm_apply")
    launches += 1
    return out
