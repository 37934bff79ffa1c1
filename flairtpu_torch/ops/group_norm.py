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

In train mode (``stats=True``) the apply pass also writes each (sample,
group)'s float32 mean and rstd, and :func:`group_norm_relu_backward` (three
launches: ``back_reduce``, ``back_apply``, ``back_params``) computes the
VJP: the u x u sum of the output gradient masked by the ReLU (recomputed
from the map and the saved statistics), the per-channel sums of dz and dz *
xh for dbeta and dgamma, the per-group means of dz * gamma and dz * gamma
* xh, then dy = rstd * (dz gamma - mean(dz gamma) - xh mean(dz gamma xh))
in bfloat16. :class:`GroupNormReLU` is the ``autograd.Function`` over the
pair (``ops/bn_train.py:TrainSites.group_norm``, which FPN's
``Conv3x3GNReLU`` takes in train mode); :func:`gn_forward` and
:func:`gn_backward` are its seam, through which a caller may run other
functions of the same signatures.

Each wrapper runs the plain PyTorch version for a CPU tensor and launches
its kernels for a bfloat16 CUDA tensor, or raises; each counts one launch a
call.
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
APPLY_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p]
BACKWARD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
CL = torch.channels_last

# calls that launched the kernels on CUDA tensors since the last reset
launches = 0  # forward
backward_launches = 0


def _per_channel(v: torch.Tensor, C: int) -> torch.Tensor:
    """(B, G) -> (B, C, 1, 1), each group's value on its channels."""
    return v.repeat_interleave(C // v.shape[1], dim=1)[:, :, None, None]


def group_norm_relu_plain(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                          groups: int = GN_GROUPS, eps: float = GN_EPS,
                          upsample: bool = False, stats: bool = False):
    """y (B, C, H, W) -> float32 (B, C, H', W') channels_last: Flax's
    GroupNorm (fast variance) in float32, ReLU, then 2x nearest if
    ``upsample``; with ``stats`` (out, mean, rstd), the (B, groups) float32
    statistics the backward takes."""
    B, C, H, W = y.shape
    x = y.float()
    xg = x.reshape(B, groups, -1)
    mean = xg.mean(dim=2)
    var = torch.clamp(xg.square().mean(dim=2) - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    mul = _per_channel(rstd, C) * gamma.float()[:, None, None]
    out = torch.relu((x - _per_channel(mean, C)) * mul + beta.float()[:, None, None])
    if upsample:
        out = F.interpolate(out, scale_factor=2, mode="nearest")
    out = out.contiguous(memory_format=CL)
    return (out, mean, rstd) if stats else out


def group_norm_relu_backward_plain(g: torch.Tensor, y: torch.Tensor, mean: torch.Tensor,
                                   rstd: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                                   groups: int = GN_GROUPS, upsample: bool = False):
    """The VJP of :func:`group_norm_relu_plain` at y for the float32 output
    gradient g (B, C, H', W'), from the forward's (B, groups) mean and rstd:
    (dy in y's dtype, channels_last; dgamma; dbeta), float32 (C,)."""
    B, C, H, W = y.shape
    x = y.float()
    m, r = _per_channel(mean, C), _per_channel(rstd, C)
    gam = gamma.float()[:, None, None]
    v = (x - m) * (r * gam) + beta.float()[:, None, None]
    g = g.float()
    if upsample:  # nearest 2x: each pixel's 2 x 2 copies
        g = g.reshape(B, C, H, 2, W, 2).sum(dim=(3, 5))
    dz = torch.where(v > 0, g, 0.0)
    xh = (x - m) * r
    dbeta = dz.sum(dim=(0, 2, 3))
    dgamma = (dz * xh).sum(dim=(0, 2, 3))
    dxh = dz * gam
    n = (C // groups) * H * W
    a = dxh.reshape(B, groups, -1).sum(dim=2) / n
    b = (dxh * xh).reshape(B, groups, -1).sum(dim=2) / n
    dy = r * (dxh - _per_channel(a, C) - xh * _per_channel(b, C))
    return dy.to(y.dtype).contiguous(memory_format=CL), dgamma, dbeta


def chunks(hw: int) -> int:
    """Blocks a sample takes in either pass."""
    return -(-hw // PIXELS_PER_BLOCK)


def check_channels(C: int, groups: int) -> None:
    """The kernels take whole 8-channel groups of 16 bytes, a block's 256
    threads an integer number of pixels wide, and whole groups."""
    if C % 8 or THREADS % (C // 8) or C % groups:
        raise ValueError(f"group_norm_relu: {C} channels, {groups} groups (the kernel takes "
                         "C a multiple of 8 dividing 2048, and of the group count)")


def _on_card(name: str, y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             groups: int) -> bool:
    """False for a CPU tensor (the plain version); True for what the kernels
    take on the card; raises on anything else."""
    if y.device.type == "cpu":
        return False
    if y.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {y.device}")
    if y.dtype != torch.bfloat16 or y.dim() != 4:
        raise TypeError(f"{name}: y must be a bfloat16 (B, C, H, W) tensor, got "
                        f"{y.dtype} {tuple(y.shape)}")
    if not y.is_contiguous(memory_format=CL) or y.data_ptr() % 16:
        raise ValueError(f"{name}: y must be channels_last contiguous, 16-byte aligned")
    C = y.shape[1]
    check_channels(C, groups)
    for v, what in ((gamma, "gamma"), (beta, "beta")):
        if (v.device != y.device or v.dtype != torch.float32 or tuple(v.shape) != (C,)
                or not v.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous ({C},) float32 tensor on "
                             f"{y.device}")
    return True


def group_norm_relu(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    groups: int = GN_GROUPS, eps: float = GN_EPS,
                    upsample: bool = False, stats: bool = False):
    """As :func:`group_norm_relu_plain`. CPU tensor: the plain version.
    bfloat16 channels_last CUDA tensor: the kernels, or an error."""
    global launches
    if not _on_card("group_norm_relu", y, gamma, beta, groups):
        return group_norm_relu_plain(y, gamma, beta, groups, eps, upsample, stats)
    B, C, H, W = y.shape
    u = 2 if upsample else 1
    n = chunks(H * W)
    partials = torch.empty((B, n, groups, 2), dtype=torch.float32, device=y.device)
    out = torch.empty((B, C, u * H, u * W), dtype=torch.float32, device=y.device,
                      memory_format=CL)
    saved = torch.empty((2, B, groups), dtype=torch.float32, device=y.device) if stats else None
    stream = _build.stream_handle(y)
    err = _build.entry("group_norm", STATS_ARGTYPES, "group_norm_stats")(
        y.data_ptr(), partials.data_ptr(), B, H * W, C, groups, n, stream)
    _build.check(err, "group_norm_stats")
    err = _build.entry("group_norm", APPLY_ARGTYPES, "group_norm_apply")(
        y.data_ptr(), partials.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        None if saved is None else saved.data_ptr(), B, H, W, C, groups, n, float(eps),
        int(upsample), stream)
    _build.check(err, "group_norm_apply")
    launches += 1
    return (out, saved[0], saved[1]) if stats else out


def group_norm_relu_backward(g: torch.Tensor, y: torch.Tensor, mean: torch.Tensor,
                             rstd: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                             groups: int = GN_GROUPS, upsample: bool = False):
    """As :func:`group_norm_relu_backward_plain`. CPU tensors: the plain
    version. A bfloat16 channels_last y and a float32 channels_last g on the
    card: the kernels, or an error."""
    global backward_launches
    if not _on_card("group_norm_relu_backward", y, gamma, beta, groups):
        return group_norm_relu_backward_plain(g, y, mean, rstd, gamma, beta, groups, upsample)
    B, C, H, W = y.shape
    u = 2 if upsample else 1
    if (g.device != y.device or g.dtype != torch.float32
            or tuple(g.shape) != (B, C, u * H, u * W)
            or not g.is_contiguous(memory_format=CL) or g.data_ptr() % 16):
        raise ValueError(f"group_norm_relu_backward: g must be a channels_last float32 "
                         f"({B}, {C}, {u * H}, {u * W}) tensor on {y.device}, 16-byte aligned")
    for v, what in ((mean, "mean"), (rstd, "rstd")):
        if (v.device != y.device or v.dtype != torch.float32 or tuple(v.shape) != (B, groups)
                or not v.is_contiguous()):
            raise ValueError(f"group_norm_relu_backward: {what} must be a contiguous "
                             f"({B}, {groups}) float32 tensor on {y.device}")
    n = chunks(H * W)
    chan = torch.empty((B, n, C, 2), dtype=torch.float32, device=y.device)
    grp = torch.empty((B, n, groups, 2), dtype=torch.float32, device=y.device)
    dy = torch.empty_like(y)
    dgamma = torch.empty(C, dtype=torch.float32, device=y.device)
    dbeta = torch.empty(C, dtype=torch.float32, device=y.device)
    err = _build.entry("group_norm", BACKWARD_ARGTYPES, "group_norm_backward")(
        y.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(),
        chan.data_ptr(), grp.data_ptr(), dy.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        B, H, W, C, groups, n, int(upsample), _build.stream_handle(y))
    _build.check(err, "group_norm_backward")
    backward_launches += 1
    return dy, dgamma, dbeta


def gn_forward(ctx, forward, y, gamma, beta, groups, eps, upsample):
    """:class:`GroupNormReLU`'s forward through ``forward`` (a function of
    :func:`group_norm_relu`'s signature), saving what :func:`gn_backward`
    needs on ``ctx``."""
    out, mean, rstd = forward(y, gamma, beta, groups, eps, upsample, stats=True)
    ctx.save_for_backward(y, mean, rstd, gamma, beta)
    ctx.groups, ctx.upsample = groups, upsample
    return out


def gn_backward(ctx, backward, g):
    """:class:`GroupNormReLU`'s backward through ``backward`` (a function of
    :func:`group_norm_relu_backward`'s signature)."""
    y, mean, rstd, gamma, beta = ctx.saved_tensors
    dy, dgamma, dbeta = backward(g.contiguous(memory_format=CL), y, mean, rstd, gamma, beta,
                                 ctx.groups, ctx.upsample)
    return dy, dgamma, dbeta, None, None, None


class GroupNormReLU(torch.autograd.Function):
    """One train-mode site: out = 2x nearest (if ``upsample``) of
    ReLU(GroupNorm(y)), float32, through the kernels on the card.

    apply(y, gamma, beta, groups, eps, upsample)."""

    @staticmethod
    def forward(ctx, y, gamma, beta, groups, eps, upsample):
        return gn_forward(ctx, group_norm_relu, y, gamma, beta, groups, eps, upsample)

    @staticmethod
    def backward(ctx, g):
        return gn_backward(ctx, group_norm_relu_backward, g)
