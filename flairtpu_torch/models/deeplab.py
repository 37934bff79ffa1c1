"""DeepLabV3+ decoder and the pieces the strided-head decoders share, smp
0.3.3 topology and key names (counterpart of ``flairtpu/models/deeplab.py``).

- :func:`align_corners_taps` / :func:`align_corners_weights`: torch's
  ``align_corners=True`` bilinear sampling as two taps a row, or as the
  (n_out, n_in) matrix ``flairtpu`` multiplies by (``deeplab.py:41-53``).
  The head's upsample (``ops/strided_tail.py``) takes these taps.
- :func:`resize`: the decoders' inner bilinear resizes. ``flairtpu``
  multiplies by the dense weight matrices, a TPU choice (its tensor unit
  runs them faster than gathers, ``deeplab.py:56-70``); the port calls
  ``F.interpolate(mode="bilinear", align_corners=True)``, two taps a pixel,
  in the compute dtype.
- :func:`bn_act`: a BatchNorm site through the conv epilogue
  (``ops/epilogue.py``), a conv bias folded into its shift, ReLU or not; in
  train mode through ``ops/bn_train.py:TrainSites``.
- :func:`dropout`: Flax's train-mode ``nn.Dropout`` (elementwise, or one
  value a (sample, channel) for smp's ``Dropout2d``) on a keep mask drawn
  from the trainer's generator or handed in.
- ``SeparableConv`` (depthwise, then pointwise), the ASPP (1x1 branch,
  three atrous branches, separable or plain, and the pooling branch, then
  the 1x1 projection and, in train mode, ``Dropout(0.5)``) and
  :class:`DeepLabV3PlusDecoder`.

Activations are NCHW views of NHWC memory in the compute dtype, as in
``models/resnet.py``; a BatchNorm's output is rounded to the compute dtype
where ``flairtpu`` keeps it float32 until the next convolution casts it
(equal in float32 on the CPU).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from flairtpu_torch.models.resnet import bn2d, bn_site, conv, scale_shift
from flairtpu_torch.ops.bn_train import TrainSites
from flairtpu_torch.ops.epilogue import conv_epilogue

ATROUS_RATES = (12, 24, 36)
OUT_CHANNELS = 256
HIGHRES_CHANNELS = 48
CL = torch.channels_last


@lru_cache(maxsize=64)
def align_corners_taps(n_out: int, n_in: int):
    """Per output index o of an align-corners resize from n_in to n_out:
    (lo, hi) int64 source indices and (w_lo, w_hi) float32 weights, as
    ``flairtpu``'s ``_align_corners_weights`` computes them."""
    o = np.arange(n_out)
    if n_in == 1 or n_out == 1:
        zero = np.zeros(n_out, np.int64)
        return zero, zero, np.ones(n_out, np.float32), np.zeros(n_out, np.float32)
    src = o * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float32)
    return lo, hi, (1.0 - frac).astype(np.float32), frac


@lru_cache(maxsize=64)
def align_corners_weights(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) float32 bilinear matrix with torch align_corners=True
    sampling (``flairtpu/models/deeplab.py:41-53``)."""
    lo, hi, w_lo, w_hi = align_corners_taps(n_out, n_in)
    w = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(w, (rows, lo), w_lo)
    np.add.at(w, (rows, hi), w_hi)
    return w


def resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """torch ``nn.UpsamplingBilinear2d`` / ``interpolate(align_corners=True)``
    of (B, C, H, W) to ``hw``, channels_last."""
    y = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)
    return y.contiguous(memory_format=CL)


def cat(tensors: list[torch.Tensor]) -> torch.Tensor:
    """Channel concatenation, channels_last."""
    return torch.cat(tensors, dim=1).contiguous(memory_format=CL)


def bn_act(epilogue, y: torch.Tensor, bn: nn.BatchNorm2d, relu: bool = True,
           bias: torch.Tensor | None = None, keep_f32: bool = False):
    """BatchNorm ``bn`` on the output ``y`` of a conv whose ``bias`` (if any)
    was left out, then ReLU if ``relu``: one site (``models/resnet.py:
    bn_site``). Inference folds the bias into the shift (scale * bias +
    shift). In train mode (``TrainSites``) the bias is added to ``y`` in its
    dtype, as ``flairtpu``'s conv adds it, and the site normalizes the sum:
    the running mean then includes the bias, as Flax's does, and neither the
    output nor the loss depends on it. Returns the compute-dtype output, or
    with ``keep_f32`` its float32 value."""
    if isinstance(epilogue, TrainSites):
        if bias is not None:
            y = (y + bias.to(y.dtype)[:, None, None]).contiguous(memory_format=CL)
        out, out32 = bn_site(epilogue, y, bn, relu=relu, keep_f32=keep_f32)
        return out32 if keep_f32 else out
    scale, shift = scale_shift(bn)
    if bias is not None:
        shift = shift + scale * bias.float()
    out, out32 = epilogue(y, scale, shift, act=relu, keep_f32=keep_f32)
    return out32 if keep_f32 else out


def conv_bias(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``m`` with its bias, in ``dtype``, channels_last."""
    y = F.conv2d(x.to(dtype), m.weight.to(dtype), m.bias.to(dtype), m.stride, m.padding,
                 m.dilation, m.groups)
    return y.contiguous(memory_format=CL)


def conv_bn(in_ch: int, out_ch: int, kernel: int = 1, dilation: int = 1) -> nn.Sequential:
    """smp's Sequential(conv (no bias), BatchNorm[, ReLU]): keys .0 and .1."""
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, kernel, padding=(kernel // 2) * dilation,
                                   dilation=dilation, bias=False), bn2d(out_ch))


def separable(in_ch: int, out_ch: int, dilation: int = 1) -> nn.Sequential:
    """smp SeparableConv2d: a 3x3 depthwise conv, then a 1x1 pointwise one,
    neither with a bias (keys .0 and .1)."""
    return nn.Sequential(
        nn.Conv2d(in_ch, in_ch, 3, padding=dilation, dilation=dilation, groups=in_ch,
                  bias=False),
        nn.Conv2d(in_ch, out_ch, 1, bias=False))


def conv_bn_relu(seq: nn.Sequential, x: torch.Tensor, dtype, epilogue) -> torch.Tensor:
    """A ``conv_bn`` Sequential, then ReLU."""
    return bn_act(epilogue, conv(x, seq[0], dtype), seq[1])


def sep_bn_relu(sep: nn.Sequential, bn: nn.BatchNorm2d, x: torch.Tensor, dtype,
                epilogue) -> torch.Tensor:
    """A ``separable`` conv, then ``bn`` and ReLU."""
    return bn_act(epilogue, conv(conv(x, sep[0], dtype), sep[1], dtype), bn)


def dropout(x: torch.Tensor, rate: float, keep, channels: bool = False) -> torch.Tensor:
    """Flax's train-mode ``nn.Dropout(rate)`` on x (B, C, H, W): kept values
    divided by 1 - rate, the others zero; with ``channels`` one keep value a
    (sample, channel), as ``broadcast_dims=(1, 2)`` on NHWC (smp's
    ``Dropout2d``). ``keep``: None (eval: the identity), a ``torch.Generator``
    to draw the keep mask from (on its device), or the bool keep mask, (B, C,
    H, W) or with ``channels`` (B, C, 1, 1)."""
    if keep is None:
        return x
    if isinstance(keep, torch.Generator):
        shape = (*x.shape[:2], 1, 1) if channels else x.shape
        keep = torch.rand(shape, generator=keep, device=keep.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).contiguous(memory_format=CL)


def pooled_mean(x: torch.Tensor) -> torch.Tensor:
    """The global average over H, W of a compute-dtype map, summed in
    float32: (B, C, 1, 1) float32 (the next conv rounds it once)."""
    return x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32)


class ASPP(nn.Module):
    """smp ASPP: ``convs`` = [1x1 conv_bn, three atrous branches (separable
    + BatchNorm for DeepLabV3+, plain 3x3 conv_bn for DeepLabV3), the pooling
    branch (AdaptiveAvgPool, conv, BatchNorm)], ``project`` = 1x1 conv_bn
    over the five; ReLU after each, Dropout(0.5) after the project
    (``flairtpu/models/deeplab.py:161``, ``smp_extra.py:260``)."""

    def __init__(self, in_ch: int, out_ch: int = OUT_CHANNELS, separable_conv: bool = True,
                 rates=ATROUS_RATES, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.separable = separable_conv
        branches = [conv_bn(in_ch, out_ch)]
        for rate in rates:
            branches.append(nn.Sequential(separable(in_ch, out_ch, rate), bn2d(out_ch))
                            if separable_conv else conv_bn(in_ch, out_ch, 3, rate))
        branches.append(nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                      nn.Conv2d(in_ch, out_ch, 1, bias=False), bn2d(out_ch)))
        self.convs = nn.ModuleList(branches)
        self.project = conv_bn(len(branches) * out_ch, out_ch)

    def forward(self, x: torch.Tensor, epilogue=conv_epilogue, keep=None) -> torch.Tensor:
        """``keep``: the dropout's (:func:`dropout`; None in eval)."""
        dt = self.dtype
        outs = [conv_bn_relu(self.convs[0], x, dt, epilogue)]
        for branch in self.convs[1:-1]:
            outs.append(sep_bn_relu(branch[0], branch[1], x, dt, epilogue) if self.separable
                        else conv_bn_relu(branch, x, dt, epilogue))
        pool = self.convs[-1]
        p = bn_act(epilogue, conv(pooled_mean(x), pool[1], dt), pool[2])
        outs.append(p.expand(-1, -1, *x.shape[2:]))
        return dropout(conv_bn_relu(self.project, cat(outs), dt, epilogue), 0.5, keep)


class DeepLabV3PlusDecoder(nn.Module):
    """smp DeepLabV3PlusDecoder(out_channels=256, rates=(12, 24, 36)) over an
    output-stride-16 encoder: ``aspp`` = [ASPP, separable 3x3, BatchNorm],
    4x align-corners upsample, ``block1`` (1x1 to 48 on the stride-4
    feature), concatenation, ``block2`` (separable 3x3 + BatchNorm)."""

    def __init__(self, encoder_channels, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.aspp = nn.Sequential(ASPP(encoder_channels[-1], dtype=dtype),
                                  separable(OUT_CHANNELS, OUT_CHANNELS), bn2d(OUT_CHANNELS))
        self.block1 = conv_bn(encoder_channels[-4], HIGHRES_CHANNELS)
        self.block2 = nn.Sequential(separable(OUT_CHANNELS + HIGHRES_CHANNELS, OUT_CHANNELS),
                                    bn2d(OUT_CHANNELS))

    def forward(self, feats: list[torch.Tensor], epilogue=conv_epilogue,
                keep=None) -> torch.Tensor:
        dt = self.dtype
        deep, high = feats[-1], feats[-4]
        x = self.aspp[0](deep, epilogue, keep)
        x = sep_bn_relu(self.aspp[1], self.aspp[2], x, dt, epilogue)
        x = resize(x, (4 * x.shape[2], 4 * x.shape[3]))
        skip = conv_bn_relu(self.block1, high, dt, epilogue)
        return sep_bn_relu(self.block2[0], self.block2[1], cat([x, skip]), dt, epilogue)
