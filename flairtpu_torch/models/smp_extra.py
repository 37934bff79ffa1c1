"""DeepLabV3, FPN, PSPNet and LinkNet decoders, smp 0.3.3 topology and key
names (counterpart of ``flairtpu/models/smp_extra.py``).

- :class:`DeepLabV3Decoder` (``:233-263``): plain-conv ASPP over the
  output-stride-8 feature, then a 3x3 conv, BatchNorm and ReLU.
- :class:`FPNDecoder` (``:52-105``): 1x1 laterals with top-down 2x nearest
  adds; per level, ``Conv3x3GNReLU`` blocks (3x3 conv, GroupNorm(32), ReLU,
  2x nearest upsample where the block upsamples), all through the
  ``group_norm_relu`` kernel (``ops/group_norm.py``), which writes float32
  as ``flairtpu``'s float32 GroupNorm does; the levels are added in float32.
- :class:`PSPDecoder` (``:108-155``): adaptive average pools (1, 2, 3, 6)
  of the stride-8 feature, each 1x1 conv + BatchNorm + ReLU and resized
  back, concatenated with it, 1x1 fuse to 512.
- :class:`LinknetDecoder` (``:158-230``): per stage 1x1 reduce, a 4x4
  stride-2 transposed conv (torch's ``(I, O, kH, kW)`` weight; its bias
  folded into the next BatchNorm's shift), 1x1 expand, additive skip.

Dropout is the identity at inference; in train mode DeepLabV3's ASPP drops
elements (``Dropout(0.5)``), FPN's merge and PSPNet's fuse whole channels
(``Dropout2d(0.2)``), from the keep mask each forward is given or draws
(``models/deeplab.py:dropout``). FPN's GroupNorm sites train through
``TrainSites.group_norm`` (the ``group_norm_relu`` kernels' autograd
Function); LinkNet's transposed-conv bias is added before its train-mode
BatchNorm (``models/deeplab.py:bn_act``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from flairtpu_torch.models.deeplab import (ASPP, CL, bn_act, cat, conv_bias, conv_bn,
                                           conv_bn_relu, dropout, resize)
from flairtpu_torch.models.resnet import bn2d, conv
from flairtpu_torch.models.unet import upsample2x_nearest
from flairtpu_torch.ops.bn_train import TrainSites
from flairtpu_torch.ops.epilogue import conv_epilogue
from flairtpu_torch.ops.group_norm import GN_EPS, GN_GROUPS, group_norm_relu


class DeepLabV3Decoder(nn.Sequential):
    """smp DeepLabV3Decoder, an nn.Sequential: [ASPP (plain 3x3 atrous
    branches), 3x3 conv, BatchNorm] (keys decoder.0, .1, .2), ReLU."""

    def __init__(self, encoder_channels, out_channels: int = 256, dtype=torch.float32):
        super().__init__(ASPP(encoder_channels[-1], out_channels, separable_conv=False,
                              dtype=dtype),
                         nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
                         bn2d(out_channels))
        self.dtype = dtype

    def forward(self, feats: list[torch.Tensor], epilogue=conv_epilogue,
                keep=None) -> torch.Tensor:
        x = self[0](feats[-1], epilogue, keep)
        return bn_act(epilogue, conv(x, self[1], self.dtype), self[2])


class Conv3x3GNReLU(nn.Module):
    """smp Conv3x3GNReLU: ``block`` = [3x3 conv (no bias), GroupNorm(32)],
    ReLU, then a 2x nearest upsample if ``upsample``."""

    def __init__(self, in_ch: int, out_ch: int, upsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.upsample = upsample
        self.block = nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
                                   nn.GroupNorm(GN_GROUPS, out_ch, eps=GN_EPS))

    def forward(self, x: torch.Tensor, group_norm=group_norm_relu) -> torch.Tensor:
        """x in any float dtype -> float32 (B, C, H', W'), channels_last."""
        gn = self.block[1]
        return group_norm(conv(x, self.block[0], self.dtype), gn.weight, gn.bias,
                          GN_GROUPS, gn.eps, self.upsample)


class FPNBlock(nn.Module):
    """Top-down step: 2x nearest upsample of the coarser level plus the 1x1
    lateral (``skip_conv``, with bias) of the encoder feature."""

    def __init__(self, pyramid_channels: int, skip_channels: int):
        super().__init__()
        self.skip_conv = nn.Conv2d(skip_channels, pyramid_channels, 1)


class SegmentationBlock(nn.Module):
    """``block`` = Conv3x3GNReLU x max(1, n_upsamples), each upsampling
    when n_upsamples > 0."""

    def __init__(self, in_ch: int, out_ch: int, n_upsamples: int = 0, dtype=torch.float32):
        super().__init__()
        blocks = [Conv3x3GNReLU(in_ch, out_ch, bool(n_upsamples), dtype)]
        blocks += [Conv3x3GNReLU(out_ch, out_ch, True, dtype) for _ in range(1, n_upsamples)]
        self.block = nn.Sequential(*blocks)


class FPNDecoder(nn.Module):
    """smp FPNDecoder(pyramid_channels=256, segmentation_channels=128,
    merge_policy='add'); its output is the float32 sum of the four levels at
    stride 4."""

    def __init__(self, encoder_channels, pyramid_channels: int = 256,
                 segmentation_channels: int = 128, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.p5 = nn.Conv2d(encoder_channels[-1], pyramid_channels, 1)
        self.p4 = FPNBlock(pyramid_channels, encoder_channels[-2])
        self.p3 = FPNBlock(pyramid_channels, encoder_channels[-3])
        self.p2 = FPNBlock(pyramid_channels, encoder_channels[-4])
        self.seg_blocks = nn.ModuleList([
            SegmentationBlock(pyramid_channels, segmentation_channels, n, dtype)
            for n in (3, 2, 1, 0)])

    def forward(self, feats: list[torch.Tensor], epilogue=conv_epilogue,
                group_norm=group_norm_relu, keep=None) -> torch.Tensor:
        """``group_norm`` runs the GroupNorm sites at inference (in train
        mode ``epilogue.group_norm``); ``keep``: the Dropout2d's."""
        dt = self.dtype
        if isinstance(epilogue, TrainSites):
            group_norm = epilogue.group_norm
        c2, c3, c4, c5 = feats[-4:]
        pyramid = [conv_bias(c5, self.p5, dt)]
        for block, c in ((self.p4, c4), (self.p3, c3), (self.p2, c2)):
            up = upsample2x_nearest(pyramid[-1]).contiguous(memory_format=CL)
            pyramid.append(up + conv_bias(c, block.skip_conv, dt))
        merged = None
        for seg, p in zip(self.seg_blocks, pyramid):
            x = p
            for block in seg.block:
                x = block(x, group_norm)
            merged = x if merged is None else merged + x
        return dropout(merged, 0.2, keep, channels=True)


class PSPBlock(nn.Module):
    """``pool`` = [AdaptiveAvgPool2d(size), conv_bn] (keys pool.1.0, pool.1.1)."""

    def __init__(self, in_ch: int, out_ch: int, size: int):
        super().__init__()
        self.size = size
        self.pool = nn.Sequential(nn.AdaptiveAvgPool2d(size), conv_bn(in_ch, out_ch))


class PSPModule(nn.Module):
    def __init__(self, in_ch: int, sizes=(1, 2, 3, 6)):
        super().__init__()
        self.blocks = nn.ModuleList([PSPBlock(in_ch, in_ch // len(sizes), s) for s in sizes])


class PSPDecoder(nn.Module):
    """smp PSPDecoder(sizes=(1, 2, 3, 6), out_channels=512) on the
    depth-3 (stride-8) feature."""

    def __init__(self, encoder_channels, out_channels: int = 512, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        in_ch = encoder_channels[-1]
        self.psp = PSPModule(in_ch)
        self.conv = conv_bn(2 * in_ch, out_channels)

    def forward(self, feats: list[torch.Tensor], epilogue=conv_epilogue,
                keep=None) -> torch.Tensor:
        dt = self.dtype
        x = feats[-1]
        x32 = x.float()  # the pools average in float32; each conv rounds once
        branches = []
        for block in self.psp.blocks:
            b = F.adaptive_avg_pool2d(x32, block.size)
            b = conv_bn_relu(block.pool[1], b, dt, epilogue)
            branches.append(resize(b, x.shape[2:]))
        y = conv_bn_relu(self.conv, cat(branches + [x.to(branches[0].dtype)]), dt, epilogue)
        return dropout(y, 0.2, keep, channels=True)


class TransposeX2(nn.Sequential):
    """[ConvTranspose2d(k=4, s=2, p=1) with bias, BatchNorm] (keys .0, .1), ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(nn.ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1),
                         bn2d(out_ch))


class LinknetBlock(nn.Module):
    """smp linknet DecoderBlock: ``block`` = [1x1 conv_bn to in / 4,
    TransposeX2, 1x1 conv_bn to out], ReLU after each, then + skip."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.block = nn.Sequential(conv_bn(in_ch, in_ch // 4), TransposeX2(in_ch // 4, in_ch // 4),
                                   conv_bn(in_ch // 4, out_ch))

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None,
                epilogue=conv_epilogue) -> torch.Tensor:
        dt = self.dtype
        x = conv_bn_relu(self.block[0], x, dt, epilogue)
        t = self.block[1][0]
        y = F.conv_transpose2d(x.to(dt), t.weight.to(dt), None, t.stride, t.padding)
        x = bn_act(epilogue, y.contiguous(memory_format=CL), self.block[1][1], bias=t.bias)
        x = conv_bn_relu(self.block[2], x, dt, epilogue)
        return x if skip is None else x + skip.to(x.dtype)


class LinknetDecoder(nn.Module):
    """smp LinknetDecoder(prefinal_channels=32, n_blocks=5): full resolution."""

    def __init__(self, encoder_channels, prefinal_channels: int = 32, dtype=torch.float32):
        super().__init__()
        chans = list(encoder_channels[1:])[::-1] + [prefinal_channels]
        self.blocks = nn.ModuleList([LinknetBlock(chans[i], chans[i + 1], dtype)
                                     for i in range(len(chans) - 1)])

    def forward(self, feats: list[torch.Tensor], epilogue=conv_epilogue) -> torch.Tensor:
        fs = feats[1:][::-1]
        x, skips = fs[0], fs[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None, epilogue)
        return x
