"""PAN decoder, smp 0.3.3 topology and key names (counterpart of
``flairtpu/models/pan.py``).

The encoder runs at output stride 16 (smp's PAN fixes it) and the decoder
at one width (32):

- :class:`FPABlock` on the deepest feature: a global-pool branch (1x1
  ConvBnRelu, broadcast back), a 1x1 ``mid`` branch, and a 1-channel
  pyramid of three 2x2 max-pools (7x7, 5x5, two 3x3 ConvBnRelu) merged
  bottom-up through align-corners resizes; pyramid * mid + pooled;
- three :class:`GAUBlock` up the skips (stride 16 -> 8 -> 4): the
  high-level map's gate (global mean, 1x1 ConvBn without ReLU, sigmoid)
  times the 3x3 ConvBnRelu of the low-level feature, plus the high-level
  map resized.

Every ConvBnRelu conv has a bias, folded into its BatchNorm's shift at
inference and added to the conv output before a train-mode BatchNorm
(``models/deeplab.py:bn_act``); the 1-channel pyramid's BatchNorms train
through ``bn_train``'s narrow entry points. The
FPA's output and the GAUs' are float32, as ``flairtpu``'s; its tiles must
be at least 128 pixels (the pyramid pools the stride-16 map three times),
which ``flair-detect`` checks when it reads its config and ``flair`` at
its first batch (:meth:`PANDecoder.forward`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from flairtpu_torch.models.deeplab import bn_act, pooled_mean, resize
from flairtpu_torch.models.resnet import bn2d, conv
from flairtpu_torch.ops.epilogue import conv_epilogue

MIN_TILE = 128


class ConvBnRelu(nn.Module):
    """smp pan ConvBnRelu: ``conv`` (with bias), ``bn``, optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, padding: int = 0,
                 add_relu: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.add_relu = add_relu
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, padding=padding, bias=True)
        self.bn = bn2d(out_ch)

    def forward(self, x: torch.Tensor, epilogue=conv_epilogue, keep_f32: bool = False):
        return bn_act(epilogue, conv(x, self.conv, self.dtype), self.bn, self.add_relu,
                      bias=self.conv.bias, keep_f32=keep_f32)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(2, 2), floor mode."""
    return F.max_pool2d(x, 2, 2)


class FPABlock(nn.Module):
    """smp FPABlock (bilinear align-corners resizes). Keys: branch1.1,
    mid.0, down1.1, down2.1, down3.1, down3.2, conv2, conv1."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()

        def cbr(i, o, k, pad=0):
            return ConvBnRelu(i, o, k, pad, dtype=dtype)

        self.branch1 = nn.Sequential(nn.AdaptiveAvgPool2d(1), cbr(in_ch, out_ch, 1))
        self.mid = nn.Sequential(cbr(in_ch, out_ch, 1))
        self.down1 = nn.Sequential(nn.MaxPool2d(2, 2), cbr(in_ch, 1, 7, 3))
        self.down2 = nn.Sequential(nn.MaxPool2d(2, 2), cbr(1, 1, 5, 2))
        self.down3 = nn.Sequential(nn.MaxPool2d(2, 2), cbr(1, 1, 3, 1), cbr(1, 1, 3, 1))
        self.conv2 = cbr(1, 1, 5, 2)
        self.conv1 = cbr(1, 1, 7, 3)

    def forward(self, x: torch.Tensor, epilogue=conv_epilogue) -> torch.Tensor:
        """x (B, C, H, W) -> float32 (B, out, H, W)."""
        H, W = x.shape[2:]
        b1 = self.branch1[1](pooled_mean(x), epilogue, keep_f32=True)
        mid = self.mid[0](x, epilogue, keep_f32=True)
        x1 = self.down1[1](max_pool_2x2(x), epilogue, keep_f32=True)
        x2 = self.down2[1](max_pool_2x2(x1), epilogue, keep_f32=True)
        x3 = self.down3[1](max_pool_2x2(x2), epilogue, keep_f32=True)
        x3 = resize(self.down3[2](x3, epilogue, keep_f32=True), (H // 4, W // 4))
        x2 = self.conv2(x2, epilogue, keep_f32=True)
        y = resize(x2 + x3, (H // 2, W // 2))
        y = resize(y + self.conv1(x1, epilogue, keep_f32=True), (H, W))
        return y * mid + b1


class GAUBlock(nn.Module):
    """smp GAUBlock: ``conv1`` = [AdaptiveAvgPool, ConvBn (no ReLU)] then a
    sigmoid (key conv1.1), ``conv2`` = 3x3 ConvBnRelu of the low-level map."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                   ConvBnRelu(out_ch, out_ch, 1, add_relu=False, dtype=dtype))
        self.conv2 = ConvBnRelu(in_ch, out_ch, 3, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor, epilogue=conv_epilogue) -> torch.Tensor:
        """x: the low-level feature; y: the float32 high-level map ->
        float32 (B, out, H, W) at x's size."""
        y_up = resize(y, x.shape[2:])
        x = self.conv2(x, epilogue, keep_f32=True)
        g = torch.sigmoid(self.conv1[1](pooled_mean(y), epilogue, keep_f32=True))
        return y_up + x * g


class PANDecoder(nn.Module):
    """smp PANDecoder(decoder_channels=32) over an output-stride-16 encoder."""

    def __init__(self, encoder_channels, decoder_channels: int = 32, dtype=torch.float32):
        super().__init__()
        self.fpa = FPABlock(encoder_channels[-1], decoder_channels, dtype)
        self.gau3 = GAUBlock(encoder_channels[-2], decoder_channels, dtype)
        self.gau2 = GAUBlock(encoder_channels[-3], decoder_channels, dtype)
        self.gau1 = GAUBlock(encoder_channels[-4], decoder_channels, dtype)

    def forward(self, feats: list[torch.Tensor], epilogue=conv_epilogue) -> torch.Tensor:
        if min(feats[0].shape[-2:]) < MIN_TILE:  # flairtpu fails there with an IndexError
            raise ValueError(f"pan needs patches of at least {MIN_TILE} pixels (got "
                             f"{tuple(feats[0].shape[-2:])}): its FPA pools the stride-16 map "
                             "three times")
        x5 = self.fpa(feats[-1], epilogue)
        x4 = self.gau3(feats[-2], x5, epilogue)
        x3 = self.gau2(feats[-3], x4, epilogue)
        return self.gau1(feats[-4], x3, epilogue)
