"""MAnet decoder, smp 0.3.3 topology and key names (counterpart of
``flairtpu/models/manet.py:43-156``).

- :class:`PABlock` (``center``) on the deepest feature: 1x1 ``top_conv`` and
  ``center_conv`` to 64 channels, a 3x3 ``bottom_conv``, the position map
  softmaxed in float32 over the whole flattened (hw x hw) map (smp's
  ``Softmax(dim=1)`` on ``view(B, -1)``), the attended (B, hw, C) result
  reinterpreted as (B, C, h, w) by ``reshape`` with no transpose (smp's
  quirk: published weights were trained through it), added to the input,
  then a 3x3 ``out_conv``. Every conv has a bias; the two products are
  ``torch.matmul`` in the compute dtype, as ``flairtpu``'s einsums.
- four :class:`MFABBlock`: ``hl_conv`` (3x3, then 1x1 to the skip's width,
  each BatchNorm and ReLU), 2x nearest upsample, two squeeze-excite gates
  (one over the upsampled map, one over the skip) summed in the compute
  dtype before they gate it, the skip concatenated, and the U-Net block's
  two conv3x3 + BN + ReLU (``conv1``, ``conv2``);
- block 4, with no skip, is the plain U-Net block: the zone tail
  (``ops/fused_tail.py``) runs it on the crop of its input.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from flairtpu_torch.models.deeplab import conv_bias, conv_bn, conv_bn_relu, pooled_mean
from flairtpu_torch.models.unet import DEFAULT_DECODER_CHANNELS, DecoderBlock, \
    upsample2x_nearest
from flairtpu_torch.ops.epilogue import conv_epilogue


class PABlock(nn.Module):
    """smp PAB: position attention over the deepest feature map."""

    def __init__(self, in_ch: int, pab_channels: int = 64, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.top_conv = nn.Conv2d(in_ch, pab_channels, 1)
        self.center_conv = nn.Conv2d(in_ch, pab_channels, 1)
        self.bottom_conv = nn.Conv2d(in_ch, in_ch, 3, padding=1)
        self.out_conv = nn.Conv2d(in_ch, in_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        B, C, H, W = x.shape
        hw = H * W

        def flat(m: nn.Conv2d) -> torch.Tensor:
            """The conv's output as the logical (B, hw, channels) tensor."""
            return conv_bias(x, m, dt).permute(0, 2, 3, 1).reshape(B, hw, -1)

        top, center, bottom = flat(self.top_conv), flat(self.center_conv), flat(self.bottom_conv)
        sp = torch.matmul(center, top.transpose(1, 2))
        sp = torch.softmax(sp.reshape(B, hw * hw).float(), dim=-1).reshape(B, hw, hw).to(dt)
        att = torch.matmul(sp, bottom).reshape(B, C, H, W)  # a reinterpretation, as smp's
        return conv_bias(x.to(dt) + att, self.out_conv, dt)


class SqueezeExcite(nn.Sequential):
    """smp's MFAB gate, an nn.Sequential (keys .1 and .3): global mean (in
    float32, then the compute dtype), 1x1 reduce, ReLU, 1x1 expand, sigmoid
    in float32, cast to the compute dtype."""

    def __init__(self, channels: int, reduction: int = 16, dtype=torch.float32):
        reduced = max(1, channels // reduction)
        super().__init__(nn.AdaptiveAvgPool2d(1), nn.Conv2d(channels, reduced, 1), nn.ReLU(),
                         nn.Conv2d(reduced, channels, 1), nn.Sigmoid())
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = torch.relu(conv_bias(pooled_mean(x), self[1], dt))
        return torch.sigmoid(conv_bias(y, self[3], dt).float()).to(dt)


class MFABBlock(DecoderBlock):
    """smp MFAB: ``hl_conv``, 2x upsample, the dual squeeze-excite gate,
    then the U-Net block's body over [gated map, skip]."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, reduction: int = 16,
                 dtype=torch.float32):
        super().__init__(skip_ch, skip_ch, out_ch, dtype=dtype)
        self.hl_conv = nn.Sequential(conv_bn(in_ch, in_ch, 3), conv_bn(in_ch, skip_ch, 1))
        self.SE_ll = SqueezeExcite(skip_ch, reduction, dtype)
        self.SE_hl = SqueezeExcite(skip_ch, reduction, dtype)

    def forward(self, x, skip=None, epilogue=conv_epilogue):
        dt = self.dtype
        y = conv_bn_relu(self.hl_conv[0], x, dt, epilogue)
        y = upsample2x_nearest(conv_bn_relu(self.hl_conv[1], y, dt, epilogue))
        y = y * (self.SE_hl(y) + self.SE_ll(skip))
        return self.convs(y, skip, epilogue)


class MAnetDecoder(nn.Module):
    """smp MAnetDecoder: the PAB ``center``, then an MFAB block a skip and the
    plain block for the last (no skip)."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = DEFAULT_DECODER_CHANNELS,
                 reduction: int = 16, pab_channels: int = 64, dtype=torch.float32):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]
        in_chs = [enc[0]] + list(decoder_channels[:-1])
        skip_chs = enc[1:] + [0]
        self.center = PABlock(enc[0], pab_channels, dtype)
        self.blocks = nn.ModuleList([
            MFABBlock(i, s, o, reduction, dtype) if s > 0 else DecoderBlock(i, 0, o, dtype=dtype)
            for i, s, o in zip(in_chs, skip_chs, decoder_channels)])

    @property
    def last_block(self) -> DecoderBlock:
        return self.blocks[-1]

    def penultimate(self, features: list[torch.Tensor], epilogue=conv_epilogue) -> torch.Tensor:
        """The center and blocks 0-3 on whole tiles: the last block's input."""
        feats = features[1:][::-1]
        x = self.center(feats[0])
        for block, skip in zip(self.blocks[:-1], feats[1:]):
            x = block(x, skip, epilogue)
        return x

    def forward(self, features: list[torch.Tensor], epilogue=conv_epilogue) -> torch.Tensor:
        return self.last_block(self.penultimate(features, epilogue), None, epilogue)
