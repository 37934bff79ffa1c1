"""U-Net decoder and segmentation head, smp 0.3.3 topology and key names
(counterpart of ``flairtpu/models/unet.py``).

Five decoder blocks (256, 128, 64, 32, 16 channels): 2x nearest upsample,
skip concatenation, two conv3x3 + BN + ReLU. ``UnetDecoder.inner`` decodes
only the margin interior a zone tile keeps (``plan_inner_crops``), which is
bit-identical to full decoding followed by the crop.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from flairtpu_torch.models.resnet import bn2d, conv, scale_shift
from flairtpu_torch.ops.epilogue import conv_epilogue

DEFAULT_DECODER_CHANNELS = (256, 128, 64, 32, 16)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), each pixel repeated 2x2."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def plan_inner_crops(size: int, margin: int, n_blocks: int = 5,
                     conv_halo: int = 3) -> list[dict]:
    """Backward interval plan to decode only the inner (margin-cropped) region.

    Only ``[margin, size-margin)`` of the decoder output is kept, and
    convolutions are local, so each decoder block only needs its output on
    the downstream-needed region plus a halo. Walking the need backward
    through (two 3x3 convs = +2) and (2x nearest upsample = halve indices)
    gives each block a small interior extent; the results are bit-identical
    to full-tile decoding on the needed region (clamped crops coincide with
    physical tile edges, so zero padding matches there too).

    Returns per-block dicts {post: (lo, hi), pre: (lo, hi)}: ``post`` is the
    extent the block computes, in its own output resolution; ``pre`` is the
    crop of the block's pre-upsample input.
    """
    lo, hi = margin - 1, size - margin + 1  # head 3x3 input needed at 1/1
    plans: list[dict] = []
    for i in range(n_blocks - 1, -1, -1):
        extent = size >> (n_blocks - 1 - i)  # block i output resolution
        lo_c, hi_c = max(lo - 2, 0), min(hi + 2, extent)
        pre = (lo_c // 2, -(-hi_c // 2))
        plans.append({"block": i, "post": (lo_c, hi_c), "pre": pre})
        lo, hi = pre
    return list(reversed(plans))


class DecoderBlock(nn.Module):
    """upsample 2x -> concat skip -> (conv3x3 + BN + ReLU) x2."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Sequential(
            nn.Conv2d(in_ch + skip_ch, out_ch, 3, padding=1, bias=False), bn2d(out_ch))
        self.conv2 = nn.Sequential(
            nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False), bn2d(out_ch))

    def forward(self, x, skip=None, epilogue=conv_epilogue):
        return self.convs(upsample2x_nearest(x.to(self.dtype)), skip, epilogue)

    def convs(self, x, skip=None, epilogue=conv_epilogue):
        """The block body after its upsample (x already upsampled); returns
        the compute dtype."""
        dt = self.dtype
        if skip is not None:
            x = torch.cat([x.to(dt), skip.to(dt)], dim=1)
        x, _ = epilogue(conv(x, self.conv1[0], dt), *scale_shift(self.conv1[1]))
        x, _ = epilogue(conv(x, self.conv2[0], dt), *scale_shift(self.conv2[1]))
        return x


class UnetDecoder(nn.Module):
    """Consumes encoder features [input, f1..f5]; block i upsamples and fuses
    skip i (the last block has no skip)."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = DEFAULT_DECODER_CHANNELS,
                 dtype=torch.float32):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]
        in_chs = [enc[0]] + list(decoder_channels[:-1])
        skip_chs = enc[1:] + [0]
        self.blocks = nn.ModuleList(
            [DecoderBlock(i, s, o, dtype=dtype)
             for i, s, o in zip(in_chs, skip_chs, decoder_channels)])

    def forward(self, features: list[torch.Tensor], inner_margin: int | None = None,
                epilogue=conv_epilogue):
        """Full decode, or with ``inner_margin`` the interior decode, which
        returns ``(x, offset)``: x covers [offset, offset + extent)."""
        if inner_margin is not None:
            return self.inner(features, inner_margin, len(self.blocks), epilogue)
        feats = features[1:][::-1]
        x, skips = feats[0], feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None, epilogue)
        return x

    def inner(self, features: list[torch.Tensor], margin: int, n_blocks: int,
              epilogue=conv_epilogue):
        """Blocks [0, n_blocks) of the interior decode; returns (x, offset)."""
        feats = features[1:][::-1]
        x, skips = feats[0], feats[1:]
        size = features[0].shape[-1]  # square tiles
        plans = plan_inner_crops(size, margin, len(self.blocks))
        p0 = plans[0]["pre"]
        x = x[:, :, p0[0]:p0[1], p0[0]:p0[1]]
        off = p0[0]  # x covers [off, off+extent) at its resolution
        for i in range(n_blocks):
            block = self.blocks[i]
            lo, hi = plans[i]["post"]
            x = upsample2x_nearest(x.to(block.dtype))
            x = x[:, :, lo - 2 * off:hi - 2 * off, lo - 2 * off:hi - 2 * off]
            skip = skips[i][:, :, lo:hi, lo:hi] if i < len(skips) else None
            x = block.convs(x, skip, epilogue)
            off = lo
        return x, off


class SegmentationHead(nn.Sequential):
    """3x3 conv to float32 class logits: operands rounded to the compute
    dtype, products summed in float32 (unrounded), then the float32 bias."""

    def __init__(self, in_ch: int, classes: int, dtype=torch.float32):
        super().__init__(nn.Conv2d(in_ch, classes, 3, padding=1))
        self.dtype = dtype

    def forward(self, x):
        c = self[0]
        w = c.weight.to(self.dtype).float()
        return F.conv2d(x.to(self.dtype).float(), w, c.bias.float(), padding=1)
