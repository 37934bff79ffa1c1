"""MobileNetV2 encoder, ``mobilenet_v2`` (smp's wrapper of torchvision's
MobileNetV2 at width 1.0), with torchvision's key names (counterpart of
``flairtpu/models/tv_encoders.py:48-185``).

The plan (:func:`mobilenet_v2_plan`) is ``flairtpu``'s, copied: torchvision's
inverted-residual setting, smp's dilation walk at output stride 16 / 8
(stage 4, ``features.7..13``, at rate 2 for output stride 8; stage 5,
``features.14..18``, at rate 2 or 4: strides become 1 and the depthwise 3x3
pads by its rate) and ``skip`` judged on the ORIGINAL stride, as
torchvision sets it before smp rewrites the strides. The pyramid taps
``features.1, 3, 6, 13`` and ``18`` (``_MNV2_TAPS``): strides 2 to 32 at
output stride 32; ``depth`` 3 (PSPNet) stops after ``features.6``, and the
model then has no later features.

An inverted residual (``flairtpu/models/tv_encoders.py:90-119``) at
inference: the 1x1 expand (none in ``features.1``) and its BatchNorm +
ReLU6 (one ``conv_epilogue`` in its ReLU6 mode), the depthwise 3x3 (cuDNN's
grouped conv in the compute dtype, dilated as the plan says) and its
BatchNorm + ReLU6 (one launch), the linear 1x1 project and its BatchNorm,
plus the identity where ``skip`` (one launch, no activation). The stem
(3x3 / 2) and ``features.18`` (1x1 to 1280) take BatchNorm + ReLU6 in one
launch each. BatchNorm eps is 1e-5, torch momentum 0.1 (torchvision's).
Every BatchNorm output is float32 in ``flairtpu``, so a block's output is
float32; the port passes the compute-dtype copy on and writes the float32
value only where the next block adds it as its identity, as
``models/efficientnet.py`` and ``models/resnet.py`` do.

To train (``flairtpu/models/tv_encoders.py:105-119, 141-166`` under
``train=True``), the forward takes ``ops/bn_train.py:TrainSites`` as its
epilogue: the stem, each expand, each depthwise and ``features.18`` are
ReLU6 sites (35 at depth 5), each project a site with no activation and,
where ``skip``, the identity (17).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from flairtpu_torch.models.resnet import bn2d, bn_site, conv, scale_shift
from flairtpu_torch.ops.bn_train import TrainSites
from flairtpu_torch.ops.epilogue import conv_epilogue

# torchvision's inverted_residual_setting: (expand t, channels c, repeats n,
# first stride s)
_MNV2_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                 (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
# smp's stage boundaries over ``features``: taps after indices 1, 3, 6, 13, 18
_MNV2_TAPS = (1, 3, 6, 13, 18)
_MNV2_STAGE4 = range(7, 14)   # dilated at output stride 8
_MNV2_STAGE5 = range(14, 19)  # dilated at output stride 16 (rate 2) / 8 (rate 4)
STEM_CHANNELS, LAST_CHANNELS = 32, 1280
OUT_CHANNELS = (0, 16, 24, 32, 96, LAST_CHANNELS)


def mobilenet_v2_plan(output_stride: int = 32) -> list[dict]:
    """Each inverted residual, ``features.1..17``: index, widths, expand
    ratio, stride and dilation after smp's walk, ``skip``."""
    if output_stride not in (32, 16, 8):
        raise ValueError(f"output_stride {output_stride} not in (32, 16, 8)")
    blocks = []
    i = 1
    cin = STEM_CHANNELS
    for t, c, n, s in _MNV2_SETTING:
        for j in range(n):
            stride = s if j == 0 else 1
            if output_stride == 8 and i in _MNV2_STAGE4:
                dilation, eff_stride = 2, 1
            elif output_stride != 32 and i in _MNV2_STAGE5:
                dilation, eff_stride = (2 if output_stride == 16 else 4), 1
            else:
                dilation, eff_stride = 1, stride
            blocks.append(dict(index=i, cin=cin, cout=c, expand=t,
                               stride=eff_stride, dilation=dilation,
                               # torchvision gates the residual on the
                               # ORIGINAL stride (set before make_dilated
                               # rewrites it)
                               skip=(stride == 1 and cin == c)))
            cin = c
            i += 1
    return blocks


def conv_bn(cin: int, cout: int, k: int = 1, stride: int = 1, dilation: int = 1,
            groups: int = 1) -> nn.Sequential:
    """torchvision's Conv2dNormActivation without its ReLU6 (no parameters):
    ``0`` the conv, ``1`` the BatchNorm."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, (k // 2) * dilation, dilation,
                                   groups=groups, bias=False), bn2d(cout))


def relu6_site(epilogue, pair: nn.Sequential, x: torch.Tensor, dtype) -> torch.Tensor:
    """``pair``'s conv on ``x``, then its BatchNorm + ReLU6: the inference
    epilogue's ReLU6 mode with the BatchNorm's (scale, shift), or in
    training ``TrainSites``. The compute-dtype output."""
    y = conv(x, pair[0], dtype)
    if isinstance(epilogue, TrainSites):
        return epilogue.site(y, pair[1], act="relu6")[0]
    return epilogue(y, *scale_shift(pair[1]), act="relu6")[0]


class InvertedResidual(nn.Module):
    """torchvision's InvertedResidual: ``conv`` = [expand (Conv2d + BN),]
    depthwise (Conv2d + BN), the project Conv2d, its BatchNorm; ``plan``
    one block of :func:`mobilenet_v2_plan`."""

    def __init__(self, plan: dict, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.skip = plan["skip"]
        cin, cout = plan["cin"], plan["cout"]
        mid = cin * plan["expand"]
        layers = [conv_bn(cin, mid)] if plan["expand"] != 1 else []
        layers += [conv_bn(mid, mid, 3, plan["stride"], plan["dilation"], groups=mid),
                   nn.Conv2d(mid, cout, 1, bias=False), bn2d(cout)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x, x32=None, keep_f32=False, epilogue=conv_epilogue):
        """x: the block's input (cast to the compute dtype by each conv);
        x32: its float32 value, the identity of a block with ``skip``.
        Returns (out in the compute dtype, its float32 value if
        ``keep_f32``)."""
        dt = self.dtype
        h = x
        for pair in self.conv[:-2]:
            h = relu6_site(epilogue, pair, h, dt)
        if self.skip and x32 is None:
            raise ValueError("a block with an identity skip needs its input's float32 value")
        return bn_site(epilogue, conv(h, self.conv[-2], dt), self.conv[-1],
                       residual=x32 if self.skip else None, keep_f32=keep_f32, relu=False)


class MobileNetV2Encoder(nn.Module):
    """smp's MobileNetV2Encoder: ``features.0`` the stem (3x3 / 2 conv,
    BatchNorm, ReLU6), ``features.1..17`` the inverted residuals,
    ``features.18`` the 1x1 to 1280 with BatchNorm and ReLU6; returns the
    pyramid [x, f1..f_depth] (strides 1, 2, 4, 8, 16, 32 at output stride
    32, the last ones held at 16 or 8 by dilation). Only the features that
    ``depth`` reaches are built, as ``flairtpu`` builds them."""

    def __init__(self, in_channels: int = 5, dtype=torch.float32, output_stride: int = 32,
                 depth: int = 5):
        super().__init__()
        self.dtype = dtype
        self.output_stride, self.depth = output_stride, depth
        self.taps = frozenset(_MNV2_TAPS[:depth])
        stop = _MNV2_TAPS[depth - 1]
        feats = [conv_bn(in_channels, STEM_CHANNELS, 3, 2)]
        feats += [InvertedResidual(b, dtype) for b in mobilenet_v2_plan(output_stride)
                  if b["index"] <= stop]
        if stop == 18:
            feats.append(conv_bn(_MNV2_SETTING[-1][1], LAST_CHANNELS))
        self.features = nn.ModuleList(feats)
        self.out_channels = OUT_CHANNELS[:depth + 1]

    def forward(self, x: torch.Tensor, epilogue=conv_epilogue) -> list[torch.Tensor]:
        """The pyramid [x, f1..f_depth]; f1.. in the compute dtype."""
        blocks = [m for m in self.features if isinstance(m, InvertedResidual)]
        # float32 is written only where the next block adds it as its identity
        needs_f32 = [b.skip for b in blocks[1:]] + [False]
        feats = [x]
        y = relu6_site(epilogue, self.features[0], x, self.dtype)
        y32 = None
        for i, block in enumerate(blocks, start=1):
            y, y32 = block(y, y32, needs_f32[i - 1], epilogue)
            if i in self.taps:
                feats.append(y)
        if len(self.features) > len(blocks) + 1:
            feats.append(relu6_site(epilogue, self.features[-1], y, self.dtype))
        return feats
