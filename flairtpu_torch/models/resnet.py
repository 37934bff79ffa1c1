"""ResNet encoders, torchvision topology with smp's key names
(counterpart of ``flairtpu/models/resnet.py:165-297``).

Parameters are float32. Convolutions run in the model's compute dtype
(bfloat16 on the card, float32 on the CPU) and BatchNorm in float32 on the
convolution's output, as ``flairtpu`` does on its accelerator. Tensors are
NCHW in ``channels_last`` memory, so every activation is NHWC in memory.

Each BatchNorm, with the residual add, the ReLU and the casts that follow
it, is one call of an ``epilogue`` (``ops/epilogue.py:conv_epilogue``, or
its plain version where a caller passes that). Activations pass between
blocks in the compute dtype, with their float32 value beside them where the
next block adds it as its identity.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from flairtpu_torch.ops.epilogue import conv_epilogue

# block kind and units per stage (torchvision layer specs)
RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}

BN_EPS = 1e-5  # torch nn.BatchNorm2d default, as flairtpu/models/resnet.py:40


def conv(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``m`` applied in ``dtype`` to ``x`` cast to it; no bias. The weight is
    in ``dtype`` already (float32 as built, or cast by
    :func:`prepare_inference`). The output is channels_last, as the epilogue
    takes it: a no-op but where an input of 1 x 1 pixels left the layout
    ambiguous and the conv chose NCHW."""
    y = F.conv2d(x.to(dtype), m.weight, None, m.stride, m.padding, m.dilation, m.groups)
    return y.contiguous(memory_format=torch.channels_last)


def bn_scale_shift(m: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 (scale, shift) of an inference BatchNorm, computed
    as flax does: scale = gamma * rsqrt(var + eps), shift = beta - mean * scale."""
    scale = m.weight.float() * torch.rsqrt(m.running_var.float() + m.eps)
    return scale, m.bias.float() - m.running_mean.float() * scale


def scale_shift(m: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """``m``'s (scale, shift): the pair :func:`prepare_inference` stored, or
    computed now for a model that was not prepared."""
    pair = getattr(m, "scale_shift", None)
    return pair if pair is not None else bn_scale_shift(m)


def prepare_inference(model: nn.Module, dtype: torch.dtype) -> None:
    """Once, after the weights are loaded and the model is on its device:
    every conv weight cast to the compute ``dtype``, and every BatchNorm's
    (scale, shift) stored on it, so that no call recomputes either."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.data = m.weight.data.to(dtype)
            elif isinstance(m, nn.BatchNorm2d):
                m.scale_shift = tuple(v.contiguous() for v in bn_scale_shift(m))


def bn2d(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


def residual_epilogue(block: nn.Module, y: torch.Tensor, bn: nn.BatchNorm2d, x, x32,
                      keep_f32: bool, epilogue):
    """A block's last site: ``bn`` on its last conv's output ``y``, plus the
    identity (the downsample conv of ``x`` with its BatchNorm, or ``x32``), ReLU."""
    s, t = scale_shift(bn)
    if block.downsample is not None:
        d = conv(x, block.downsample[0], block.dtype)
        return epilogue(y, s, t, branch=(d, *scale_shift(block.downsample[1])),
                        keep_f32=keep_f32)
    if x32 is None:
        raise ValueError("a block without a downsample needs its input's float32 value")
    return epilogue(y, s, t, residual=x32, keep_f32=keep_f32)


class BasicBlock(nn.Module):
    """3x3-bn-relu-3x3-bn + optional 1x1 downsample, then relu."""

    expansion = 1

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_ch, width, 3, stride, 1, bias=False)
        self.bn1 = bn2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = bn2d(width)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, width, 1, stride, bias=False),
                                         bn2d(width)) if downsample else None)

    def forward(self, x, x32=None, keep_f32=False, epilogue=conv_epilogue):
        """x: the input (cast to the compute dtype by each conv); x32: its
        float32 value, the identity of a block without a downsample. Returns
        (out in the compute dtype, its float32 value if ``keep_f32``)."""
        dt = self.dtype
        y, _ = epilogue(conv(x, self.conv1, dt), *scale_shift(self.bn1))
        return residual_epilogue(self, conv(y, self.conv2, dt), self.bn2, x, x32, keep_f32,
                                 epilogue)


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 with 4x expansion (torchvision Bottleneck, groups 1)."""

    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        out = width * self.expansion
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = bn2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = bn2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = bn2d(out)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, out, 1, stride, bias=False),
                                         bn2d(out)) if downsample else None)

    def forward(self, x, x32=None, keep_f32=False, epilogue=conv_epilogue):
        """As :meth:`BasicBlock.forward`."""
        dt = self.dtype
        y, _ = epilogue(conv(x, self.conv1, dt), *scale_shift(self.bn1))
        y, _ = epilogue(conv(y, self.conv2, dt), *scale_shift(self.bn2))
        return residual_epilogue(self, conv(y, self.conv3, dt), self.bn3, x, x32, keep_f32,
                                 epilogue)


class ResNetEncoder(nn.Module):
    """Stem + 4 stages; returns the 6 U-Net pyramid levels [x, f1..f5] at
    strides 1..32 (smp's identity stage 0 first)."""

    def __init__(self, name: str = "resnet34", in_channels: int = 5,
                 dtype=torch.float32):
        super().__init__()
        kind, units = RESNET_SPECS[name]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = bn2d(64)
        in_ch = 64
        for stage, n_units in enumerate(units):
            width = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for u in range(n_units):
                first = u == 0
                needs_ds = first and (stride != 1 or in_ch != width * block.expansion)
                blocks.append(block(in_ch, width, stride if first else 1,
                                    needs_ds, dtype=dtype))
                in_ch = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_channels = ((0, 64, 64, 128, 256, 512) if kind == "basic"
                             else (0, 64, 256, 512, 1024, 2048))

    def forward(self, x: torch.Tensor, epilogue=conv_epilogue) -> list[torch.Tensor]:
        """The pyramid [x, f1..f5]; f1..f5 in the compute dtype."""
        stages = [getattr(self, f"layer{i}") for i in range(1, 5)]
        blocks = [(i, b) for i, stage in enumerate(stages) for b in stage]
        # float32 is written only where the next block adds it as its identity
        needs_f32 = [b.downsample is None for _, b in blocks[1:]] + [False]
        feats = [x]
        keep = blocks[0][1].downsample is None
        y, y32 = epilogue(conv(x, self.conv1, self.dtype), *scale_shift(self.bn1),
                          keep_f32=keep)
        feats.append(y)
        # with no float32 identity to keep, the compute-dtype copy is pooled:
        # max commutes with the monotone bf16 rounding, so the value is the same
        x32 = F.max_pool2d(y32, 3, 2, 1) if keep else None
        x = x32 if keep else F.max_pool2d(y, 3, 2, 1)
        for k, (i, block) in enumerate(blocks):
            x, x32 = block(x, x32, needs_f32[k], epilogue)
            if k + 1 == len(blocks) or blocks[k + 1][0] != i:
                feats.append(x)
        return feats
