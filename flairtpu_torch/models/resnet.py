"""ResNet encoders, torchvision topology with smp's key names
(counterpart of ``flairtpu/models/resnet.py:165-297``).

Parameters are float32. Convolutions run in the model's compute dtype
(bfloat16 on the card, float32 on the CPU) and BatchNorm in float32 on the
convolution's output, as ``flairtpu`` does on its accelerator. Tensors are
NCHW in ``channels_last`` memory, so every activation is NHWC in memory.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

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
    """``m`` applied in ``dtype`` (float32 weights cast per call); no bias."""
    return F.conv2d(x.to(dtype), m.weight.to(dtype), None, m.stride, m.padding,
                    m.dilation, m.groups)


def batch_norm(x: torch.Tensor, m: nn.BatchNorm2d) -> torch.Tensor:
    """Inference BatchNorm in float32 on running statistics."""
    return F.batch_norm(x.float(), m.running_mean, m.running_var, m.weight,
                        m.bias, False, 0.0, m.eps)


def bn_scale_shift(m: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 (scale, shift) of an inference BatchNorm, computed
    as flax does: scale = gamma * rsqrt(var + eps), shift = beta - mean * scale."""
    scale = m.weight.float() * torch.rsqrt(m.running_var.float() + m.eps)
    return scale, m.bias.float() - m.running_mean.float() * scale


def bn2d(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


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

    def forward(self, x):
        dt = self.dtype
        y = F.relu(batch_norm(conv(x, self.conv1, dt), self.bn1))
        y = batch_norm(conv(y, self.conv2, dt), self.bn2)
        identity = x
        if self.downsample is not None:
            identity = batch_norm(conv(x, self.downsample[0], dt), self.downsample[1])
        return F.relu(y + identity)


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

    def forward(self, x):
        dt = self.dtype
        y = F.relu(batch_norm(conv(x, self.conv1, dt), self.bn1))
        y = F.relu(batch_norm(conv(y, self.conv2, dt), self.bn2))
        y = batch_norm(conv(y, self.conv3, dt), self.bn3)
        identity = x
        if self.downsample is not None:
            identity = batch_norm(conv(x, self.downsample[0], dt), self.downsample[1])
        return F.relu(y + identity)


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

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = [x]
        y = F.relu(batch_norm(conv(x, self.conv1, self.dtype), self.bn1))
        feats.append(y)
        y = F.max_pool2d(y, 3, 2, 1)
        for i in range(1, 5):
            y = getattr(self, f"layer{i}")(y)
            feats.append(y)
        return feats
