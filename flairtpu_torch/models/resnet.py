"""ResNet and ResNeXt encoders, torchvision topology with smp's key names
(counterpart of ``flairtpu/models/resnet.py:165-297``), with smp's
``output_stride`` (dilated last stages) and ``depth`` (fewer stages). A
ResNeXt is the bottleneck ResNet with a grouped 3x3 (``groups`` groups of
``base_width * 2**stage`` channels).

Parameters are float32. Convolutions run in the model's compute dtype
(bfloat16 on the card, float32 on the CPU) and BatchNorm in float32 on the
convolution's output, as ``flairtpu`` does on its accelerator. Tensors are
NCHW in ``channels_last`` memory, so every activation is NHWC in memory.

Each BatchNorm, with the residual add, the ReLU and the casts that follow
it, is one call of an ``epilogue`` (``ops/epilogue.py:conv_epilogue``, or
its plain version where a caller passes that) through :func:`bn_site`. To
train, a caller passes ``ops/bn_train.py:TrainSites`` instead: each site
then takes its batch statistics and updates the running ones, as Flax's
train-mode BatchNorm. Activations pass between blocks in the compute dtype,
with their float32 value beside them where the next block adds it as its
identity.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from flairtpu_torch.ops.bn_train import TrainSites
from flairtpu_torch.ops.epilogue import conv_epilogue

# block kind, units per stage, groups and width per group (torchvision
# layer specs; flairtpu/models/resnet.py:23-37, the resnext101 ladder smp
# registers)
RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1, 64),
    "resnet34": ("basic", (3, 4, 6, 3), 1, 64),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 1, 64),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 1, 64),
    "resnet152": ("bottleneck", (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 32, 4),
    "resnext101_32x4d": ("bottleneck", (3, 4, 23, 3), 32, 4),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3), 32, 8),
    "resnext101_32x16d": ("bottleneck", (3, 4, 23, 3), 32, 16),
    "resnext101_32x32d": ("bottleneck", (3, 4, 23, 3), 32, 32),
    "resnext101_32x48d": ("bottleneck", (3, 4, 23, 3), 32, 48),
}


def bottleneck_width(features: int, groups: int = 1, base_width: int = 64) -> int:
    """A bottleneck's inner width (``flairtpu/models/resnet.py:207``)."""
    return int(features * base_width / 64) * groups

BN_EPS = 1e-5  # torch nn.BatchNorm2d default, as flairtpu/models/resnet.py:40


def conv(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``m`` applied in ``dtype`` to ``x`` cast to it; no bias. A weight in
    ``dtype`` already (float32 as built on the CPU, or cast once by
    :func:`prepare_inference`) is used as it is; a float32 weight of a model
    that computes in bfloat16 and was not prepared (a model in training, or
    evaluated between epochs) is cast here, inside autograd, so that its
    gradient lands in the float32 parameter. The output is channels_last, as
    the epilogue takes it: a no-op but where an input of 1 x 1 pixels left
    the layout ambiguous and the conv chose NCHW."""
    w = m.weight if m.weight.dtype == dtype else m.weight.to(dtype)
    y = F.conv2d(x.to(dtype), w, None, m.stride, m.padding, m.dilation, m.groups)
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
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.data = m.weight.data.to(dtype)
            elif isinstance(m, nn.BatchNorm2d):
                m.scale_shift = tuple(v.contiguous() for v in bn_scale_shift(m))


def bn2d(ch: int) -> nn.BatchNorm2d:
    """A BatchNorm's parameters and running statistics (smp's key names). Its
    own forward never runs: inference takes its (scale, shift), training
    ``ops/bn_train.py``, whose running variance is Flax's biased one."""
    return nn.BatchNorm2d(ch, eps=BN_EPS)


def bn_site(epilogue, y: torch.Tensor, bn: nn.BatchNorm2d, residual=None, branch=None,
            keep_f32: bool = False, relu: bool = True):
    """One BatchNorm site: ``bn`` on the conv output ``y``, plus ``residual``
    or, for ``branch`` = (d, bn_d), ``bn_d`` on d; ReLU if ``relu``. An
    inference epilogue gets each BatchNorm as its (scale, shift);
    ``TrainSites`` gets the modules. Returns (out, its float32 value if
    ``keep_f32``)."""
    if isinstance(epilogue, TrainSites):
        return epilogue.site(y, bn, residual=residual, branch=branch, act=relu,
                             keep_f32=keep_f32)
    if branch is not None:
        branch = (branch[0], *scale_shift(branch[1]))
    return epilogue(y, *scale_shift(bn), residual=residual, branch=branch, act=relu,
                    keep_f32=keep_f32)


def residual_epilogue(block: nn.Module, y: torch.Tensor, bn: nn.BatchNorm2d, x, x32,
                      keep_f32: bool, epilogue):
    """A block's last site: ``bn`` on its last conv's output ``y``, plus the
    identity (the downsample conv of ``x`` with its BatchNorm, or ``x32``), ReLU."""
    if block.downsample is not None:
        d = conv(x, block.downsample[0], block.dtype)
        return bn_site(epilogue, y, bn, branch=(d, block.downsample[1]), keep_f32=keep_f32)
    if x32 is None:
        raise ValueError("a block without a downsample needs its input's float32 value")
    return bn_site(epilogue, y, bn, residual=x32, keep_f32=keep_f32)


class BasicBlock(nn.Module):
    """3x3-bn-relu-3x3-bn + optional 1x1 downsample, then relu."""

    expansion = 1

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32, dilation: int = 1):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_ch, width, 3, stride, dilation, dilation, bias=False)
        self.bn1 = bn2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, 1, dilation, dilation, bias=False)
        self.bn2 = bn2d(width)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, width, 1, stride, bias=False),
                                         bn2d(width)) if downsample else None)

    def forward(self, x, x32=None, keep_f32=False, epilogue=conv_epilogue):
        """x: the input (cast to the compute dtype by each conv); x32: its
        float32 value, the identity of a block without a downsample. Returns
        (out in the compute dtype, its float32 value if ``keep_f32``)."""
        dt = self.dtype
        y, _ = bn_site(epilogue, conv(x, self.conv1, dt), self.bn1)
        return residual_epilogue(self, conv(y, self.conv2, dt), self.bn2, x, x32, keep_f32,
                                 epilogue)


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 with 4x expansion (torchvision Bottleneck); ResNeXt by
    ``groups`` and ``base_width``: the 3x3 is grouped, its width
    :func:`bottleneck_width`."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32, dilation: int = 1,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        self.dtype = dtype
        out = features * self.expansion
        width = bottleneck_width(features, groups, base_width)
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = bn2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, dilation, dilation, groups=groups,
                               bias=False)
        self.bn2 = bn2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = bn2d(out)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, out, 1, stride, bias=False),
                                         bn2d(out)) if downsample else None)

    def forward(self, x, x32=None, keep_f32=False, epilogue=conv_epilogue):
        """As :meth:`BasicBlock.forward`."""
        dt = self.dtype
        y, _ = bn_site(epilogue, conv(x, self.conv1, dt), self.bn1)
        y, _ = bn_site(epilogue, conv(y, self.conv2, dt), self.bn2)
        return residual_epilogue(self, conv(y, self.conv3, dt), self.bn3, x, x32, keep_f32,
                                 epilogue)


def s2d_input(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2 + 3, W/2 + 3), channels_last: the
    space-to-depth repack of each 2 x 2 block (channels in (row, column,
    channel) order), padded by 2 before and 1 after (``flairtpu/models/
    resnet.py:_s2d`` and ``StemConv``'s padding)."""
    B, C, H, W = x.shape
    y = x.permute(0, 2, 3, 1).reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    y = F.pad(y.reshape(B, H // 2, W // 2, 4 * C), (0, 0, 2, 1, 2, 1))
    return y.permute(0, 3, 1, 2)


def s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """The stem's (O, C, 7, 7) stride-2 pad-3 kernel -> the (O, 4C, 4, 4)
    stride-1 kernel of the same conv on :func:`s2d_input` (one leading zero
    row and column; ``flairtpu/models/resnet.py:_s2d_kernel``)."""
    O, C = w.shape[:2]
    w = F.pad(w, (1, 0, 1, 0)).reshape(O, C, 4, 2, 4, 2)
    return w.permute(0, 3, 5, 1, 2, 4).reshape(O, 4 * C, 4, 4)


def stem_conv(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype, s2d: bool) -> torch.Tensor:
    """The 7 x 7 / 2 stem conv ``m`` as :func:`conv` computes it, or with
    ``s2d`` as a 4 x 4 / 1 conv on the space-to-depth repack
    (``flairtpu``'s ``StemConv(s2d=True)``, ``flairtpu/models/resnet.py:
    137-162``): the same products, summed by cuDNN in another order. The
    parameter stays the 7 x 7 kernel, so a ``.pth`` loads either way."""
    if not s2d:
        return conv(x, m, dtype)
    w = m.weight if m.weight.dtype == dtype else m.weight.to(dtype)
    y = F.conv2d(s2d_input(x.to(dtype)), s2d_kernel(w))
    return y.contiguous(memory_format=torch.channels_last)


# smp get_encoder(output_stride=...): the dilation of each dilated stage
# (0-based); its strides become 1, the downsample conv's too, and each 3x3
# pads by its dilation (smp encoders/_utils.replace_strides_with_dilation)
STAGE_DILATIONS = {32: {}, 16: {3: 2}, 8: {2: 2, 3: 4}}


class ResNetEncoder(nn.Module):
    """Stem + ``depth - 1`` stages; returns the pyramid [x, f1..f_depth]
    (smp's identity stage 0 first): strides 1..32 at ``output_stride`` 32,
    capped at 16 or 8 by dilating the last stages. ``depth`` 3 (PSPNet)
    stops after layer2, and the model then has no layer3 or layer4.
    ``s2d_stem``: the stem conv on the space-to-depth repack
    (:func:`stem_conv`)."""

    def __init__(self, name: str = "resnet34", in_channels: int = 5,
                 dtype=torch.float32, output_stride: int = 32, depth: int = 5,
                 s2d_stem: bool = False):
        super().__init__()
        self.s2d_stem = s2d_stem
        self.output_stride, self.depth = output_stride, depth
        kind, units, groups, base_width = RESNET_SPECS[name]
        block = BasicBlock if kind == "basic" else Bottleneck
        grouping = {} if kind == "basic" else dict(groups=groups, base_width=base_width)
        dilations = STAGE_DILATIONS[output_stride]
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = bn2d(64)
        in_ch = 64
        for stage, n_units in enumerate(units[:depth - 1]):
            width = 64 * 2 ** stage
            dilation = dilations.get(stage, 1)
            stride = 1 if stage == 0 or dilation > 1 else 2
            blocks = []
            for u in range(n_units):
                first = u == 0
                needs_ds = first and (stage > 0 or in_ch != width * block.expansion)
                blocks.append(block(in_ch, width, stride if first else 1,
                                    needs_ds, dtype=dtype, dilation=dilation, **grouping))
                in_ch = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = min(depth - 1, len(units))
        self.out_channels = ((0, 64, 64, 128, 256, 512) if kind == "basic"
                             else (0, 64, 256, 512, 1024, 2048))[:depth + 1]

    def forward(self, x: torch.Tensor, epilogue=conv_epilogue) -> list[torch.Tensor]:
        """The pyramid [x, f1..f_depth]; f1.. in the compute dtype."""
        stages = [getattr(self, f"layer{i}") for i in range(1, self.n_stages + 1)]
        blocks = [(i, b) for i, stage in enumerate(stages) for b in stage]
        # float32 is written only where the next block adds it as its identity
        needs_f32 = [b.downsample is None for _, b in blocks[1:]] + [False]
        feats = [x]
        keep = blocks[0][1].downsample is None
        y, y32 = bn_site(epilogue, stem_conv(x, self.conv1, self.dtype, self.s2d_stem), self.bn1,
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
