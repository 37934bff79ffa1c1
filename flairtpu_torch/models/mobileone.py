"""MobileOne encoders, ``mobileone_s0`` .. ``_s4`` (smp's vendored copy of
Apple's MobileOne in its unfused training form), with smp's key names
(counterpart of ``flairtpu/models/mobileone.py:42-175``).

The plan (:func:`mobileone_plan`) is ``flairtpu``'s, copied: ``stage0`` one
3x3 / 2 block from the input to min(64, 64 w0) channels with one k x k
branch in every variant; stages 1-4 pairs of a depthwise 3x3 block and a
pointwise 1x1 block, the first pair strided 2, widths int((64, 128, 256,
512) w); s0 four conv branches a block, s1-s4 one; s4 squeeze-excite on
the last 5 pairs of stage 3 and on stage 4. smp's dilation at output
stride 16 (stage 4 at rate 2) and 8 (stage 3 at 2, stage 4 at 4): strides
become 1, the k x k branches dilate, the 1x1 scale branch does not, and a
depthwise block's skip keeps the ORIGINAL stride's rule, so a dilated
first block has none. The taps are stage0 and each stage; ``depth`` d
builds stage0 and stages 1..d-1.

A block (``flairtpu/models/mobileone.py:77-112``) at inference: each
branch's conv in the compute dtype (cuDNN, channels_last; grouped for a
depthwise block, dilated as the plan says), then one ``branch_sum`` launch
(``ops/branch_sum.py``): the branches' BatchNorms, the k x k ones, then the
1x1 scale branch, then the skip (a bare BatchNorm of the block's float32
input), summed in float32 in that order, then the ReLU; at a
squeeze-excite block the float32 sum goes through the squeeze, the gate
(its biased reduce conv, ReLU, biased expand conv, width int(C / 16)) and
the excite in place of the ReLU. BatchNorm eps is 1e-5, torch momentum 0.1
(``flairtpu/models/resnet.py:40-41``). Every BatchNorm output is float32
in ``flairtpu``, so a block's output is float32; the port passes the
compute-dtype copy to the next block's convs and writes the float32 value
only where the next block reads it as its skip.

Training is not ported (``config.py`` refuses it); ``bn_fold`` and int8
raise ``flairtpu``'s ``ValueError`` for the family.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from flairtpu_torch.models.resnet import bn2d, conv, scale_shift
from flairtpu_torch.ops.branch_sum import block_epilogue

# name -> (width multipliers, conv branches a block, squeeze-excite)
MOBILEONE_SPECS = {
    "mobileone_s0": ((0.75, 1.0, 1.0, 2.0), 4, False),
    "mobileone_s1": ((1.5, 1.5, 2.0, 2.5), 1, False),
    "mobileone_s2": ((1.5, 2.0, 2.5, 4.0), 1, False),
    "mobileone_s3": ((2.0, 2.5, 3.0, 4.0), 1, False),
    "mobileone_s4": ((3.0, 3.5, 3.5, 4.0), 1, True),
}
_BASE_PLANES = (64, 128, 256, 512)
_NUM_BLOCKS = (2, 8, 10, 1)
SE_RATIO = 0.0625  # Apple's SEBlock rd_ratio
# smp's make_dilated: (stage 3's rate, stage 4's) by output stride
DILATIONS = {32: (1, 1), 16: (1, 2), 8: (2, 4)}


def mobileone_out_channels(name: str) -> tuple[int, ...]:
    """smp's pyramid widths: the input's 3, stage0's, stages 1-4's."""
    w, _, _ = MOBILEONE_SPECS[name]
    return (3, min(64, int(64 * w[0]))) + tuple(int(p * wi) for p, wi in zip(_BASE_PLANES, w))


def mobileone_plan(name: str, output_stride: int = 32, in_channels: int = 5) -> list[list[dict]]:
    """Each stage's blocks (stage0, then stages 1-4): smp's module name,
    input and output widths, kernel, stride and dilation after smp's walk,
    depthwise or not, conv branches, squeeze-excite, ``skip`` (from the
    original stride)."""
    if output_stride not in DILATIONS:
        raise ValueError(f"output_stride {output_stride} not in {tuple(DILATIONS)}")
    w, n_branches, use_se = MOBILEONE_SPECS[name]
    chans = mobileone_out_channels(name)
    stage_dil = (1, 1) + DILATIONS[output_stride]
    stages = [[dict(name="stage0", cin=in_channels, cout=chans[1], kernel=3, stride=2,
                    dilation=1, depthwise=False, branches=1, se=False, skip=False)]]
    cin = chans[1]
    for s in range(4):
        planes, n, dil = chans[s + 2], _NUM_BLOCKS[s], stage_dil[s]
        # Apple's _make_stage: squeeze-excite on the last num_se_blocks pairs
        n_se = (n // 2 if s == 2 else n if s == 3 else 0) if use_se else 0
        blocks = []
        for ix in range(n):
            orig_stride = 2 if ix == 0 else 1
            common = dict(branches=n_branches, se=ix >= n - n_se)
            blocks.append(dict(name=f"stage{s + 1}.{2 * ix}", cin=cin, cout=cin, kernel=3,
                               stride=1 if dil > 1 else orig_stride, dilation=dil,
                               depthwise=True, skip=orig_stride == 1, **common))
            blocks.append(dict(name=f"stage{s + 1}.{2 * ix + 1}", cin=cin, cout=planes, kernel=1,
                               stride=1, dilation=1, depthwise=False, skip=cin == planes,
                               **common))
            cin = planes
        stages.append(blocks)
    return stages


class ConvBN(nn.Module):
    """smp's ``conv_bn``: ``conv`` (bias-free, padded k // 2 times the
    dilation) and ``bn``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, dilation: int, groups: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, (k // 2) * dilation, dilation, groups=groups,
                              bias=False)
        self.bn = bn2d(cout)


class MobileOneSE(nn.Module):
    """Apple's SEBlock: biased 1x1 ``reduce`` to int(C / 16) and ``expand``
    back to C."""

    def __init__(self, channels: int):
        super().__init__()
        self.reduce = nn.Conv2d(channels, int(channels * SE_RATIO), 1)
        self.expand = nn.Conv2d(int(channels * SE_RATIO), channels, 1)


class MobileOneBlock(nn.Module):
    """smp's MobileOneBlock in training form: ``se``, ``rbr_skip`` (a bare
    BatchNorm), ``rbr_conv.{j}`` and ``rbr_scale`` (ConvBN, where the kernel
    is larger than 1); ``plan`` one block of :func:`mobileone_plan`."""

    def __init__(self, plan: dict, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cin, cout, k = plan["cin"], plan["cout"], plan["kernel"]
        groups = cout if plan["depthwise"] else 1
        self.se = MobileOneSE(cout) if plan["se"] else None
        self.rbr_skip = bn2d(cin) if plan["skip"] else None
        self.rbr_conv = nn.ModuleList(ConvBN(cin, cout, k, plan["stride"], plan["dilation"],
                                             groups) for _ in range(plan["branches"]))
        self.rbr_scale = ConvBN(cin, cout, 1, plan["stride"], 1, groups) if k > 1 else None

    def branches(self) -> list[ConvBN]:
        """The conv branches in the order their terms are added."""
        return list(self.rbr_conv) + ([self.rbr_scale] if self.rbr_scale is not None else [])

    def stack_scale_shift(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The terms' (scale, shift), (terms, C) float32: each branch's
        BatchNorm, then the skip's."""
        bns = [b.bn for b in self.branches()]
        if self.rbr_skip is not None:
            bns.append(self.rbr_skip)
        pairs = [scale_shift(m) for m in bns]
        return (torch.stack([p[0] for p in pairs]).contiguous(),
                torch.stack([p[1] for p in pairs]).contiguous())

    def sum_params(self) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`stack_scale_shift`'s pair as ``models/factory.py``'s
        ``prepare_inference`` stored it, or stacked now for a model that was
        not prepared (one in training, or evaluated between epochs)."""
        pair = getattr(self, "sum_scale_shift", None)
        return pair if pair is not None else self.stack_scale_shift()

    def forward(self, x, x32=None, keep_f32=False, epilogue=block_epilogue):
        """x: the block's input (cast to the compute dtype by each conv);
        x32: its float32 value, the skip's input where the block has one.
        ``epilogue``: the branch sum and squeeze-excite after the convs
        (``ops/branch_sum.py:block_epilogue``, or its plain version).
        Returns (out in the compute dtype, its float32 value if
        ``keep_f32``)."""
        if self.rbr_skip is not None and x32 is None:
            raise ValueError("a block with a skip needs its input's float32 value")
        ys = [conv(x, b.conv, self.dtype) for b in self.branches()]
        se = (self.se.reduce, self.se.expand) if self.se is not None else None
        return epilogue(ys, *self.sum_params(), x32 if self.rbr_skip is not None else None, se,
                        keep_f32)


class MobileOneEncoder(nn.Module):
    """smp's MobileOneEncoder: ``stage0`` and ``stage1..4`` (sequences keyed
    ``stage{n}.{i}``); returns the pyramid [x, stage0, stage1..] (strides 1,
    2, 4, 8, 16, 32 at output stride 32, the last ones held at 16 or 8 by
    dilation). ``depth`` d builds stage0 and stages 1..d-1, as ``flairtpu``."""

    def __init__(self, name: str = "mobileone_s0", in_channels: int = 5, dtype=torch.float32,
                 output_stride: int = 32, depth: int = 5):
        super().__init__()
        if not 1 <= depth <= 5:
            raise ValueError(f"depth {depth} not in 1..5")
        self.dtype = dtype
        self.output_stride, self.depth = output_stride, depth
        plan = mobileone_plan(name, output_stride, in_channels)
        self.stage0 = MobileOneBlock(plan[0][0], dtype)
        for s in range(1, depth):
            self.add_module(f"stage{s}", nn.Sequential(*(MobileOneBlock(b, dtype)
                                                         for b in plan[s])))
        self.out_channels = ((0,) + mobileone_out_channels(name)[1:])[:depth + 1]

    def blocks(self) -> list[MobileOneBlock]:
        """Every block built, in order."""
        return [m for m in self.modules() if isinstance(m, MobileOneBlock)]

    def forward(self, x: torch.Tensor, epilogue=block_epilogue) -> list[torch.Tensor]:
        """The pyramid [x, f1..f_depth]; f1.. in the compute dtype."""
        blocks = self.blocks()
        # float32 is written only where the next block adds it as its skip
        needs_f32 = [b.rbr_skip is not None for b in blocks[1:]] + [False]
        y, y32 = self.stage0(x, keep_f32=needs_f32[0], epilogue=epilogue)
        feats = [x, y]
        i = 1
        for s in range(1, self.depth):
            for block in getattr(self, f"stage{s}"):
                y, y32 = block(y, y32, needs_f32[i], epilogue)
                i += 1
            feats.append(y)
        return feats
