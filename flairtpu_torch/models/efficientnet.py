"""EfficientNet encoders, ``efficientnet-b0`` .. ``-b7`` (smp's wrapper of
efficientnet-pytorch), with smp's key names (counterpart of
``flairtpu/models/efficientnet.py``).

The plan (:func:`efficientnet_plan`) is ``flairtpu``'s, copied: channel
and repeat scaling, TF-style static "same" pads computed once from the
variant's default image size (asymmetric, (0, 1) or (1, 2), at even sizes;
symmetric at odd ones, as b3's 75² stage), smp's feature taps, and the
dilation walk at output stride 16 / 8 (strides become 1, the depthwise
convs dilate with symmetric pads; a dilated first block keeps ``skip``
False, judged on its original stride).

An MBConv block (``flairtpu/models/efficientnet.py:154-212``) at inference:
a 1x1 expand (none at expand ratio 1) and its BatchNorm + SiLU (one
``conv_epilogue`` with ``silu``), the depthwise kxk (cuDNN's grouped conv
in the compute dtype), its BatchNorm + SiLU and the squeeze-excite gate
(``ops/se_gate.py:squeeze_excite``: the squeeze kernel, the two small
biased 1x1 convs, the excite kernel, which writes the project conv's
input), the 1x1 project and its BatchNorm, plus the identity (one
``conv_epilogue``). BatchNorm eps is 1e-3. Every BatchNorm output is
float32 in ``flairtpu``, so a block's output is float32; the port passes
the compute-dtype copy on and writes the float32 value only where the next
block adds it as its identity, as ``models/resnet.py`` does.

To train (``flairtpu/models/efficientnet.py:170-212, :234-262``), the
forward takes ``ops/bn_train.py:TrainSites`` as its epilogue: the stem's
and each expand's BatchNorm + SiLU are SiLU sites, the depthwise site
(BatchNorm, SiLU and the squeeze-excite gate) is one ``SEGateSite``, and
the project's BatchNorm, with the identity, a site whose blocks with
``skip`` take efficientnet-pytorch's per-sample drop-connect at rate
``0.2 j / n`` (block j, n the plan's block count, not the blocks built:
PSPNet's depth-3 encoder builds 5 of b0's 16). Its keep masks come from
the forward's ``dropout``: the trainer's ``torch.Generator`` (one (B,)
draw a dropping block, in block order, on the batch's device), or a dict
of (B,) masks by block index.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from flairtpu_torch.models.resnet import conv, scale_shift
from flairtpu_torch.ops.bn_train import TrainSites
from flairtpu_torch.ops.epilogue import conv_epilogue
from flairtpu_torch.ops.se_gate import squeeze_excite

# width_coefficient, depth_coefficient, default image size
EFFICIENTNET_SPECS = {
    "efficientnet-b0": (1.0, 1.0, 224),
    "efficientnet-b1": (1.0, 1.1, 240),
    "efficientnet-b2": (1.1, 1.2, 260),
    "efficientnet-b3": (1.2, 1.4, 300),
    "efficientnet-b4": (1.4, 1.8, 380),
    "efficientnet-b5": (1.6, 2.2, 456),
    "efficientnet-b6": (1.8, 2.6, 528),
    "efficientnet-b7": (2.0, 3.1, 600),
}

# base (b0) stages: repeats, kernel, stride, expand_ratio, in, out
_BASE_STAGES = (
    (1, 3, 1, 1, 32, 16),
    (2, 3, 2, 6, 16, 24),
    (2, 5, 2, 6, 24, 40),
    (3, 3, 2, 6, 40, 80),
    (3, 5, 1, 6, 80, 112),
    (4, 5, 2, 6, 112, 192),
    (1, 3, 1, 6, 192, 320),
)

BN_EPS = 1e-3       # efficientnet-pytorch batch_norm_epsilon
BN_MOMENTUM = 0.01  # torch's convention (flax 0.99)
DROP_CONNECT_RATE = 0.2  # efficientnet-pytorch's global default


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """efficientnet-pytorch round_filters (TF-slim rounding)."""
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """Conv2dStaticSamePadding's (left, right) pad at a given input size."""
    o = math.ceil(size / s)
    pad = max((o - 1) * s + k - size, 0)
    return (pad // 2, pad - pad // 2)


def efficientnet_plan(name: str, output_stride: int = 32) -> dict:
    """Static per-block plan: channels, kernels, strides, pad pairs, se dims.

    The pad pairs come from walking the variant's default image size through
    the stride trajectory, exactly like efficientnet-pytorch's
    get_same_padding_conv2d(image_size=...) static construction.
    """
    width, depth, image = EFFICIENTNET_SPECS[name]
    size = image
    stem_ch = round_filters(32, width)
    stem_pad = _same_pad(size, 3, 2)
    size = math.ceil(size / 2)

    # output_stride dilation per smp make_dilated: encoder stages 4+5 (=EN
    # stages 4,5) and 5 (=EN stages 6,7) in get_stages numbering
    dilate_from = {32: None, 16: 5, 8: 3}[output_stride]  # EN stage index (0-based)
    blocks = []
    boundaries = []
    dilation = 1
    for si, (r, k, s, e, cin, cout) in enumerate(_BASE_STAGES):
        repeats = int(math.ceil(depth * r))
        cin_r = round_filters(cin, width)
        cout_r = round_filters(cout, width)
        if dilate_from is not None and si == dilate_from:
            dilation *= 2
        elif dilate_from is not None and si == 5 and output_stride == 8:
            dilation *= 2  # second dilation jump handled below
        for j in range(repeats):
            stride = s if j == 0 else 1
            bin_ = cin_r if j == 0 else cout_r
            dilated = dilate_from is not None and si >= dilate_from
            if dilated:
                eff_stride = 1
                pad = ((k // 2) * dilation,) * 2  # symmetric; static pad removed
                d = dilation
            else:
                eff_stride = stride
                pad = _same_pad(size, k, stride)
                d = 1
            if not dilated and stride > 1:
                size = math.ceil(size / stride)
            blocks.append(dict(
                kernel=k, stride=eff_stride, dilation=d, expand=e,
                cin=bin_, cout=cout_r,
                se=max(1, int(bin_ * 0.25)),
                # smp's id_skip checks the ORIGINAL block-args stride, so a
                # dilated (stride-removed) first block still has no residual
                skip=(stride == 1 and bin_ == cout_r),
                pad=(pad, pad) if isinstance(pad[0], int) else pad,
            ))
        boundaries.append(len(blocks))
    # smp feature taps: after EN stages 2, 3, 5, 7 (1-based)
    stage_idxs = (boundaries[1], boundaries[2], boundaries[4])
    out_channels = (stem_ch,
                    round_filters(24, width), round_filters(40, width),
                    round_filters(112, width), round_filters(320, width))
    return dict(stem_ch=stem_ch, stem_pad=stem_pad, blocks=blocks,
                stage_idxs=stage_idxs, out_channels=out_channels,
                n_blocks=len(blocks))


def same_conv(x: torch.Tensor, m: nn.Conv2d, pad: tuple, dtype: torch.dtype) -> torch.Tensor:
    """``m`` on ``x`` with the plan's static pad ``pad`` = (before, after),
    the same for rows and columns, as :func:`models.resnet.conv` computes
    it. A symmetric pad is the conv's own padding (:func:`own_padding`); an
    asymmetric one ((0, 1) or (1, 2) at the stride-2 sites) pads a copy of
    ``x``, as cuDNN's convolution pads symmetrically. (The view that drops
    the first row and column and pads p + 1 on both sides is not the same
    conv: its first output row would read a zero where the (p, p + 1) pad
    reads row 0.)"""
    lo, hi = pad
    return conv(x if lo == hi else F.pad(x, (lo, hi, lo, hi)), m, dtype)


def own_padding(pad: tuple) -> int:
    """The conv's own padding for the plan's ``pad``: all of a symmetric
    one, none of an asymmetric one (:func:`same_conv` pads)."""
    return pad[0] if pad[0] == pad[1] else 0


def silu_site(epilogue, y: torch.Tensor, bn: nn.BatchNorm2d, keep_f32: bool = False):
    """A BatchNorm + SiLU site (the stem, an expand): the inference
    epilogue with ``bn``'s (scale, shift), or in training ``TrainSites``.
    Returns (out, its float32 value if ``keep_f32``)."""
    if isinstance(epilogue, TrainSites):
        return epilogue.site(y, bn, act="silu", keep_f32=keep_f32)
    return epilogue(y, *scale_shift(bn), act="silu", keep_f32=keep_f32)


def bn2d(ch: int) -> nn.BatchNorm2d:
    """EfficientNet's BatchNorm (eps 1e-3): parameters and running
    statistics under smp's key names; inference takes its (scale, shift)."""
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


class MBConvBlock(nn.Module):
    """efficientnet-pytorch's MBConvBlock with smp's key names (``_expand_conv``,
    ``_bn0``, ``_depthwise_conv``, ``_bn1``, ``_se_reduce``, ``_se_expand``,
    ``_project_conv``, ``_bn2``); ``plan`` one block of
    :func:`efficientnet_plan`."""

    def __init__(self, plan: dict, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.skip, self.pad, self.expand = plan["skip"], plan["pad"][0], plan["expand"]
        cin, k = plan["cin"], plan["kernel"]
        mid = cin * self.expand
        if self.expand != 1:
            self._expand_conv = nn.Conv2d(cin, mid, 1, bias=False)
            self._bn0 = bn2d(mid)
        self._depthwise_conv = nn.Conv2d(mid, mid, k, plan["stride"], own_padding(self.pad),
                                         plan["dilation"], groups=mid, bias=False)
        self._bn1 = bn2d(mid)
        self._se_reduce = nn.Conv2d(mid, plan["se"], 1)
        self._se_expand = nn.Conv2d(plan["se"], mid, 1)
        self._project_conv = nn.Conv2d(mid, plan["cout"], 1, bias=False)
        self._bn2 = bn2d(plan["cout"])

    def forward(self, x, x32=None, keep_f32=False, epilogue=conv_epilogue,
                se_gate=squeeze_excite, drop=None):
        """x: the block's input (cast to the compute dtype by each conv);
        x32: its float32 value, the identity of a block with ``skip``;
        ``drop`` (train only): ((B,) float32 keep mask, keep probability),
        the drop-connect. Returns (out in the compute dtype, its float32
        value if ``keep_f32``)."""
        dt = self.dtype
        train = isinstance(epilogue, TrainSites)
        h = x
        if self.expand != 1:
            h, _ = silu_site(epilogue, conv(x, self._expand_conv, dt), self._bn0)
        y = same_conv(h, self._depthwise_conv, self.pad, dt)
        if train:
            h = epilogue.se_site(y, self._bn1, self._se_reduce, self._se_expand)
        else:
            h = se_gate(y, *scale_shift(self._bn1), self._se_reduce, self._se_expand)
        if self.skip and x32 is None:
            raise ValueError("a block with an identity skip needs its input's float32 value")
        y = conv(h, self._project_conv, dt)
        residual = x32 if self.skip else None
        if train:
            return epilogue.site(y, self._bn2, residual=residual, act=None, keep_f32=keep_f32,
                                 drop=drop)
        return epilogue(y, *scale_shift(self._bn2), residual=residual, act=None,
                        keep_f32=keep_f32)


class EfficientNetEncoder(nn.Module):
    """smp's EfficientNetEncoder: the stem (3x3 / 2 conv, BatchNorm, SiLU)
    and the MBConv blocks; returns the pyramid [x, f1..f_depth] (strides 1,
    2, 4, 8, 16, 32 at output stride 32, the last ones held at 16 or 8 by
    dilation). ``depth`` 3 (PSPNet) stops at the stride-8 tap, and the model
    then has no later blocks."""

    def __init__(self, name: str = "efficientnet-b0", in_channels: int = 5,
                 dtype=torch.float32, output_stride: int = 32, depth: int = 5):
        super().__init__()
        self.dtype = dtype
        self.output_stride, self.depth = output_stride, depth
        plan = efficientnet_plan(name, output_stride)
        self.stem_pad = plan["stem_pad"]
        self._conv_stem = nn.Conv2d(in_channels, plan["stem_ch"], 3, 2,
                                    own_padding(self.stem_pad), bias=False)
        self._bn0 = bn2d(plan["stem_ch"])
        self.taps = frozenset(plan["stage_idxs"])
        self.n_blocks = plan["n_blocks"]
        # smp runs stages [2..depth]: depth 3 stops at the stride-8 tap
        stop = sorted(self.taps)[depth - 2] if depth < 5 else plan["n_blocks"]
        self._blocks = nn.ModuleList(MBConvBlock(b, dtype) for b in plan["blocks"][:stop])
        self.out_channels = ((0,) + plan["out_channels"])[:depth + 1]

    def drop_connect(self, j: int, batch: int, device: torch.device, dropout):
        """Block j's drop-connect in training: ((B,) float32 keep mask, keep
        probability), or None where it drops nothing (no identity, rate 0,
        or no ``dropout``). ``dropout``: the generator (a draw on
        ``device``), or a dict of masks by block index."""
        rate = DROP_CONNECT_RATE * j / self.n_blocks
        if dropout is None or rate == 0 or not self._blocks[j].skip:
            return None
        keep = 1.0 - rate
        if isinstance(dropout, torch.Generator):
            mask = torch.rand((batch,), generator=dropout, device=device) < keep
        else:
            mask = dropout[j]
        return mask.to(device=device, dtype=torch.float32).contiguous(), keep

    def forward(self, x: torch.Tensor, epilogue=conv_epilogue,
                se_gate=squeeze_excite, dropout=None) -> list[torch.Tensor]:
        """The pyramid [x, f1..f_depth]; f1.. in the compute dtype.
        ``dropout`` (with ``TrainSites``): the drop-connect's masks
        (:meth:`drop_connect`)."""
        blocks = list(self._blocks)
        train = isinstance(epilogue, TrainSites)
        # float32 is written only where the next block adds it as its identity
        needs_f32 = [b.skip for b in blocks[1:]] + [False]
        feats = [x]
        y = same_conv(x, self._conv_stem, self.stem_pad, self.dtype)
        x, x32 = silu_site(epilogue, y, self._bn0, keep_f32=blocks[0].skip)
        feats.append(x)
        for j, block in enumerate(blocks):
            drop = self.drop_connect(j, x.shape[0], x.device, dropout) if train else None
            x, x32 = block(x, x32, needs_f32[j], epilogue, se_gate, drop)
            if (j + 1) in self.taps and len(feats) < self.depth + 1:
                feats.append(x)
        if len(feats) < self.depth + 1:
            feats.append(x)  # the final stage (stride 32, or dilated)
        return feats
