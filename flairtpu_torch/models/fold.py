"""BatchNorm folded into the convolutions for zone inference
(``bn_fold: true``; counterpart of ``flairtpu/models/fold.py:37-96``, with
the folding and the two walks of ``flairtpu/models/quantize.py:59-197``).

At inference a BatchNorm is a per-channel affine, so it folds into the conv
before it: ``w * g`` and ``beta - mean * g`` with ``g = gamma / sqrt(var +
eps)``, in float32, exactly as ``flairtpu`` computes it (not the ``rsqrt``
of ``models/resnet.py:bn_scale_shift``: the int8 weights are rounded from
these values). The folded sites run in the model's compute dtype, the bias
rounded to it as ``flairtpu``'s folded walk keeps it, and no float32 copies
pass between blocks.

The walks (:func:`walk_features`, :func:`walk_unet_decode`) recompute the
ResNet encoder, at the arch's output stride and depth, and the U-Net
decoder, with its inner-margin plan, over conv sites named as ``flairtpu``
names them (``stem``,
``layer{s}_{u}/conv{i}``, ``layer{s}_{u}/downsample``,
``block{i}/conv{1,2}``). They call an ``ops`` object for every site, pool
and decoder input, so that the folded model (:class:`FloatSites`), the
int8 model and its calibration (``models/quantize.py``) share one topology.
A site call names the site that reads its output next (``feeds``) and says
whether anything else reads it (``keep``), which the int8 sites use to
write only what is read.

On the card a folded site is a cuDNN conv followed by ``conv_epilogue``
with scale 1 and shift = the bias; a block's last site adds its identity,
or its downsample branch, in the same pass, so the port rounds ``y + b +
identity`` once where ``flairtpu`` rounds twice (ROADMAP queue 3). Decoder
block 4 and the head run in ``fused_tail`` with the parameters of
:func:`fold_tail_params`.

The other archs fold only their encoder, as ``flairtpu/models/fold.py:
43-95`` does: the folded walk feeds the model's own float decoder and head,
with their BatchNorms, and the model's zone tail.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from flairtpu_torch.models.resnet import RESNET_SPECS, STAGE_DILATIONS
from flairtpu_torch.models.unet import DEFAULT_DECODER_CHANNELS, plan_inner_crops, \
    upsample2x_nearest
from flairtpu_torch.ops.epilogue import conv_epilogue
from flairtpu_torch.ops.fused_tail import TailParams
from flairtpu_torch.ops.group_norm import group_norm_relu

N_DECODER_BLOCKS = len(DEFAULT_DECODER_CHANNELS)


def fold_bn(weight: torch.Tensor, bn: nn.BatchNorm2d) -> dict:
    """{"w": (O, I, kh, kw), "b": (O,)} float32 (``quantize.py:59-62``). The
    square root is taken in float64 and rounded once: that is the correctly
    rounded float32 root XLA computes, which PyTorch's vectorized float32
    root on the CPU is not in every case."""
    with torch.no_grad():
        root = torch.sqrt((bn.running_var.float() + bn.eps).double()).float()
        g = bn.weight.float() / root
        return {"w": weight.detach().float() * g[:, None, None, None],
                "b": bn.bias.float() - bn.running_mean.float() * g}


def fold_encoder(encoder: nn.Module) -> dict:
    """The folded sites of a ResNet encoder (``quantize.py:65-88``); a
    grouped conv's site carries its ``groups``."""
    out = {"stem": fold_bn(encoder.conv1.weight, encoder.bn1)}
    for s in range(1, encoder.n_stages + 1):
        for u, blk in enumerate(getattr(encoder, f"layer{s}")):
            for i in (1, 2, 3):
                if hasattr(blk, f"conv{i}"):
                    conv = getattr(blk, f"conv{i}")
                    site = out[f"layer{s}_{u}/conv{i}"] = fold_bn(conv.weight,
                                                                 getattr(blk, f"bn{i}"))
                    if conv.groups > 1:
                        site["groups"] = conv.groups
            if blk.downsample is not None:
                out[f"layer{s}_{u}/downsample"] = fold_bn(blk.downsample[0].weight,
                                                         blk.downsample[1])
    return out


def fold_unet_decoder(decoder: nn.Module) -> dict:
    """The folded sites of the U-Net decoder blocks (``quantize.py:141-156``);
    the head has no BatchNorm."""
    return {f"block{i}/conv{j}": fold_bn(getattr(blk, f"conv{j}")[0].weight,
                                         getattr(blk, f"conv{j}")[1])
            for i, blk in enumerate(decoder.blocks) for j in (1, 2)}


def walk_features(spec: str, ops, x, output_stride: int = 32, depth: int = 5) -> list:
    """The pyramid [x, f1..f_depth] of the ResNet encoder ``spec`` at
    ``output_stride`` (dilated last stages, whose strides are 1 and whose
    3x3 convs pad by their dilation) and ``depth`` (stages 1..depth - 1)
    through ``ops`` (``quantize.py:95-138``, its laws; a ResNeXt's 3x3 is
    grouped)."""
    kind, units, groups, _ = RESNET_SPECS[spec]
    expansion = 1 if kind == "basic" else 4
    dilations = STAGE_DILATIONS[output_stride]
    blocks, in_ch = [], 64  # (stage, name, stride, dilation, has a downsample)
    for stage, n_units in enumerate(units[:max(depth - 1, 0)]):
        width = 64 * 2 ** stage
        dilation = dilations.get(stage, 1)
        stride = 1 if stage == 0 or dilation > 1 else 2
        for u in range(n_units):
            first = u == 0
            blocks.append((stage, f"layer{stage + 1}_{u}", stride if first else 1, dilation,
                           first and (in_ch != width * expansion
                                      or (stage != 0 and dilation == 1))))
            in_ch = width * expansion
    feats = [x]
    y = ops.conv("stem", x, 2, 3)
    feats.append(y)
    y = ops.pool(y)
    for k, (stage, name, s, d, ds) in enumerate(blocks):
        # (conv, stride, padding, dilation, groups): basic 3x3 / 3x3,
        # bottleneck 1x1 / 3x3 (grouped) / 1x1
        convs = ([("conv1", s, d, d, 1), ("conv2", 1, d, d, 1)] if kind == "basic" else
                 [("conv1", 1, 0, 1, 1), ("conv2", s, d, d, groups), ("conv3", 1, 0, 1, 1)])
        z = y
        for (conv, stride, pad, dil, g), (after, *_) in zip(convs, convs[1:]):
            z = ops.conv(f"{name}/{conv}", z, stride, pad, keep=False, feeds=f"{name}/{after}",
                         dilation=dil, groups=g)
        identity = ops.downsample(f"{name}/downsample", y, s) if ds else y
        last, _, pad, dil, _ = convs[-1]
        nxt = f"{blocks[k + 1][1]}/conv1" if k + 1 < len(blocks) else None
        y = ops.conv(f"{name}/{last}", z, 1, pad, residual=identity, feeds=nxt, dilation=dil)
        if k + 1 == len(blocks) or blocks[k + 1][0] != stage:
            feats.append(y)
    return feats


def walk_unet_decode(ops, feats: list, inner_margin: int | None,
                     n_blocks: int = N_DECODER_BLOCKS):
    """Decoder blocks [0, n_blocks) over ``feats`` (``quantize.py:159-197``):
    the full decode, or with ``inner_margin`` the interior plan
    (``plan_inner_crops``). Returns (x, offset): x covers [offset, offset +
    extent) of its resolution."""
    feats_r = feats[1:][::-1]
    x, skips = feats_r[0], feats_r[1:]
    plans = (plan_inner_crops(feats[0].shape[-1], inner_margin, N_DECODER_BLOCKS)
             if inner_margin is not None else None)
    off = 0
    for i in range(n_blocks):
        crop = None
        if plans is not None:  # upsampled x covers [2 off, ...): crop it to [lo, hi)
            lo, hi = plans[i]["post"]
            crop = ((lo - 2 * off, hi - 2 * off), (lo, hi))
            off = lo
        x = ops.join(i, x, skips[i] if i < len(skips) else None, crop)
        x = ops.conv(f"block{i}/conv1", x, 1, 1, keep=False, feeds=f"block{i}/conv2")
        x = ops.conv(f"block{i}/conv2", x, 1, 1)
    return x, off


def join_values(x: torch.Tensor, skip: torch.Tensor | None, crop) -> torch.Tensor:
    """A decoder block's input: upsample2x(x), cropped by ``crop`` ((a, b),
    (lo, hi)) or whole, concatenated with the skip (cast to x's dtype)."""
    x = upsample2x_nearest(x)
    if crop is not None:
        (a, b), (lo, hi) = crop
        x = x[:, :, a:b, a:b]
        skip = skip[:, :, lo:hi, lo:hi] if skip is not None else None
    if skip is not None:
        x = torch.cat([x, skip.to(x.dtype)], dim=1)
    return x.contiguous(memory_format=torch.channels_last)


def float_sites(folded: dict, dtype: torch.dtype) -> dict:
    """Folded sites for :class:`FloatSites`: weights in ``dtype``; the bias
    rounded to ``dtype`` and kept as the epilogue's float32 shift, beside a
    scale of ones."""
    return {k: {"w": v["w"].to(dtype), "b": v["b"].to(dtype).float().contiguous(),
                "one": torch.ones_like(v["b"])} for k, v in folded.items()}


class FloatSites:
    """Walk ops of folded float sites in ``dtype``: conv, then ``epilogue``
    (scale 1, shift = bias), with the identity added in the block's last
    site and a downsample's bias folded into it as a branch. Values are
    NCHW channels_last tensors in ``dtype``."""

    def __init__(self, sites: dict, dtype: torch.dtype, epilogue=conv_epilogue):
        self.sites, self.dtype, self.epilogue = sites, dtype, epilogue

    def _conv(self, name: str, x: torch.Tensor, stride: int, padding: int,
              dilation: int = 1, groups: int = 1) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.sites[name]["w"], None, stride, padding, dilation,
                     groups)
        return y.contiguous(memory_format=torch.channels_last)

    def conv(self, name: str, x, stride: int, padding: int, relu: bool = True, residual=None,
             keep: bool = True, feeds: str | None = None, dilation: int = 1, groups: int = 1):
        c = self.sites[name]
        branch = residual if isinstance(residual, tuple) else None
        residual = None if branch is not None else residual
        out, _ = self.epilogue(self._conv(name, x, stride, padding, dilation, groups), c["one"],
                               c["b"], residual=residual, branch=branch, act=relu)
        return out

    def downsample(self, name: str, x, stride: int) -> tuple:
        """The branch (conv output, 1, bias) the block's last site adds."""
        c = self.sites[name]
        return self._conv(name, x, stride, 0), c["one"], c["b"]

    def pool(self, x):
        return F.max_pool2d(x, 3, 2, 1)

    def join(self, i: int, x, skip, crop):
        return join_values(x, skip, crop)


def fold_tail_params(dec: dict, head: nn.Conv2d, dtype: torch.dtype) -> TailParams:
    """``fused_tail``'s parameters for folded decoder block 4: scale 1 and
    the folded bias as shift, weights and biases rounded to ``dtype``, as
    the folded walk and its head hold them."""
    def r(t):
        return t.detach().to(dtype).float().contiguous()

    c1, c2 = dec["block4/conv1"], dec["block4/conv2"]
    with torch.no_grad():
        return TailParams(r(c1["w"]), torch.ones_like(c1["b"]), r(c1["b"]),
                          r(c2["w"]), torch.ones_like(c2["b"]), r(c2["b"]),
                          r(head.weight), r(head.bias))


def head_logits(y: torch.Tensor, tail: TailParams, x_size: int, inner_margin: int | None,
                offset: int) -> torch.Tensor:
    """The segmentation head on block 4's output y, as ``fused_tail``'s
    plain version computes it (operands in y's dtype, float32 sums), with
    the interior crop -> (B, h, w, K) float32."""
    logits = F.conv2d(y.float(), tail.wh, tail.bias, padding=1)
    if inner_margin is not None:
        a, b = inner_margin - offset, x_size - inner_margin - offset
        logits = logits[:, :, a:b, a:b]
    return logits.permute(0, 2, 3, 1)


class FoldedZoneModel:
    """BatchNorm-folded zone inference (``flairtpu/models/fold.py:42-81``):
    the zone runners' model surface (``dtype``, ``tail_input``) with
    ``tail`` for the zone's tail kernel. The U-Net runs the folded walk
    through decoder block 3 and ``fused_tail`` with :func:`fold_tail_params`;
    the other archs (``model``: the prepared float model) the folded
    encoder walk at their output stride and depth, then the model's float
    decoder, head and zone tail. Inference only."""

    def __init__(self, spec: str, enc: dict, dec: dict | None, head: nn.Conv2d | None,
                 dtype: torch.dtype, model=None):
        self.spec, self.dtype, self.model = spec, dtype, model
        self.enc = float_sites(enc, dtype)
        if model is None:
            self.encoder_geometry = (32, 5)
            self.dec = float_sites(dec, dtype)
            self.tail = fold_tail_params(dec, head, dtype)
        else:
            self.encoder_geometry = (model.encoder.output_stride, model.encoder.depth)
            self.tail = model.zone_tail()

    def features(self, x: torch.Tensor, epilogue=conv_epilogue) -> list:
        """x (B, H, W, C) -> [x, f1..], NCHW channels_last in ``dtype``."""
        return walk_features(self.spec, FloatSites(self.enc, self.dtype, epilogue),
                             x.permute(0, 3, 1, 2).to(self.dtype), *self.encoder_geometry)

    def tail_input(self, x: torch.Tensor, margin: int, epilogue=conv_epilogue,
                   group_norm=group_norm_relu) -> torch.Tensor:
        """The tail kernel's input: the U-Net's encoder and decoder blocks
        0-3 on the interior plan of ``margin``, or the other archs' folded
        encoder and ``decode_tail`` (``group_norm``: FPN's sites)."""
        feats = self.features(x, epilogue)
        if self.model is not None:
            return self.model.decode_tail(feats, margin, epilogue, group_norm)
        ops = FloatSites(self.dec, self.dtype, epilogue)
        x3, _ = walk_unet_decode(ops, feats, margin, N_DECODER_BLOCKS - 1)
        return x3.contiguous(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, inner_margin: int | None = None,
                epilogue=conv_epilogue) -> torch.Tensor:
        """x (B, H, W, C) -> float32 logits (B, h, w, K): the U-Net's five
        blocks and the head through the walk, the other archs' float
        ``decode`` (``FoldedZoneModel.apply``)."""
        feats = self.features(x, epilogue)
        if self.model is not None:
            return self.model.decode(feats, inner_margin, epilogue)
        y, off = walk_unet_decode(FloatSites(self.dec, self.dtype, epilogue), feats, inner_margin)
        return head_logits(y, self.tail, x.shape[1], inner_margin, off)

    __call__ = forward


def fold_model(model) -> FoldedZoneModel:
    """Fold a loaded FlairSegmentationModel (float32 weights, before
    ``prepare_inference``) in its compute dtype, on its device: the U-Net
    whole, the other archs' encoder (their decoder is prepared here)."""
    if model.use_metadata:
        raise ValueError("bn_fold: use_metadata is not supported")
    if model.encoder_name not in RESNET_SPECS:
        raise ValueError(f"bn_fold: supports the ResNet encoder families "
                         f"({', '.join(sorted(RESNET_SPECS))}); got {model.encoder_name!r}")
    enc = fold_encoder(model.encoder)
    if model.arch == "unet":
        return FoldedZoneModel(model.encoder_name, enc, fold_unet_decoder(model.decoder),
                               model.segmentation_head[0], model.dtype)
    model.prepare_inference()
    return FoldedZoneModel(model.encoder_name, enc, None, None, model.dtype, model)
