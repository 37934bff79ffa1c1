"""Model factory: config -> segmentation model
(counterpart of ``flairtpu/models/factory.py:36-51, 168-235, 256-327``).

The nine smp models over the resnet and resnext encoders, the
efficientnet-b0..b7 encoders (``models/efficientnet.py``), mobilenet_v2
(``models/mobilenet.py``) and mobileone_s0..s4 (``models/mobileone.py``):
the U-Net (slice
1), the strided-head decoders of slice 5 (deeplabv3plus, deeplabv3, fpn,
pspnet, pan), linknet, MAnet and UNet++, each with smp's module names so
that their state dicts load as they are. The encoder follows its name, as
``flairtpu/models/factory.py:114-118`` dispatches it, at the arch's output
stride and depth (:data:`ARCHS`). With ``use_metadata`` the model also carries
the metadata MLP (``enc``, the reference's key names) and adds its
embedding to the deepest encoder feature (``models/metadata_mlp.py``). The
model's public functions keep ``flairtpu``'s layout: input (B, H, W, C),
logits (B, h, w, K) float32. Inside, tensors are NCHW views of NHWC memory
(``channels_last``).

To train, the forward takes ``ops/bn_train.py:TrainSites`` as its epilogue
and a ``dropout``: the trainer's ``torch.Generator``, from which an
EfficientNet encoder's drop-connect (``drop_connect``), the metadata MLP
(``enc``) and then the decoder (:data:`DROPOUT_ARCHS`) draw their keep
masks in that order, or the masks themselves, by module name
(:func:`dropout_part`). The training logits are the full (B, S, S, K)
map: ``decode`` at no margin (the strided-head archs' align-corners
upsample as ``flairtpu`` computes it, outside any kernel).

The zone tail (:meth:`FlairSegmentationModel.zone_tail`) is ``fused_tail``
for the archs that end in the U-Net's last block and 3x3 head
(:data:`FUSED_TAIL_ARCHS`), ``strided_tail`` for the others.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from flairtpu_torch.config import check_smp, not_ported
from flairtpu_torch.models.deeplab import DeepLabV3PlusDecoder
from flairtpu_torch.models.efficientnet import EFFICIENTNET_SPECS, EfficientNetEncoder
from flairtpu_torch.models.manet import MAnetDecoder
from flairtpu_torch.models.metadata_mlp import MetadataMLP, fuse_metadata
from flairtpu_torch.models.mobilenet import MobileNetV2Encoder
from flairtpu_torch.models.mobileone import MOBILEONE_SPECS, MobileOneEncoder
from flairtpu_torch.models.pan import PANDecoder
from flairtpu_torch.models.resnet import ResNetEncoder, prepare_inference
from flairtpu_torch.models.smp_extra import (DeepLabV3Decoder, FPNDecoder, LinknetDecoder,
                                             PSPDecoder)
from flairtpu_torch.models.unet import SegmentationHead, UnetDecoder, UnetPlusPlusDecoder, \
    plan_inner_crops
from flairtpu_torch.ops.bn_train import TrainSites
from flairtpu_torch.ops.branch_sum import block_epilogue
from flairtpu_torch.ops.epilogue import conv_epilogue
from flairtpu_torch.ops.fused_tail import TailParams, tail_params
from flairtpu_torch.ops.group_norm import group_norm_relu
from flairtpu_torch.ops.se_gate import squeeze_excite
from flairtpu_torch.ops.strided_tail import StridedGeometry, StridedTail, upsample_window

# smp SegmentationHead upsampling factor (UpsamplingBilinear2d):
# deeplabv3plus/fpn/pan emit stride-4 maps, deeplabv3/pspnet stride-8
HEAD_UPSAMPLE = {"deeplabv3plus": 4, "fpn": 4, "pan": 4, "deeplabv3": 8, "pspnet": 8}
# architectures whose zone decode keeps only the margin interior
# (``decode``'s ``inner_margin``): unet by the plan_inner_crops walk, the
# strided-head archs by the windowed upsample; linknet, manet and
# unetplusplus decode whole tiles and are cropped
INNER_DECODE_ARCHS = frozenset({"unet", *HEAD_UPSAMPLE})
# architectures that end in the U-Net's last block (32 -> 16 channels at
# half resolution, upsampled) and a 3x3 head: their zone tail is fused_tail,
# on the crop of that block's input (``tail_input``)
FUSED_TAIL_ARCHS = frozenset({"unet", "manet", "unetplusplus"})
# architectures whose decoder drops out in train mode: the ASPP's
# Dropout(0.5) (flairtpu/models/deeplab.py:161, smp_extra.py:260), FPN's and
# PSPNet's Dropout2d(0.2) (smp_extra.py:98-100, 150-151)
DROPOUT_ARCHS = frozenset({"deeplabv3plus", "deeplabv3", "fpn", "pspnet"})
# per architecture: the encoder's smp arguments, the decoder (built from
# the encoder's channels), the head's input channels and kernel
ARCHS = {
    "unet": ({}, UnetDecoder, 16, 3),
    "unetplusplus": ({}, UnetPlusPlusDecoder, 16, 3),
    "manet": ({}, MAnetDecoder, 16, 3),
    "deeplabv3plus": ({"output_stride": 16}, DeepLabV3PlusDecoder, 256, 1),
    "deeplabv3": ({"output_stride": 8}, DeepLabV3Decoder, 256, 1),
    "fpn": ({}, FPNDecoder, 128, 1),
    "pspnet": ({"depth": 3}, PSPDecoder, 512, 3),
    "linknet": ({}, LinknetDecoder, 32, 1),
    # smp's PAN fixes the encoder's output stride at 16 (decoders/pan/model.py)
    "pan": ({"output_stride": 16}, PANDecoder, 32, 3),
}


def dropout_part(dropout, name: str):
    """What module ``name`` (``drop_connect``, an EfficientNet encoder's:
    a dict of (B,) masks by block index; ``enc``, the metadata MLP;
    ``decoder``) takes of a forward's ``dropout``: None (eval), the
    generator itself, or the keep masks of a dict of them by module name."""
    if dropout is None or isinstance(dropout, torch.Generator):
        return dropout
    return dropout[name]


class FlairSegmentationModel(nn.Module):
    """smp ``create_model(arch, encoder_name, classes, in_channels)`` with
    smp's key names, ``arch`` one of :data:`ARCHS`; ``s2d_stem``: the
    resnet encoder's stem conv on the space-to-depth repack
    (``models/resnet.py:stem_conv``), ignored by EfficientNet, MobileNetV2
    and MobileOne, as ``flairtpu`` passes it to the resnet encoder only
    (``flairtpu/models/factory.py:166``)."""

    def __init__(self, encoder_name: str = "resnet34", classes: int = 13,
                 in_channels: int = 5, dtype=torch.float32, use_metadata: bool = False,
                 arch: str = "unet", s2d_stem: bool = False):
        super().__init__()
        enc_kw, decoder, head_ch, head_k = ARCHS[arch]
        self.arch = arch
        self.dtype = dtype
        self.encoder_name = encoder_name
        self.use_metadata = use_metadata
        if encoder_name in EFFICIENTNET_SPECS:
            self.encoder = EfficientNetEncoder(encoder_name, in_channels, dtype=dtype, **enc_kw)
        elif encoder_name == "mobilenet_v2":
            self.encoder = MobileNetV2Encoder(in_channels, dtype=dtype, **enc_kw)
        elif encoder_name in MOBILEONE_SPECS:
            self.encoder = MobileOneEncoder(encoder_name, in_channels, dtype=dtype, **enc_kw)
        else:
            self.encoder = ResNetEncoder(encoder_name, in_channels, dtype=dtype,
                                         s2d_stem=s2d_stem, **enc_kw)
        self.decoder = decoder(self.encoder.out_channels, dtype=dtype)
        self.segmentation_head = SegmentationHead(head_ch, classes, dtype=dtype, kernel=head_k)
        if use_metadata:
            self.enc = MetadataMLP(dtype=dtype)

    @property
    def up(self) -> int:
        """The head's upsample factor: the tile over the head's logits (1
        for the archs that decode at full resolution)."""
        return HEAD_UPSAMPLE.get(self.arch, 1)

    def zone_tail(self) -> TailParams | StridedTail:
        """The zone tail's parameters: ``fused_tail``'s (the last block with
        its BatchNorm as (scale, shift), and the head) for
        :data:`FUSED_TAIL_ARCHS`, ``StridedTail`` for the others."""
        if self.arch in FUSED_TAIL_ARCHS:
            return tail_params(self, self.dtype)
        return StridedTail(self.up, self.n_classes, self.segmentation_head[0].weight.device)

    @property
    def n_classes(self) -> int:
        return self.segmentation_head[0].out_channels

    def prepare_inference(self) -> None:
        """Conv weights in the compute dtype and each BatchNorm's (scale,
        shift), once, after the weights are loaded and moved (see
        ``models/resnet.py:prepare_inference``); the squeeze-excite convs'
        biases in the compute dtype too, as their convs run in it; a
        MobileOne block's terms' (scale, shift) stacked for ``branch_sum``."""
        prepare_inference(self, self.dtype)
        with torch.no_grad():
            if isinstance(self.encoder, EfficientNetEncoder):
                for block in self.encoder._blocks:
                    for m in (block._se_reduce, block._se_expand):
                        m.bias.data = m.bias.data.to(self.dtype)
            if isinstance(self.encoder, MobileOneEncoder):
                for block in self.encoder.blocks():
                    block.sum_scale_shift = block.stack_scale_shift()
                    if block.se is not None:
                        for m in (block.se.reduce, block.se.expand):
                            m.bias.data = m.bias.data.to(self.dtype)

    def features(self, x: torch.Tensor, epilogue=conv_epilogue, mtd: torch.Tensor | None = None,
                 dropout=None, se_gate=squeeze_excite,
                 branch_sum=block_epilogue) -> list[torch.Tensor]:
        """x (B, H, W, C) -> encoder features, NCHW views of NHWC memory.
        ``epilogue`` runs every conv epilogue of the model (the kernel
        wrapper, or a caller's plain version), ``se_gate`` EfficientNet's
        squeeze-excite sites (``ops/se_gate.py``: the kernels, or
        ``squeeze_excite_plain``), ``branch_sum`` MobileOne's blocks after
        their convs (``ops/branch_sum.py``: ``block_epilogue``, or
        ``block_epilogue_plain``). A metadata model adds the MLP's
        embedding of ``mtd`` (B, 45) to the deepest feature, its dropout
        ``dropout_part(dropout, "enc")`` (``MetadataMLP.forward``: None in
        eval)."""
        x = x.permute(0, 3, 1, 2)
        if isinstance(self.encoder, EfficientNetEncoder):
            feats = self.encoder(x, epilogue, se_gate, dropout_part(dropout, "drop_connect"))
        elif isinstance(self.encoder, MobileOneEncoder):
            if isinstance(epilogue, TrainSites):
                raise not_ported(f"training the {self.encoder_name!r} encoder",
                                 "slice 6: MobileOne training")
            feats = self.encoder(x, branch_sum)
        else:
            feats = self.encoder(x, epilogue)
        if self.use_metadata:
            if mtd is None:
                raise ValueError("use_metadata=True but no metadata passed")
            feats[-1] = fuse_metadata(feats[-1], self.enc(mtd, dropout_part(dropout, "enc")))
        return feats

    def forward(self, x: torch.Tensor, inner_margin: int | None = None,
                epilogue=conv_epilogue, mtd: torch.Tensor | None = None,
                dropout=None, se_gate=squeeze_excite, branch_sum=block_epilogue) -> torch.Tensor:
        """x (B, H, W, C) -> float32 logits (B, H, W, K), or with
        ``inner_margin`` m the interior logits (B, H-2m, W-2m, K);
        ``dropout``: see :func:`dropout_part` (None in eval)."""
        return self.decode(self.features(x, epilogue, mtd, dropout, se_gate, branch_sum),
                           inner_margin, epilogue, dropout=dropout)

    def head_logits(self, feats: list[torch.Tensor], epilogue=conv_epilogue,
                    group_norm=group_norm_relu, dropout=None) -> torch.Tensor:
        """A non-unet model's decoder and head on whole tiles: the head's
        float32 logits (B, S / up, S / up, K), contiguous. ``group_norm``
        runs FPN's GroupNorm sites at inference (the kernel wrapper, or a
        caller's plain version); ``dropout`` as :meth:`forward`'s."""
        kw = {"group_norm": group_norm} if self.arch == "fpn" else {}
        if self.arch in DROPOUT_ARCHS:
            kw["keep"] = dropout_part(dropout, "decoder")
        logits = self.segmentation_head(self.decoder(feats, epilogue=epilogue, **kw))
        return logits.permute(0, 2, 3, 1).contiguous()

    def decode(self, feats: list[torch.Tensor], inner_margin: int | None = None,
               epilogue=conv_epilogue, group_norm=group_norm_relu,
               dropout=None) -> torch.Tensor:
        """The decoder and head on encoder features -> float32 logits (B, H,
        W, K), or with ``inner_margin`` m rows and columns [m, S - m) only:
        unet's interior decode (bit-identical to the crop), the strided-head
        archs' windowed upsample of the head (the rows of the full
        upsample's matrices), the crop of the full decode for linknet,
        manet and unetplusplus."""
        S = feats[0].shape[-1]  # feats[0] is the input: the tile size
        m = inner_margin or 0
        if self.arch != "unet":
            g = StridedGeometry(S, m, self.up)
            return upsample_window(self.head_logits(feats, epilogue, group_norm, dropout),
                                   g).contiguous()
        if inner_margin is None:
            logits = self.segmentation_head(self.decoder(feats, epilogue=epilogue))
        else:
            y, off = self.decoder(feats, inner_margin=m, epilogue=epilogue)
            logits = self.segmentation_head(y)[:, :, m - off:S - m - off,
                                                m - off:S - m - off]
        return logits.permute(0, 2, 3, 1)

    def tail_input(self, x: torch.Tensor, margin: int, epilogue=conv_epilogue,
                   mtd: torch.Tensor | None = None, group_norm=group_norm_relu,
                   se_gate=squeeze_excite, branch_sum=block_epilogue) -> torch.Tensor:
        """The input of the zone's tail kernel: the encoder, then
        :meth:`decode_tail`."""
        return self.decode_tail(self.features(x, epilogue, mtd, se_gate=se_gate,
                                              branch_sum=branch_sum), margin, epilogue,
                                group_norm)

    def decode_tail(self, feats: list[torch.Tensor], margin: int, epilogue=conv_epilogue,
                    group_norm=group_norm_relu) -> torch.Tensor:
        """The tail kernel's input from encoder features. unet: all decoder
        blocks but the last on the interior plan of ``margin``; manet and
        unetplusplus: the decoder through the node before the last on whole
        tiles (their attention and dense nodes are not local), cropped to
        the extent that plan gives block 3 (``plan_inner_crops(S, m)[-2]``,
        the whole map at margin 0); both in the compute dtype and
        channels_last (``ops/fused_tail.py``). The other archs: the whole
        tile's head logits (:meth:`head_logits`), which
        ``ops/strided_tail.py`` upsamples and crops to ``margin``."""
        if self.arch not in FUSED_TAIL_ARCHS:
            return self.head_logits(feats, epilogue, group_norm)
        if self.arch == "unet":
            x3, _ = self.decoder.inner(feats, margin, len(self.decoder.blocks) - 1, epilogue)
        else:
            lo, hi = plan_inner_crops(feats[0].shape[-1], margin)[-2]["post"]
            x3 = self.decoder.penultimate(feats, epilogue)[:, :, lo:hi, lo:hi]
        return x3.contiguous(memory_format=torch.channels_last)


# flax's variance_scaling(1, "fan_in", "truncated_normal"): the standard
# deviation of a unit normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Flax's initial distributions (``flairtpu/models/resnet.py:104``), from
    a CPU ``torch.Generator`` seeded with ``seed``: conv and dense kernels
    ``lecun_normal`` (a normal truncated at two standard deviations, scaled
    to variance 1 / fan_in), biases zero, BatchNorm gamma 1, beta 0, mean 0,
    var 1. A transposed conv's fan_in is k * k * its input channels, as
    ``flairtpu``'s ``TorchConvTranspose`` draws its (k, k, in, out) kernel
    (``flairtpu/models/smp_extra.py:176-177``); torch keeps that weight as
    (in, out, k, k). The same distributions as ``flairtpu``'s, not the same
    values."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = (m.weight[:, 0].numel() if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0].numel())
            std = (1.0 / fan_in) ** 0.5 / TRUNC_STD
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1)


def create_model(config: dict, dtype=torch.float32) -> FlairSegmentationModel:
    """Build the model a flair or flair-detect config describes."""
    mf = config["model_framework"]
    if mf["model_provider"] != "SegmentationModelsPytorch":
        raise not_ported(f"model provider {mf['model_provider']!r}", "slice 7")
    encoder, arch = check_smp(mf["SegmentationModelsPytorch"]["encoder_decoder"])
    n_classes = config.get("n_classes") or len(config["classes"])
    return FlairSegmentationModel(encoder, int(n_classes), len(config["channels"]), dtype=dtype,
                                  use_metadata=bool(config.get("use_metadata", False)),
                                  arch=arch, s2d_stem=bool(config.get("s2d_stem", False)))
