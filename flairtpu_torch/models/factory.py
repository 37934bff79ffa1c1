"""Model factory: config -> segmentation model
(counterpart of ``flairtpu/models/factory.py:256-274, 304-327``).

Slice 1 builds the smp U-Net over the resnet encoders; with
``use_metadata`` the model also carries the metadata MLP (``enc``, the
reference's key names) and adds its embedding to the deepest encoder
feature (``models/metadata_mlp.py``). The model's public functions keep
``flairtpu``'s layout: input (B, H, W, C), logits (B, h, w, K) float32.
Inside, tensors are NCHW views of NHWC memory (``channels_last``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from flairtpu_torch.config import check_smp, not_ported
from flairtpu_torch.models.metadata_mlp import MetadataMLP, fuse_metadata
from flairtpu_torch.models.resnet import ResNetEncoder, prepare_inference
from flairtpu_torch.models.unet import SegmentationHead, UnetDecoder
from flairtpu_torch.ops.epilogue import conv_epilogue


class FlairSegmentationModel(nn.Module):
    """smp ``Unet(encoder_name, classes, in_channels)`` with smp's key names."""

    arch = "unet"

    def __init__(self, encoder_name: str = "resnet34", classes: int = 13,
                 in_channels: int = 5, dtype=torch.float32, use_metadata: bool = False):
        super().__init__()
        self.dtype = dtype
        self.encoder_name = encoder_name
        self.use_metadata = use_metadata
        self.encoder = ResNetEncoder(encoder_name, in_channels, dtype=dtype)
        self.decoder = UnetDecoder(self.encoder.out_channels, dtype=dtype)
        self.segmentation_head = SegmentationHead(16, classes, dtype=dtype)
        if use_metadata:
            self.enc = MetadataMLP(dtype=dtype)

    def prepare_inference(self) -> None:
        """Conv weights in the compute dtype and each BatchNorm's (scale,
        shift), once, after the weights are loaded and moved (see
        ``models/resnet.py:prepare_inference``)."""
        prepare_inference(self, self.dtype)

    def features(self, x: torch.Tensor, epilogue=conv_epilogue, mtd: torch.Tensor | None = None,
                 dropout=None) -> list[torch.Tensor]:
        """x (B, H, W, C) -> encoder features, NCHW views of NHWC memory.
        ``epilogue`` runs every conv epilogue of the model (the kernel
        wrapper, or a caller's plain version). A metadata model adds the
        MLP's embedding of ``mtd`` (B, 45) to the deepest feature;
        ``dropout`` is the MLP's (``MetadataMLP.forward``: None in eval)."""
        feats = self.encoder(x.permute(0, 3, 1, 2), epilogue)
        if self.use_metadata:
            if mtd is None:
                raise ValueError("use_metadata=True but no metadata passed")
            feats[-1] = fuse_metadata(feats[-1], self.enc(mtd, dropout))
        return feats

    def forward(self, x: torch.Tensor, inner_margin: int | None = None,
                epilogue=conv_epilogue, mtd: torch.Tensor | None = None,
                dropout=None) -> torch.Tensor:
        """x (B, H, W, C) -> float32 logits (B, H, W, K), or with
        ``inner_margin`` m the interior logits (B, H-2m, W-2m, K)."""
        return self.decode(self.features(x, epilogue, mtd, dropout), inner_margin, epilogue)

    def decode(self, feats: list[torch.Tensor], inner_margin: int | None = None,
               epilogue=conv_epilogue) -> torch.Tensor:
        if inner_margin is None:
            logits = self.segmentation_head(self.decoder(feats, epilogue=epilogue))
        else:
            m, S = inner_margin, feats[0].shape[-1]
            y, off = self.decoder(feats, inner_margin=m, epilogue=epilogue)
            logits = self.segmentation_head(y)[:, :, m - off:S - m - off,
                                                m - off:S - m - off]
        return logits.permute(0, 2, 3, 1)

    def tail_input(self, x: torch.Tensor, margin: int, epilogue=conv_epilogue,
                   mtd: torch.Tensor | None = None) -> torch.Tensor:
        """Encoder and all decoder blocks but the last, on the interior plan:
        the input of the fused decoder tail (ops/fused_tail.py), in the
        compute dtype and channels_last."""
        feats = self.features(x, epilogue, mtd)
        x3, _ = self.decoder.inner(feats, margin, len(self.decoder.blocks) - 1, epilogue)
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
    var 1. The same distributions as ``flairtpu``'s, not the same values."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
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
    encoder, _ = check_smp(mf["SegmentationModelsPytorch"]["encoder_decoder"])
    n_classes = config.get("n_classes") or len(config["classes"])
    return FlairSegmentationModel(encoder, int(n_classes), len(config["channels"]), dtype=dtype,
                                  use_metadata=bool(config.get("use_metadata", False)))
