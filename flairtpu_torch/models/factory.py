"""Model factory: config -> segmentation model
(counterpart of ``flairtpu/models/factory.py:256-274, 304-327``).

Slice 1 builds the smp U-Net over the resnet encoders. The model's public
functions keep ``flairtpu``'s layout: input (B, H, W, C), logits
(B, h, w, K) float32. Inside, tensors are NCHW views of NHWC memory
(``channels_last``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from flairtpu_torch.config import check_smp, not_ported
from flairtpu_torch.models.resnet import ResNetEncoder, prepare_inference
from flairtpu_torch.models.unet import SegmentationHead, UnetDecoder
from flairtpu_torch.ops.epilogue import conv_epilogue


class FlairSegmentationModel(nn.Module):
    """smp ``Unet(encoder_name, classes, in_channels)`` with smp's key names."""

    arch = "unet"

    def __init__(self, encoder_name: str = "resnet34", classes: int = 13,
                 in_channels: int = 5, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = ResNetEncoder(encoder_name, in_channels, dtype=dtype)
        self.decoder = UnetDecoder(self.encoder.out_channels, dtype=dtype)
        self.segmentation_head = SegmentationHead(16, classes, dtype=dtype)

    def prepare_inference(self) -> None:
        """Conv weights in the compute dtype and each BatchNorm's (scale,
        shift), once, after the weights are loaded and moved (see
        ``models/resnet.py:prepare_inference``)."""
        prepare_inference(self, self.dtype)

    def features(self, x: torch.Tensor, epilogue=conv_epilogue) -> list[torch.Tensor]:
        """x (B, H, W, C) -> encoder features, NCHW views of NHWC memory.
        ``epilogue`` runs every conv epilogue of the model (the kernel
        wrapper, or a caller's plain version)."""
        return self.encoder(x.permute(0, 3, 1, 2), epilogue)

    def forward(self, x: torch.Tensor, inner_margin: int | None = None,
                epilogue=conv_epilogue) -> torch.Tensor:
        """x (B, H, W, C) -> float32 logits (B, H, W, K), or with
        ``inner_margin`` m the interior logits (B, H-2m, W-2m, K)."""
        return self.decode(self.features(x, epilogue), inner_margin, epilogue)

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

    def tail_input(self, x: torch.Tensor, margin: int, epilogue=conv_epilogue) -> torch.Tensor:
        """Encoder and all decoder blocks but the last, on the interior plan:
        the input of the fused decoder tail (ops/fused_tail.py), in the
        compute dtype and channels_last."""
        feats = self.features(x, epilogue)
        x3, _ = self.decoder.inner(feats, margin, len(self.decoder.blocks) - 1, epilogue)
        return x3.contiguous(memory_format=torch.channels_last)


def create_model(config: dict, dtype=torch.float32) -> FlairSegmentationModel:
    """Build the model a flair-detect config describes."""
    mf = config["model_framework"]
    if mf["model_provider"] != "SegmentationModelsPytorch":
        raise not_ported(f"model provider {mf['model_provider']!r}", "slice 7")
    encoder, _ = check_smp(mf["SegmentationModelsPytorch"]["encoder_decoder"])
    n_classes = config.get("n_classes") or len(config["classes"])
    return FlairSegmentationModel(encoder, int(n_classes),
                                  len(config["channels"]), dtype=dtype)
