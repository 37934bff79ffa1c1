"""Metadata MLP and its fusion into the deepest encoder feature (counterpart
of ``flairtpu/models/metadata_mlp.py``; reference src/flair/model.py:56-62,
82-92).

Three stages of Linear, Dropout(0.4), ReLU, 45 -> 64 -> 32 -> 16, with the
reference's module names: the Linears are ``enc_mlp.0``, ``.3`` and ``.6``,
so a FLAIR ``.pth`` with the MLP (``enc.enc_mlp.*`` on the model) loads
strictly. The Linears run in the compute dtype on float32 parameters, as
Flax's ``Dense(dtype=...)``. Dropout draws its keep masks from a
``torch.Generator`` the caller passes (the trainer's), never from PyTorch's
global generator, so a snapshot of that generator resumes the masks too;
a caller may also hand the masks in.

The fusion adds the 16-d embedding to the deepest feature map indexed by its
height: every channel and column of row h gets ``emb[b, h]`` (the reference
reshapes (B, 16) to (B, 1, 16, 1) and repeats it over (B, 512, 16, 16)), so
the deepest map must be 16 x 16, which 512 x 512 inputs give.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

METADATA_WIDTHS = (45, 64, 32, 16)
DROPOUT_RATE = 0.4


class Dropout(nn.Module):
    """Flax's ``nn.Dropout``: kept values scaled by ``1 / (1 - rate)``, the
    others zero. Holds no state; :class:`MetadataMLP` passes the mask."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class MetadataMLP(nn.Module):
    """(B, 45) metadata -> (B, 16) embedding in the compute dtype."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        layers = []
        for n_in, n_out in zip(METADATA_WIDTHS[:-1], METADATA_WIDTHS[1:]):
            layers += [nn.Linear(n_in, n_out), Dropout(DROPOUT_RATE), nn.ReLU()]
        self.enc_mlp = nn.Sequential(*layers)

    def draw_masks(self, batch: int, generator: torch.Generator) -> list[torch.Tensor]:
        """One bool keep mask per stage, (batch, width), each element kept
        with probability 1 - DROPOUT_RATE, drawn from ``generator`` on its
        device."""
        keep = 1.0 - DROPOUT_RATE
        return [torch.rand((batch, w), generator=generator, device=generator.device) < keep
                for w in METADATA_WIDTHS[1:]]

    def forward(self, mtd: torch.Tensor,
                dropout: torch.Generator | Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        """``dropout``: None in eval (deterministic); in train a
        ``torch.Generator`` to draw the keep masks from, or the three keep
        masks themselves."""
        if isinstance(dropout, torch.Generator):
            dropout = self.draw_masks(mtd.shape[0], dropout)
        x = mtd.to(self.dtype)
        mods = list(self.enc_mlp)
        for i in range(0, len(mods), 3):
            linear, drop, relu = mods[i:i + 3]
            x = F.linear(x, linear.weight.to(self.dtype), linear.bias.to(self.dtype))
            if dropout is not None:
                x = drop(x, dropout[i // 3])
            x = relu(x)
        return x


def fuse_metadata(feature: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """``feature`` (B, C, H, W), an NCHW view of channels_last memory, plus
    the (B, H) embedding at every channel and column of row h; the result
    stays channels_last."""
    B, C, H, W = feature.shape
    if H != embedding.shape[-1]:
        raise ValueError(
            f"metadata fusion requires the deepest feature height ({H}) to equal "
            f"the embedding size ({embedding.shape[-1]}); use 512x512 inputs")
    out = feature + embedding[:, None, :, None].to(feature.dtype)
    return out.contiguous(memory_format=torch.channels_last)
