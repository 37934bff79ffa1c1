"""Pretrained-encoder initialization from bare classifier checkpoints
(counterpart of ``flairtpu/models/pretrained.py``, for the families the
port builds: the resnets and resnexts, efficientnet-b0..b7 from an
efficientnet-pytorch classifier, mobilenet_v2 from torchvision's, and
mobileone_s0..s4 from Apple's).

The reference never trains encoders from scratch: ``smp.create_model``
defaults ``encoder_weights="imagenet"`` (ref src/flair/model.py:35-41),
which loads an ImageNet classifier state dict into the encoder and adapts
the first conv from 3 input channels to ``in_channels`` (smp
``encoders/_utils.py patch_first_conv``). With no download, the train
config's ``init_encoder_weights: <path>.pth`` takes such a torchvision-keyed
state dict, and the same pipeline runs: the classifier head (``fc.*``; an
efficientnet's ``_fc``, ``_conv_head``, ``_bn1`` and the modules beside
them, top-level keys only: a block's ``_bn1`` stays; a MobileNetV2's
``classifier.*``; a MobileOne's ``linear.*`` and ``gap.*``) and the
BatchNorm counters go, the first 3-channel conv (the stem: ``conv1``,
``_conv_stem`` or ``features.0.0``; for MobileOne every 3-channel conv of
``stage0``, :func:`patch_mobileone_stem`) is adapted with smp's rule, the
keys take the ``encoder.`` prefix, and the result must
cover the model's encoder exactly (every key, every shape) before it is
loaded. The decoder, the
head and the metadata MLP keep their initial values.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from flairtpu_torch.config import PORTED_ENCODERS, not_ported
from flairtpu_torch.models.convert import load_torch_state_dict

# classifier-head key prefixes safe to drop for every supported family: no
# encoder keeps top-level tensors under these names
_COMMON_HEAD_PREFIXES = (
    "fc.", "classifier.", "last_linear.", "head.", "global_pool.", "logits.")
# efficientnet-pytorch's head, after the blocks (smp's EfficientNetEncoder
# keeps _conv_stem, _bn0 and _blocks; flairtpu/models/pretrained.py:47-48)
_EN_HEAD_PREFIXES = (
    "_fc.", "_conv_head.", "_bn1.", "_avg_pooling.", "_dropout.", "_swish.")
# Apple's MobileOne classifier head (smp's MobileOneEncoder deletes gap and
# linear; flairtpu/models/pretrained.py:79-81)
_MOBILEONE_HEAD_PREFIXES = ("linear.", "gap.")

# the families flairtpu converts (flairtpu/models/pretrained.py:55-63); the
# port builds the resnets (resnexts among them), efficientnet-b0..b7,
# mobilenet_v2 and mobileone_s0..s4
_SUPPORTED_PREFIXES = (
    "resnet", "resnext", "senet154", "se_resnet", "se_resnext",
    "efficientnet", "timm-efficientnet", "timm-mobilenetv3",
    "timm-resnest", "timm-res2net", "timm-res2next", "timm-skresnet",
    "timm-skresnext", "timm-regnet", "timm-gernet",
    "mobilenet_v2", "vgg", "densenet", "xception",
    "inceptionv4", "inceptionresnetv2", "dpn",
    "mobileone", "mit",
)


def _adapt_conv(w: np.ndarray, in_channels: int, default: int) -> np.ndarray:
    """smp's first-conv channel rule on one OIHW conv weight."""
    if in_channels == 1:
        return w.sum(axis=1, keepdims=True).astype(w.dtype)
    new = np.stack([w[:, i % default] for i in range(in_channels)], axis=1)
    return (new * (default / in_channels)).astype(w.dtype)


def patch_first_conv(sd: Mapping[str, np.ndarray], in_channels: int,
                     default: int = 3) -> dict[str, np.ndarray]:
    """smp ``patch_first_conv`` on a state dict: the first
    ``default``-input-channel conv weight in key order is rebuilt for
    ``in_channels`` (channel-sum for 1, else cyclic channel repeat scaled by
    ``default / in_channels``)."""
    key = next(
        (k for k, v in sd.items()
         if k.endswith("weight") and getattr(np.asarray(v), "ndim", 0) == 4
         and np.asarray(v).shape[1] == default),
        None)
    if key is None:
        raise ValueError(
            f"no {default}-input-channel conv found to adapt to "
            f"{in_channels} channels — is this a bare ImageNet classifier "
            "state dict?")
    out = dict(sd)
    if in_channels == default:
        return out
    out[key] = _adapt_conv(np.asarray(sd[key]), in_channels, default)
    return out


def patch_mobileone_stem(sd: Mapping[str, np.ndarray], in_channels: int,
                         default: int = 3) -> dict[str, np.ndarray]:
    """MobileOne's stem adaptation (``flairtpu/models/pretrained.py:121-148``,
    DEVIATIONS.md #17): smp's channel rule on EVERY ``stage0`` conv that
    reads the input (its k x k branches and its 1x1 scale branch), where
    smp's ``patch_first_conv`` would adapt the first alone and leave a stem
    that cannot run at ``in_channels`` != 3."""
    keys = [k for k, v in sd.items()
            if k.startswith("stage0.") and k.endswith("weight")
            and getattr(np.asarray(v), "ndim", 0) == 4
            and np.asarray(v).shape[1] == default]
    if not keys:
        raise ValueError(
            f"no {default}-input-channel stage0 conv found to adapt to "
            f"{in_channels} channels — is this a bare MobileOne classifier "
            "state dict?")
    out = dict(sd)
    if in_channels == default:
        return out
    for k in keys:
        out[k] = _adapt_conv(np.asarray(sd[k]), in_channels, default)
    return out


def classifier_to_encoder_state_dict(
        sd: Mapping[str, np.ndarray], encoder_name: str,
        in_channels: int) -> dict[str, np.ndarray]:
    """Bare ImageNet classifier state dict -> smp-encoder-namespace dict."""
    if encoder_name not in PORTED_ENCODERS:
        if encoder_name.startswith(_SUPPORTED_PREFIXES):
            raise not_ported(f"init_encoder_weights for encoder {encoder_name!r}",
                             "slice 6: other smp encoders")
        raise ValueError(
            f"init_encoder_weights: encoder family of {encoder_name!r} has "
            "no classifier-checkpoint converter (supported prefixes: "
            f"{', '.join(_SUPPORTED_PREFIXES)})")
    drop = _COMMON_HEAD_PREFIXES
    if encoder_name.startswith("efficientnet"):
        drop += _EN_HEAD_PREFIXES
    if encoder_name.startswith("mobileone"):
        drop += _MOBILEONE_HEAD_PREFIXES
    sd = {k: v for k, v in sd.items()
          if not k.startswith(drop) and not k.endswith("num_batches_tracked")}
    if not sd:
        raise ValueError("init_encoder_weights: state dict is empty after "
                         "dropping classifier-head keys")
    if encoder_name.startswith("mobileone"):
        sd = patch_mobileone_stem(sd, in_channels)
    else:
        sd = patch_first_conv(sd, in_channels)
    return {"encoder." + k: v for k, v in sd.items()}


def stem_in_channels(encoder: torch.nn.Module) -> int:
    """The input channels of an encoder's stem conv (a resnet's ``conv1``,
    an efficientnet's ``_conv_stem``, a MobileNetV2's ``features.0.0``, a
    MobileOne's ``stage0`` branches)."""
    if hasattr(encoder, "stage0"):
        return encoder.stage0.rbr_conv[0].conv.in_channels
    if hasattr(encoder, "features"):
        return encoder.features[0][0].in_channels
    stem = getattr(encoder, "_conv_stem", None) or encoder.conv1
    return stem.in_channels


def init_encoder_from_classifier(path: str | Path, model: torch.nn.Module) -> None:
    """Load a bare classifier ``.pth`` into ``model``'s encoder, in place.
    Raises, loading nothing, when the converted encoder does not cover the
    model's exactly (missing or unexpected keys, or any shape mismatch)."""
    enc = classifier_to_encoder_state_dict(load_torch_state_dict(path), model.encoder_name,
                                           stem_in_channels(model.encoder))
    want = {f"encoder.{k}": v for k, v in model.encoder.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    problems = [f"missing {k}" for k in sorted(want.keys() - enc.keys())]
    problems += [f"unexpected {k}" for k in sorted(enc.keys() - want.keys())]
    problems += [f"shape mismatch {k}: {tuple(np.shape(enc[k]))} vs {tuple(want[k].shape)}"
                 for k in sorted(enc.keys() & want.keys())
                 if tuple(np.shape(enc[k])) != tuple(want[k].shape)]
    if problems:
        raise ValueError("checkpoint does not match model:\n  " + "\n  ".join(problems))
    with torch.no_grad():
        for k, t in want.items():
            t.copy_(torch.from_numpy(np.ascontiguousarray(enc[k])))
