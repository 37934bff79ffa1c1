"""Augment + normalize: each sample's D4 transform, the label cleaning and
the channel normalization of a batch in one pass
(``csrc/augment_normalize.cu``).

Replaces what XLA fused at the head of ``flairtpu``'s train step:
``flairtpu/data/augment.py:35-54`` (a vertical flip, then a horizontal flip,
then ``rot90`` by k, chosen per sample), ``flairtpu/train/loop.py:271-274``
(labels outside [0, K) become 0) and ``:339-342`` (``normalize_device``,
with the jitted arithmetic of ``data/normalize.py``). The mask arrives as
the uint8 read from disk (labels from 1); the pass subtracts the 1, so the
host sends a quarter of the int32 bytes. Eval and predict call it with the
identity (``choices`` None).

The choices are (B, 3) int32 rows (v, h, k), drawn by :func:`draw_choices`
from a ``torch.Generator`` with the reference's distribution: each flip with
probability 1/2, a rotation with probability 1/2 and then k uniform in
{0, 1, 2, 3}. JAX's key stream cannot be reproduced, so the tests hand both
packages the same choices.

``augment_normalize`` runs the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors; it has no fallback. The kernel has two
instances, and :func:`launch_plan` chooses one from the shapes and the
pointers' alignment: ``tiled`` (64 x 64 output tiles staged by cp.async,
16-byte stores) for square patches whose side is a multiple of TILE, at
most TILE_MAX_CHANNELS channels and 16-byte aligned tensors, which FLAIR's
train, eval and predict batches are; ``general`` (32 x 32 tiles, byte
loads and stores) for any other shape.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from flairtpu_torch.data.normalize import _check, reciprocal, scale_factor
from flairtpu_torch.ops import _build

ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int]
MAX_CHANNELS = 32
INSTANCES = {"general": 0, "tiled": 1}  # the C entry point's last argument
# the general instance (csrc/augment_normalize.cu kTile, kThreads)
GENERAL_TILE = 32
GENERAL_THREADS = 256
# the tiled instance (kBigTile, kBigThreads, kBigMaxChannels, kPadBytes, kAlign)
TILE = 64
TILE_THREADS = 256  # at most: a block is a whole number of a tile row's 16-byte chunks
TILE_MAX_CHANNELS = 8
PAD_BYTES = 4  # added to each staged row: an odd number of 4-byte words
ALIGN = 16

# kernel launches on CUDA tensors since the last reset (the CPU path does not
# count); tiled_launches counts those of the tiled instance among them
launches = 0
tiled_launches = 0


def norm_constants(norm_type: str, means=(), stds=(), channels: int = 0,
                   src_dtype=np.uint8) -> tuple[np.ndarray, np.ndarray]:
    """(mean, mul) float32 per channel with ``(x - mean) * mul`` equal bit for
    bit to ``data/normalize.py:normalize``: custom (mean, 1/std), scaling
    (0, 1/max), without (0, 1)."""
    _check(norm_type, means, stds)
    if norm_type == "custom":
        return np.asarray(means, np.float32), reciprocal(stds)
    mul = reciprocal(scale_factor(src_dtype)) if norm_type == "scaling" else np.float32(1)
    return np.zeros(channels, np.float32), np.full(channels, mul, np.float32)


def draw_choices(batch: int, generator: torch.Generator) -> torch.Tensor:
    """(batch, 3) int32 (v, h, k) on the generator's device:
    ``flairtpu/data/augment.py:35-40``'s distribution."""
    dev = generator.device
    bits = torch.randint(0, 2, (batch, 3), generator=generator, device=dev, dtype=torch.int32)
    k = torch.randint(0, 4, (batch,), generator=generator, device=dev, dtype=torch.int32)
    return torch.stack([bits[:, 0], bits[:, 1], k * bits[:, 2]], dim=1).contiguous()


def transform_plain(a: torch.Tensor, v: int, h: int, k: int) -> torch.Tensor:
    """One sample (H, W, ...): flip rows if v, then columns if h, then
    ``np.rot90`` by k on axes (0, 1)."""
    if v:
        a = a.flip(0)
    if h:
        a = a.flip(1)
    return torch.rot90(a, k, dims=(0, 1))


def augment_normalize_plain(img: torch.Tensor, mask: torch.Tensor | None,
                            choices: torch.Tensor | None, mean: torch.Tensor,
                            mul: torch.Tensor, n_classes: int,
                            dtype: torch.dtype = torch.float32):
    """img (B, H, W, C) uint8, mask (B, H, W) uint8 from disk or None ->
    (x (B, H, W, C) in ``dtype``, target (B, H, W) int32 or None)."""
    x = (img.float() - mean) * mul
    tgt = None
    if mask is not None:
        t = mask.to(torch.int32) - 1
        tgt = torch.where((t >= 0) & (t < n_classes), t, torch.zeros_like(t))
    if choices is not None:
        ch = choices.tolist()
        x = torch.stack([transform_plain(x[b], *ch[b]) for b in range(len(ch))])
        if tgt is not None:
            tgt = torch.stack([transform_plain(tgt[b], *ch[b]) for b in range(len(ch))])
    x = x.to(dtype).contiguous()
    return x, (None if tgt is None else tgt.contiguous())


class Plan(NamedTuple):
    """One call's launch: the instance, its grid (x: tile columns, y: tile
    rows, z: samples), threads a block and dynamic shared memory."""
    instance: str
    grid: tuple[int, int, int]
    threads: int
    smem_bytes: int


def launch_plan(batch: int, height: int, width: int, channels: int, out_dtype: torch.dtype,
                has_mask: bool, aligned: bool) -> Plan:
    """The instance and launch of a call. ``aligned``: every pointer (image,
    mask, output, targets) is 16-byte aligned. The tiled instance takes
    square patches whose side is a multiple of TILE (so every staged row,
    W * C bytes and each output row of a tile are whole 16-byte chunks) with
    at most TILE_MAX_CHANNELS channels; any other shape goes to the general
    instance."""
    if (height == width and height % TILE == 0 and channels <= TILE_MAX_CHANNELS
            and aligned):
        chunks = TILE * channels // (4 if out_dtype == torch.float32 else 8)  # a tile row's
        threads = chunks * max(1, TILE_THREADS // chunks)
        smem = TILE * (TILE * channels + PAD_BYTES) + (TILE * (TILE + PAD_BYTES)
                                                       if has_mask else 0)
        return Plan("tiled", (width // TILE, height // TILE, batch), threads, smem)
    return Plan("general", (-(-width // GENERAL_TILE), -(-height // GENERAL_TILE), batch),
                GENERAL_THREADS, GENERAL_TILE * GENERAL_TILE * (channels + 1))


def _check_inputs(img, mask, choices, mean, mul) -> None:
    if img.dtype != torch.uint8 or img.dim() != 4 or not img.is_contiguous():
        raise ValueError(f"augment_normalize: img must be a contiguous (B, H, W, C) uint8 "
                         f"tensor, got {img.dtype} {tuple(img.shape)}")
    B, H, W, C = img.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"augment_normalize: {C} channels (at most {MAX_CHANNELS})")
    if mask is not None and (mask.dtype != torch.uint8 or tuple(mask.shape) != (B, H, W)
                             or not mask.is_contiguous() or mask.device != img.device):
        raise ValueError(f"augment_normalize: mask must be a contiguous ({B}, {H}, {W}) "
                         f"uint8 tensor on {img.device}")
    if choices is not None:
        if (choices.dtype != torch.int32 or tuple(choices.shape) != (B, 3)
                or not choices.is_contiguous() or choices.device != img.device):
            raise ValueError(f"augment_normalize: choices must be a contiguous ({B}, 3) "
                             f"int32 tensor on {img.device}")
        if H != W:
            raise ValueError("augment_normalize: a rotation needs square patches, got "
                             f"{H} x {W}")
    for name, v in (("mean", mean), ("mul", mul)):
        if (v.dtype != torch.float32 or tuple(v.shape) != (C,) or v.device != img.device
                or not v.is_contiguous()):
            raise ValueError(f"augment_normalize: {name} must be a contiguous ({C},) "
                             f"float32 tensor on {img.device}")


def _on_card(img: torch.Tensor) -> bool:
    if img.device.type == "cpu":
        return False
    if img.device.type != "cuda":
        raise RuntimeError(f"augment_normalize: unsupported device {img.device}")
    return True


def augment_normalize(img: torch.Tensor, mask: torch.Tensor | None,
                      choices: torch.Tensor | None, mean: torch.Tensor, mul: torch.Tensor,
                      n_classes: int, dtype: torch.dtype = torch.float32):
    """As :func:`augment_normalize_plain`. CPU tensors: the plain version.
    CUDA tensors: the kernel (bfloat16 or float32 output), or an error."""
    global launches, tiled_launches
    _check_inputs(img, mask, choices, mean, mul)
    if not _on_card(img):
        return augment_normalize_plain(img, mask, choices, mean, mul, n_classes, dtype)
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"augment_normalize: output dtype {dtype} (the kernel writes "
                        "bfloat16 or float32)")
    B, H, W, C = img.shape
    x = torch.empty((B, H, W, C), dtype=dtype, device=img.device)
    tgt = (torch.empty((B, H, W), dtype=torch.int32, device=img.device)
           if mask is not None else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    aligned = all(t.data_ptr() % ALIGN == 0 for t in (img, mask, x, tgt) if t is not None)
    plan = launch_plan(B, H, W, C, dtype, mask is not None, aligned)
    err = _build.entry("augment_normalize", ARGTYPES)(
        ptr(img), ptr(mask), ptr(choices), ptr(mean), ptr(mul), ptr(x), ptr(tgt),
        B, H, W, C, n_classes, int(dtype == torch.float32), _build.stream_handle(img),
        INSTANCES[plan.instance])
    _build.check(err, "augment_normalize")
    launches += 1
    tiled_launches += int(plan.instance == "tiled")
    return x, tgt
