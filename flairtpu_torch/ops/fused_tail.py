"""Fused decoder tail: the last U-Net decoder block, the segmentation head and
the softmax max/argmax epilogue in one CUDA kernel (``csrc/fused_tail.cu``).

Port of the Pallas kernel ``benchmarks/pallas_fused_tail.py:make_kernel``,
generalized to any tile size, margin and class count (K <= 32), with the
last block's BatchNorm applied as a per-channel (scale, shift) epilogue. It
replaces, on the zone main path, the stretch ``flairtpu`` runs as XLA:
``models/unet.py:145-154`` (block 4), ``models/factory.py:270-274`` (head and
crop) and ``zone/device_engine.py:143-146`` (epilogue).

``fused_tail`` runs the plain PyTorch version for a CPU tensor and launches
the kernel for a CUDA tensor; it has no fallback.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from flairtpu_torch.models.resnet import bn_scale_shift
from flairtpu_torch.models.unet import plan_inner_crops, upsample2x_nearest
from flairtpu_torch.ops import _build
from flairtpu_torch.ops.fused import prob_to_u8, softmax_argmax

C3, C4 = 32, 16  # channels into and of the last decoder block (every resnet unet)
MAX_CLASSES = 32

# kernel launches on CUDA tensors since the last reset (the CPU path does not count)
launches = 0


@dataclass(frozen=True)
class TailGeometry:
    """Where the tail reads and writes, derived from ``plan_inner_crops``.

    x3_extent: square extent of block 3's output (the tail's input);
    up_crop: offset of block 4's extent in the 2x-upsampled x3;
    b4_extent: square extent block 4 computes;
    head_crop: offset of the kept s x s interior in block 4's extent;
    out_extent: s = size - 2 * margin.
    """

    x3_extent: int
    up_crop: int
    b4_extent: int
    head_crop: int
    out_extent: int


def tail_geometry(size: int, margin: int, n_blocks: int = 5) -> TailGeometry:
    plans = plan_inner_crops(size, margin, n_blocks)
    lo3, hi3 = plans[-2]["post"]
    lo4, hi4 = plans[-1]["post"]
    return TailGeometry(hi3 - lo3, lo4 - 2 * lo3, hi4 - lo4, margin - lo4,
                        size - 2 * margin)


@dataclass
class TailParams:
    """float32 tensors; conv weights in torch (O, I, 3, 3) layout, holding
    values already rounded to the compute dtype."""

    w1: torch.Tensor
    scale1: torch.Tensor
    shift1: torch.Tensor
    w2: torch.Tensor
    scale2: torch.Tensor
    shift2: torch.Tensor
    wh: torch.Tensor
    bias: torch.Tensor

    @property
    def n_classes(self) -> int:
        return self.wh.shape[0]


def tail_params(model, dtype: torch.dtype) -> TailParams:
    """The tail's weights from a FlairSegmentationModel: the last decoder
    block's convs with their BatchNorm as (scale, shift), and the head."""
    block, head = model.decoder.blocks[-1], model.segmentation_head[0]

    def w(conv):
        return conv.weight.detach().to(dtype).float().contiguous()

    with torch.no_grad():
        s1, t1 = bn_scale_shift(block.conv1[1])
        s2, t2 = bn_scale_shift(block.conv2[1])
        return TailParams(w(block.conv1[0]), s1.contiguous(), t1.contiguous(),
                          w(block.conv2[0]), s2.contiguous(), t2.contiguous(),
                          w(head), head.bias.detach().float().contiguous())


def _chw(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def tail_logits_plain(x3: torch.Tensor, p: TailParams, g: TailGeometry) -> torch.Tensor:
    """Plain PyTorch tail up to the logits: x3 (B, 32, E3, E3) in the compute
    dtype -> float32 logits (B, K, s, s)."""
    dt = x3.dtype
    uc, e4, hc, s = g.up_crop, g.b4_extent, g.head_crop, g.out_extent
    y = upsample2x_nearest(x3)[:, :, uc:uc + e4, uc:uc + e4]
    y = F.conv2d(y, p.w1.to(dt), padding=1)
    y = F.relu(y.float() * _chw(p.scale1) + _chw(p.shift1)).to(dt)
    y = F.conv2d(y, p.w2.to(dt), padding=1)
    y = F.relu(y.float() * _chw(p.scale2) + _chw(p.shift2)).to(dt)
    # float32 logits: compute-dtype operands (exact in float32, and in TF32),
    # float32 sums, as the kernel's head
    logits = F.conv2d(y.float(), p.wh, padding=1)[:, :, hc:hc + s, hc:hc + s]
    return logits + _chw(p.bias)


def fused_tail_plain(x3: torch.Tensor, p: TailParams, g: TailGeometry):
    """Plain PyTorch tail: x3 -> (class, prob) uint8 (B, s, s)."""
    cls, prob = softmax_argmax(tail_logits_plain(x3, p, g), dim=1)
    return cls.to(torch.uint8), prob_to_u8(prob)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _bind(lib: ctypes.CDLL):
    fn = lib.fused_tail
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return fn


def fused_tail(x3: torch.Tensor, p: TailParams, g: TailGeometry):
    """x3 (B, 32, E3, E3), channels_last -> (class, prob) uint8 (B, s, s).

    CPU tensor: the plain version. CUDA tensor: the kernel, or an error."""
    global launches
    if x3.device.type == "cpu":
        return fused_tail_plain(x3, p, g)
    if x3.device.type != "cuda":
        raise RuntimeError(f"fused_tail: unsupported device {x3.device}")
    B, C, H, W = x3.shape
    if (C, H, W) != (C3, g.x3_extent, g.x3_extent):
        raise ValueError(f"fused_tail: x3 shape {tuple(x3.shape)} does not match "
                         f"(B, {C3}, {g.x3_extent}, {g.x3_extent})")
    if x3.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_tail: x3 dtype {x3.dtype} (bfloat16 or float32)")
    if not x3.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_tail: x3 must be channels_last contiguous")
    if not 1 <= p.n_classes <= MAX_CLASSES:
        raise ValueError(f"fused_tail: {p.n_classes} classes (at most {MAX_CLASSES})")
    weights = (p.w1, p.scale1, p.shift1, p.w2, p.scale2, p.shift2, p.wh, p.bias)
    for t in weights:
        if t.device != x3.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_tail: parameters must be contiguous float32 "
                             f"on {x3.device}")
    s = g.out_extent
    cls = torch.empty((B, s, s), dtype=torch.uint8, device=x3.device)
    prob = torch.empty_like(cls)
    err = _bind(_build.library("fused_tail"))(
        _ptr(x3), int(x3.dtype == torch.bfloat16), *map(_ptr, weights),
        _ptr(cls), _ptr(prob), B, g.x3_extent, g.up_crop, g.b4_extent,
        g.head_crop, s, p.n_classes, _build.stream_handle(x3))
    _build.check(err, "fused_tail")
    launches += 1
    return cls, prob
