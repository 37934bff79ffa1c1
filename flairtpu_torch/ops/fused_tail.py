"""Fused decoder tail: the last U-Net decoder block (MAnet's and UNet++'s
last block too), the segmentation head,
the softmax max/argmax epilogue and the exact-clipping plane writes in one
CUDA kernel (``csrc/fused_tail.cu``, tensor cores).

Port of the Pallas kernel ``benchmarks/pallas_fused_tail.py:make_kernel``,
generalized to any tile size, margin and class count (K <= 32), with the
last block's BatchNorm applied as a per-channel (scale, shift) epilogue. It
replaces, on the zone main path, the stretch ``flairtpu`` runs as XLA:
``models/unet.py:145-154`` (block 4), ``models/factory.py:270-274`` (head and
crop), ``zone/device_engine.py:143-146`` (epilogue) and
``zone/device_engine.py:148-156`` (plane writes).

Three epilogues, one kernel each (a template parameter of the source):

- :func:`fused_tail` (argmax): the class and probability into (B, s, s)
  tiles or, given ``planes`` and ``windows``, straight into the zone's two
  uint8 planes: tile b's interior pixel (r, c) lands at plane pixel
  (R0 + r, C0 + c) when it lies in the tile's owned window [rlo, rhi) x
  [clo, chi) (``windows[b] = (R0, C0, rlo, rhi, clo, chi)``);
- :func:`fused_tail_probs` (``output_type: class_prob``,
  ``flairtpu/zone/device_engine.py:176-185``): round(255 * softmax) of every
  class, through the same windows into one (H, W, K) uint8 plane;
- :func:`fused_tail_logits` (the average and max stitches,
  ``device_engine.py:206, 519``): the float32 logits (B, s, s, K), K
  innermost as ``flairtpu``'s; at margin 0 (``tail_geometry(S, 0)``) the
  whole tile.

Each wrapper runs the plain PyTorch version for a CPU tensor and launches
the kernel for a bfloat16 CUDA tensor; it has no fallback, and counts its
own launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import ClassVar
from functools import lru_cache

import torch
import torch.nn.functional as F

from flairtpu_torch.models.resnet import bn_scale_shift
from flairtpu_torch.models.unet import plan_inner_crops, upsample2x_nearest
from flairtpu_torch.ops import _build
from flairtpu_torch.ops.fused import prob_to_u8, softmax, softmax_argmax, write_windows

C3, C4 = 32, 16  # channels into and of the last decoder block (every resnet unet)
MAX_CLASSES = 32
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
ARGMAX, PROBS, LOGITS = 0, 1, 2  # the kernel's modes
# packed weight row lengths (bf16): depth 9 x C_in, tap-major and channel-minor,
# plus 8 zeros so that rows step an odd number of 16-byte shared-memory units
ROW1, ROW2 = 9 * C3 + 8, 9 * C4 + 8

# kernel launches on CUDA tensors since the last reset, one count per
# wrapper (the CPU path does not count)
launches = 0  # fused_tail (argmax)
probs_launches = 0  # fused_tail_probs
logits_launches = 0  # fused_tail_logits


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
    values already rounded to the compute dtype. ``packed`` (bf16, see
    :func:`pack_conv`) and ``epi`` (float32 scale1, shift1, scale2, shift2,
    then the bias zero-padded to the padded class count) are the kernel's
    copies, made once."""

    w1: torch.Tensor
    scale1: torch.Tensor
    shift1: torch.Tensor
    w2: torch.Tensor
    scale2: torch.Tensor
    shift2: torch.Tensor
    wh: torch.Tensor
    bias: torch.Tensor
    packed: torch.Tensor = field(init=False, repr=False)
    epi: torch.Tensor = field(init=False, repr=False)
    # the head's stride over the tile: none, the tail runs the last block
    up: ClassVar[int] = 0

    def wrappers(self) -> tuple:
        """(argmax, probs, logits): this kind's kernel wrappers."""
        return fused_tail, fused_tail_probs, fused_tail_logits

    def plain_versions(self) -> tuple:
        """(argmax, probs, logits): the wrappers' plain versions."""
        return fused_tail_plain, fused_tail_probs_plain, fused_tail_logits_plain

    def geometry(self, size: int, margin: int) -> TailGeometry:
        return tail_geometry(size, margin)

    @property
    def device(self) -> torch.device:
        return self.epi.device

    def __post_init__(self):
        kp = padded_classes(self.n_classes)
        with torch.no_grad():
            self.packed = torch.cat([pack_conv(self.w1, C4, ROW1).flatten(),
                                     pack_conv(self.w2, C4, ROW2).flatten(),
                                     pack_conv(self.wh, kp, ROW2).flatten()])
            bias = torch.zeros(kp, dtype=torch.float32, device=self.bias.device)
            bias[:self.n_classes] = self.bias
            self.epi = torch.cat([self.scale1, self.shift1, self.scale2, self.shift2,
                                  bias]).float().contiguous()

    @property
    def n_classes(self) -> int:
        return self.wh.shape[0]


def padded_classes(k: int) -> int:
    """K rounded up to the mma n-tile of 8."""
    return -(-k // 8) * 8


def pack_conv(w: torch.Tensor, rows: int, row: int) -> torch.Tensor:
    """(O, I, 3, 3) -> (rows, row) bfloat16, the GEMM operand the kernel reads:
    row n holds output channel n's weights at depth index tap * I + i, with
    tap = 3 dy + dx; zero past O rows and past 9 I columns."""
    O, I = w.shape[:2]
    out = torch.zeros((rows, row), dtype=torch.bfloat16, device=w.device)
    out[:O, :9 * I] = w.permute(0, 2, 3, 1).reshape(O, 9 * I)
    return out


def tail_params(model, dtype: torch.dtype) -> TailParams:
    """The tail's weights from a FlairSegmentationModel whose decoder ends in
    the U-Net's last block (``decoder.last_block``: the U-Net's, MAnet's
    and UNet++'s): its convs with their BatchNorm as (scale, shift), and the
    head."""
    block, head = model.decoder.last_block, model.segmentation_head[0]

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


def fused_tail_plain(x3: torch.Tensor, p: TailParams, g: TailGeometry,
                     planes: torch.Tensor | None = None, windows: torch.Tensor | None = None):
    """Plain PyTorch tail: x3 -> (class, prob) uint8 (B, s, s), or with
    ``planes`` and ``windows`` the owned windows written into the planes
    (returns the planes)."""
    cls, prob = softmax_argmax(tail_logits_plain(x3, p, g), dim=1)
    cls, prob = cls.to(torch.uint8), prob_to_u8(prob)
    if planes is None:
        return cls, prob
    write_windows([planes[0], planes[1]], [cls, prob], windows)
    return planes


def fused_tail_probs_plain(x3: torch.Tensor, p: TailParams, g: TailGeometry,
                           plane: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch tail: x3 -> round(255 * softmax) (B, s, s, K) uint8, each
    tile's owned window written into ``plane`` (H, W, K); returns the plane."""
    probs = prob_to_u8(softmax(tail_logits_plain(x3, p, g), dim=1)).permute(0, 2, 3, 1)
    write_windows([plane], [probs], windows)
    return plane


def fused_tail_logits_plain(x3: torch.Tensor, p: TailParams, g: TailGeometry,
                            out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch tail: x3 -> float32 logits (B, s, s, K), into ``out``
    when given."""
    logits = tail_logits_plain(x3, p, g).permute(0, 2, 3, 1).contiguous()
    return logits if out is None else out.copy_(logits)


@lru_cache(maxsize=8)
def full_windows(batch: int, s: int, device: torch.device) -> torch.Tensor:
    """Windows that write tile b whole at rows [b s, (b + 1) s) of (B s, s)
    planes: the tile output as planes."""
    w = torch.zeros((batch, 6), dtype=torch.int32)
    w[:, 0] = torch.arange(batch, dtype=torch.int32) * s
    w[:, 3] = w[:, 5] = s
    return w.to(device)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_input(name: str, x3: torch.Tensor, p: TailParams, g: TailGeometry) -> None:
    """Raise unless x3 and p are what the kernel takes on the card."""
    B, C, H, W = x3.shape
    if (C, H, W) != (C3, g.x3_extent, g.x3_extent):
        raise ValueError(f"{name}: x3 shape {tuple(x3.shape)} does not match "
                         f"(B, {C3}, {g.x3_extent}, {g.x3_extent})")
    if x3.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x3 dtype {x3.dtype} (the kernel takes bfloat16)")
    if not x3.is_contiguous(memory_format=torch.channels_last) or x3.data_ptr() % 16:
        raise ValueError(f"{name}: x3 must be channels_last contiguous, 16-byte aligned")
    if not 1 <= p.n_classes <= MAX_CLASSES:
        raise ValueError(f"{name}: {p.n_classes} classes (at most {MAX_CLASSES})")
    if p.packed.device != x3.device or p.epi.device != x3.device:
        raise ValueError(f"{name}: parameters must be on {x3.device}")


def _check_windows(name: str, windows, x3: torch.Tensor) -> None:
    B = x3.shape[0]
    if (windows is None or windows.device != x3.device or windows.dtype != torch.int32
            or tuple(windows.shape) != (B, 6) or not windows.is_contiguous()):
        raise ValueError(f"{name}: windows must be a contiguous ({B}, 6) int32 tensor "
                         f"on {x3.device}")


def _launch(x3: torch.Tensor, p: TailParams, g: TailGeometry, windows: torch.Tensor,
            out0: torch.Tensor, out1: torch.Tensor, pitch: int, mode: int) -> None:
    err = _build.entry("fused_tail", ARGTYPES)(
        _ptr(x3), _ptr(p.packed), _ptr(p.epi), _ptr(windows), _ptr(out0), _ptr(out1),
        pitch, x3.shape[0], g.x3_extent, g.up_crop, g.b4_extent, g.head_crop,
        g.out_extent, p.n_classes, mode, _build.stream_handle(x3))
    _build.check(err, "fused_tail")


def _on_card(name: str, x3: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if x3.device.type == "cpu":
        return False
    if x3.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x3.device}")
    return True


def fused_tail(x3: torch.Tensor, p: TailParams, g: TailGeometry,
               planes: torch.Tensor | None = None, windows: torch.Tensor | None = None):
    """x3 (B, 32, E3, E3), channels_last -> (class, prob) uint8 (B, s, s); or,
    with ``planes`` (2, H, W) uint8 and ``windows`` (B, 6) int32, each tile's
    owned window written into the planes (returns the planes).

    CPU tensor: the plain version. bfloat16 CUDA tensor: the kernel, or an
    error."""
    global launches
    if not _on_card("fused_tail", x3):
        return fused_tail_plain(x3, p, g, planes, windows)
    _check_input("fused_tail", x3, p, g)
    B, s = x3.shape[0], g.out_extent
    tiles = planes is None
    if tiles:
        planes = torch.empty((2, B * s, s), dtype=torch.uint8, device=x3.device)
        windows = full_windows(B, s, x3.device)
    elif (planes.device != x3.device or planes.dtype != torch.uint8 or planes.dim() != 3
          or planes.shape[0] != 2 or not planes.is_contiguous()):
        raise ValueError(f"fused_tail: planes must be a contiguous (2, H, W) uint8 tensor "
                         f"on {x3.device}")
    _check_windows("fused_tail", windows, x3)
    _launch(x3, p, g, windows, planes[0], planes[1], planes.shape[2], ARGMAX)
    launches += 1
    if tiles:
        return planes[0].view(B, s, s), planes[1].view(B, s, s)
    return planes


def fused_tail_probs(x3: torch.Tensor, p: TailParams, g: TailGeometry,
                     plane: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """x3 (B, 32, E3, E3), channels_last -> each tile's owned window of
    round(255 * softmax) written into ``plane`` (H, W, K) uint8 through
    ``windows`` (B, 6) int32; returns the plane.

    CPU tensor: the plain version. bfloat16 CUDA tensor: the kernel, or an
    error."""
    global probs_launches
    if not _on_card("fused_tail_probs", x3):
        return fused_tail_probs_plain(x3, p, g, plane, windows)
    _check_input("fused_tail_probs", x3, p, g)
    if (plane.device != x3.device or plane.dtype != torch.uint8 or plane.dim() != 3
            or plane.shape[2] != p.n_classes or not plane.is_contiguous()):
        raise ValueError(f"fused_tail_probs: plane must be a contiguous (H, W, "
                         f"{p.n_classes}) uint8 tensor on {x3.device}")
    _check_windows("fused_tail_probs", windows, x3)
    _launch(x3, p, g, windows, plane, plane, plane.shape[1], PROBS)
    probs_launches += 1
    return plane


def fused_tail_logits(x3: torch.Tensor, p: TailParams, g: TailGeometry,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """x3 (B, 32, E3, E3), channels_last -> float32 logits (B, s, s, K),
    into ``out`` when given (a buffer kept across batches).

    CPU tensor: the plain version. bfloat16 CUDA tensor: the kernel, or an
    error."""
    global logits_launches
    B, s, k = x3.shape[0], g.out_extent, p.n_classes
    if not _on_card("fused_tail_logits", x3):
        return fused_tail_logits_plain(x3, p, g, out)
    _check_input("fused_tail_logits", x3, p, g)
    if out is None:
        out = torch.empty((B, s, s, k), dtype=torch.float32, device=x3.device)
    elif (out.device != x3.device or out.dtype != torch.float32
          or tuple(out.shape) != (B, s, s, k) or not out.is_contiguous()):
        raise ValueError(f"fused_tail_logits: out must be a contiguous ({B}, {s}, {s}, {k}) "
                         f"float32 tensor on {x3.device}")
    _launch(x3, p, g, full_windows(B, s, x3.device), out, out, s, LOGITS)
    logits_launches += 1
    return out
