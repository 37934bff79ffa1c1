"""int8 convolution with its dequantize epilogue (``csrc/int8_conv.cu``,
hand-written implicit GEMM on the mma.sync s8 tensor cores).

Replaces the XLA int8 convolution of ``flairtpu/models/quantize.py:218-230``
(``_quant_conv``), with the element-wise ops of the walk that XLA fused into
it on the TPU: int8 NHWC activations x int8 weights -> int32, then per
output element

    v = fma(float(acc), deq[co], b[co])   as XLA contracts y * deq + b
    v = v + residual                        (optional, float32)
    v = max(v, 0)                           (optional)

written as float32 only where a later op reads float32 (``keep_f32``: the
next block's identity, a feature, a pool or a float site), and as the next
int8 site's input, ``clip(round(v * float32(1 / sx)), -127, 127)``, where
that site follows (``out_sx``), so that only int8 crosses device memory
between int8 sites.

The plain version convolves float64 copies of the int8 operands (float64
holds every sum exactly; float32 does not, since K * 127^2 exceeds 2^24)
and rounds the multiply-add once, as the FMA does (:func:`fma_f32`).
``int8_conv`` runs it for a CPU tensor and launches the kernel for a CUDA
tensor; it has no fallback.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from flairtpu_torch.ops import _build
from flairtpu_torch.ops.quantize_act import inverse_scale, padded_channels, quantize_values

ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_int] * 14
            + [ctypes.c_void_p])
K_CHUNK = 32  # bytes of K per mma.sync step: the packed rows' multiple

# kernel launches on CUDA tensors since the last reset (the CPU path does not count)
launches = 0


@dataclass
class Int8ConvParams:
    """One int8 site: weights (Co, Ci, kh, kw) int8 and their per-channel
    dequantize factor ``deq`` = sw * sx and bias ``b`` (float32), with the
    input's scale ``sx`` (a float32 value). ``packed`` is the kernel's
    (Co, Kp) copy: row co holds tap-major, channel-minor weights over
    :func:`padded_channels` channels, zero past Ci and past K."""

    wq: torch.Tensor
    sx: float
    deq: torch.Tensor
    b: torch.Tensor
    packed: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        co, ci, kh, kw = self.wq.shape
        cp = padded_channels(ci)
        k = kh * kw * cp
        w = self.wq.new_zeros((co, kh, kw, cp))
        w[..., :ci] = self.wq.permute(0, 2, 3, 1)
        self.packed = self.wq.new_zeros((co, -(-k // K_CHUNK) * K_CHUNK))
        self.packed[:, :k] = w.reshape(co, k)

    @property
    def in_channels(self) -> int:
        """Channels of the int8 input the site takes (Ci padded to 8)."""
        return padded_channels(self.wq.shape[1])


def fma_f32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 x * y + z rounded once (an FMA), for float32 tensors that
    broadcast. The product is exact in float64 and the sum is rounded to
    float64 first; where that lands on a float32 rounding midpoint, the
    sum's own rounding error (TwoSum) decides the side, so the result is
    the FMA's in every case."""
    p = x.double() * y.double()
    zd = z.double().expand_as(p)
    s = p + zd
    bb = s - p
    err = (p - (s - bb)) + (zd - bb)
    mid = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    s = torch.where(mid & (err != 0), torch.nextafter(s, s + err), s)
    return s.float()


def _out_hw(size: int, k: int, stride: int, padding: int, dilation: int) -> int:
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def int8_conv_acc_plain(x: torch.Tensor, p: Int8ConvParams, stride: int, padding: int,
                        dilation: int = 1) -> torch.Tensor:
    """The int32 sums: x (B, Cp, H, W) int8 -> (B, Co, Ho, Wo) int32."""
    w = p.wq.double()
    if x.shape[1] != w.shape[1]:  # channels padded to 8: their weights are 0
        w = F.pad(w, (0, 0, 0, 0, 0, x.shape[1] - w.shape[1]))
    acc = F.conv2d(x.double(), w, None, stride, padding, dilation)
    return acc.to(torch.int32).contiguous(memory_format=torch.channels_last)


def int8_conv_plain(x: torch.Tensor, p: Int8ConvParams, stride: int, padding: int,
                    dilation: int = 1, residual: torch.Tensor | None = None, relu: bool = True,
                    keep_f32: bool = True, out_sx: float | None = None):
    """x (B, Cp, H, W) int8 -> (float32 (B, Co, Ho, Wo) or None, int8 of
    ``out_sx`` or None), both channels_last."""
    acc = int8_conv_acc_plain(x, p, stride, padding, dilation)
    v = fma_f32(acc.float(), p.deq[:, None, None], p.b[:, None, None])
    if residual is not None:
        v = v + residual
    if relu:
        v = torch.relu(v)
    v = v.contiguous(memory_format=torch.channels_last)
    q = None
    if out_sx is not None:
        q = quantize_values(v, out_sx).contiguous(memory_format=torch.channels_last)
    return (v if keep_f32 else None), q


def _check(x: torch.Tensor, p: Int8ConvParams, residual, out_shape: tuple,
           keep_f32: bool, out_sx) -> None:
    if x.dtype != torch.int8 or x.dim() != 4 or x.shape[1] != p.in_channels:
        raise ValueError(f"int8_conv: x must be a (B, {p.in_channels}, H, W) int8 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("int8_conv: x must be channels_last")
    if p.wq.shape[0] % 8:
        raise ValueError(f"int8_conv: {p.wq.shape[0]} output channels (a multiple of 8)")
    for name, t in (("weights", p.packed), ("deq", p.deq), ("b", p.b)):
        if t.device != x.device:
            raise ValueError(f"int8_conv: {name} must be on {x.device}")
    if residual is not None and (
            residual.dtype != torch.float32 or tuple(residual.shape) != out_shape
            or residual.device != x.device
            or not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"int8_conv: residual must be a channels_last float32 tensor of "
                         f"shape {out_shape} on {x.device}")
    if not keep_f32 and out_sx is None:
        raise ValueError("int8_conv: no output asked for (keep_f32 or out_sx)")


def int8_conv(x: torch.Tensor, p: Int8ConvParams, stride: int, padding: int,
              dilation: int = 1, residual: torch.Tensor | None = None, relu: bool = True,
              keep_f32: bool = True, out_sx: float | None = None):
    """As :func:`int8_conv_plain`. CPU tensors: the plain version. CUDA
    tensors: the kernel, or an error."""
    global launches
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"int8_conv: unsupported device {x.device}")
    B, _, H, W = x.shape
    co, _, kh, kw = p.wq.shape
    ho, wo = (_out_hw(H, kh, stride, padding, dilation), _out_hw(W, kw, stride, padding,
                                                                 dilation))
    _check(x, p, residual, (B, co, ho, wo), keep_f32, out_sx)
    if x.device.type == "cpu":
        return int8_conv_plain(x, p, stride, padding, dilation, residual, relu, keep_f32,
                               out_sx)
    out32 = outq = None
    if keep_f32:
        out32 = torch.empty((B, co, ho, wo), dtype=torch.float32, device=x.device,
                            memory_format=torch.channels_last)
    if out_sx is not None:
        outq = torch.empty((B, co, ho, wo), dtype=torch.int8, device=x.device,
                           memory_format=torch.channels_last)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.entry("int8_conv", ARGTYPES)(
        ptr(x), ptr(p.packed), ptr(p.deq), ptr(p.b), ptr(residual), ptr(out32), ptr(outq),
        inverse_scale(out_sx) if out_sx is not None else 0.0, B, H, W, p.in_channels, ho, wo,
        co, kh, kw, stride, padding, dilation, p.packed.shape[1], int(relu),
        _build.stream_handle(x))
    _build.check(err, "int8_conv")
    launches += 1
    return out32, outq
