"""Squeeze-excite at an EfficientNet block's depthwise site
(``csrc/se_gate.cu``): the depthwise conv's BatchNorm and SiLU, the float32
mean over the map (the squeeze), the gate's two small biased 1x1 convs and
its sigmoid, and the gate's multiply on the float32 SiLU value, cast to the
compute dtype for the project conv (the excite). Counterpart of
``flairtpu/models/efficientnet.py:191-201``, which XLA fused on the TPU.

The squeeze and the excite are kernels; between them the two convs on the
(B, C) mean run as ``F.linear`` in the compute dtype (the mean cast to it,
SiLU in it), and the sigmoid in float32, as ``flairtpu`` computes them
outside any fusion of the map. Neither kernel writes the float32 SiLU map:
the excite recomputes it from the bf16 depthwise output.

``se_squeeze`` and ``se_excite`` run the plain PyTorch version for a CPU
tensor and launch the kernel for a bfloat16 CUDA tensor; they have no
fallback. The squeeze's sigmoid runs on the special-function units, so its
mean is within a few float32 ulps of the plain version's terms, not bit for
bit; the excite keeps the plain version's bits. The squeeze's grid is the
card's co-resident blocks (:func:`squeeze_plan`), and its ticket counters
are kept a (device, stream), zero between launches, so a call is one
launch. :func:`squeeze_excite` runs the whole site through them,
:func:`squeeze_excite_plain` through the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from flairtpu_torch.ops import _build

SQUEEZE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
EXCITE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
OCCUPANCY_ARGTYPES = [ctypes.POINTER(ctypes.c_int)]

# kernel launches on CUDA tensors since the last reset (the CPU path does not count)
squeeze_launches = 0
excite_launches = 0

THREADS = 256        # csrc/se_gate.cu kThreads
MAX_GROUP_TILE = 256  # csrc/se_gate.cu kMaxGroupTile
MIN_PIXELS = 4        # pixels a thread sums at the least, where the map allows
BUSY = 0.9            # the share of a block's threads a tile keeps busy, where it can


def silu_bn(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """float32 ``silu(y * scale + shift)`` over (B, C, H, W), as the excite
    computes it: ``v * sigmoid(v)``, each step rounded on its own."""
    v = y.float() * scale[:, None, None] + shift[:, None, None]
    return v * torch.sigmoid(v)


def se_squeeze_plain(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(B, C) float32 mean over the map of :func:`silu_bn`."""
    return silu_bn(y, scale, shift).mean(dim=(2, 3))


def se_excite_plain(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    gate: torch.Tensor) -> torch.Tensor:
    """:func:`silu_bn` times the (B, C) float32 gate, in y's dtype,
    channels_last."""
    out = (silu_bn(y, scale, shift) * gate[:, :, None, None]).to(y.dtype)
    return out.contiguous(memory_format=torch.channels_last)


class SqueezePlan(NamedTuple):
    group_tile: int  # 8-channel groups of a column
    tiles: int       # columns of a map: C / 8 / group_tile
    blocks: int      # the grid
    partials: int    # float32 scratch: (blocks + batch x tiles - 1) x group_tile x 8


def group_tile(channels: int) -> int:
    """The widest divisor of C / 8 up to MAX_GROUP_TILE groups whose rows
    (THREADS // tile of them) keep ``BUSY`` of a block's threads busy; where
    none does, the one that keeps the most."""
    c8 = channels // 8
    fits = [d for d in range(1, MAX_GROUP_TILE + 1) if c8 % d == 0]

    def busy(d: int) -> float:
        return THREADS // d * d / THREADS

    good = [d for d in fits if busy(d) >= BUSY]
    return max(good) if good else max(fits, key=lambda d: (busy(d), d))


def squeeze_plan(batch: int, hw: int, channels: int, co_resident: int) -> SqueezePlan:
    """The squeeze's grid: one block for each block the card holds at once
    (``co_resident``: its SMs times the kernel's occupancy), fewer where the
    map would give a thread under ``MIN_PIXELS`` pixels, each taking an
    equal share of the batch x tiles x HW units (csrc/se_gate.cu)."""
    gt = group_tile(channels)
    tiles = channels // 8 // gt
    rows = THREADS // gt
    units = batch * tiles * hw
    blocks = max(1, min(co_resident, units // (rows * MIN_PIXELS)))
    return SqueezePlan(gt, tiles, blocks, (blocks + batch * tiles - 1) * gt * 8)


_CO_RESIDENT: dict[int, int] = {}
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def co_resident(device: torch.device) -> int:
    """The squeeze kernel's blocks ``device`` holds at once: its SMs times
    the occupancy the CUDA runtime reports for the built kernel (queried
    once a device)."""
    n = _CO_RESIDENT.get(device.index)
    if n is None:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _build.entry("se_gate", OCCUPANCY_ARGTYPES, "se_squeeze_occupancy")(
                ctypes.byref(per_sm))
        _build.check(err, "se_squeeze occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        n = _CO_RESIDENT[device.index] = sms * max(1, per_sm.value)
    return n


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` of the squeeze's ticket counters for calls on
    ``stream``: zero, and left zero by every launch (a larger set replaces
    a smaller one)."""
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


def _check(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, what: str) -> None:
    if y.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: unsupported device {y.device}")
    if (y.dim() != 4 or not y.dtype.is_floating_point
            or not y.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"{what}: y must be a floating channels_last (B, C, H, W) tensor, "
                         f"got {y.dtype} {tuple(y.shape)}")
    C = y.shape[1]
    for v, name in ((scale, "scale"), (shift, "shift")):
        if (v.device != y.device or v.dtype != torch.float32 or v.shape != (C,)
                or not v.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous ({C},) float32 tensor "
                             f"on {y.device}")


def _check_kernel(y: torch.Tensor, what: str) -> None:
    if y.dtype != torch.bfloat16:
        raise TypeError(f"{what}: y dtype {y.dtype} (the kernel takes bfloat16)")
    if y.shape[1] % 8 or y.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel takes C a multiple of 8 and a 16-byte aligned "
                         f"map (C = {y.shape[1]})")


def se_squeeze(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """As :func:`se_squeeze_plain`. CPU tensors: the plain version.
    bfloat16 CUDA tensors: the kernel, or an error."""
    global squeeze_launches
    _check(y, scale, shift, "se_squeeze")
    if y.device.type == "cpu":
        return se_squeeze_plain(y, scale, shift)
    _check_kernel(y, "se_squeeze")
    B, C, H, W = y.shape
    plan = squeeze_plan(B, H * W, C, co_resident(y.device))
    stream = _build.stream_handle(y)
    partial = torch.empty(plan.partials, dtype=torch.float32, device=y.device)
    tickets = _tickets(y.device, stream, B * plan.tiles)
    mean = torch.empty((B, C), dtype=torch.float32, device=y.device)
    err = _build.entry("se_gate", SQUEEZE_ARGTYPES, "se_squeeze")(
        y.data_ptr(), scale.data_ptr(), shift.data_ptr(), partial.data_ptr(),
        tickets.data_ptr(), mean.data_ptr(), B, H * W, C, plan.group_tile, plan.blocks, stream)
    _build.check(err, "se_squeeze")
    squeeze_launches += 1
    return mean


def se_excite(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
              gate: torch.Tensor) -> torch.Tensor:
    """As :func:`se_excite_plain`. CPU tensors: the plain version. bfloat16
    CUDA tensors: the kernel, or an error."""
    global excite_launches
    _check(y, scale, shift, "se_excite")
    B, C = y.shape[:2]
    if (gate.device != y.device or gate.dtype != torch.float32 or gate.shape != (B, C)
            or not gate.is_contiguous()):
        raise ValueError(f"se_excite: gate must be a contiguous ({B}, {C}) float32 tensor "
                         f"on {y.device}")
    if y.device.type == "cpu":
        return se_excite_plain(y, scale, shift, gate)
    _check_kernel(y, "se_excite")
    out = torch.empty_like(y)
    err = _build.entry("se_gate", EXCITE_ARGTYPES, "se_excite")(
        y.data_ptr(), scale.data_ptr(), shift.data_ptr(), gate.data_ptr(), out.data_ptr(),
        B, y.shape[2] * y.shape[3], C, _build.stream_handle(y))
    _build.check(err, "se_excite")
    excite_launches += 1
    return out


def _linear(x: torch.Tensor, m: nn.Conv2d) -> torch.Tensor:
    """The biased 1x1 conv ``m`` on (B, C) ``x``, in x's dtype."""
    w, b = m.weight, m.bias
    w = (w if w.dtype == x.dtype else w.to(x.dtype)).reshape(w.shape[0], w.shape[1])
    return F.linear(x, w, b if b.dtype == x.dtype else b.to(x.dtype))


def se_gate_vector(mean: torch.Tensor, reduce: nn.Conv2d, expand: nn.Conv2d,
                   dtype: torch.dtype) -> torch.Tensor:
    """The (B, C) float32 gate from the squeeze's mean: ``reduce``, SiLU and
    ``expand`` in ``dtype``, then the sigmoid in float32
    (``flairtpu/models/efficientnet.py:194-199``)."""
    g = _linear(mean.to(dtype), reduce)
    g = _linear(g * torch.sigmoid(g), expand)
    return torch.sigmoid(g.float()).contiguous()


def squeeze_excite(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   reduce: nn.Conv2d, expand: nn.Conv2d) -> torch.Tensor:
    """The whole site on the depthwise output ``y`` (compute dtype,
    channels_last): the project conv's input in y's dtype."""
    gate = se_gate_vector(se_squeeze(y, scale, shift), reduce, expand, y.dtype)
    return se_excite(y, scale, shift, gate)


def squeeze_excite_plain(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                         reduce: nn.Conv2d, expand: nn.Conv2d) -> torch.Tensor:
    """:func:`squeeze_excite` through the plain versions."""
    gate = se_gate_vector(se_squeeze_plain(y, scale, shift), reduce, expand, y.dtype)
    return se_excite_plain(y, scale, shift, gate)
