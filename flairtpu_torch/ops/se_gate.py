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

In training (``ops/bn_train.py:SEGateSite``) the gate's gradient is
:func:`se_backward`: the squeeze with a second operand, the gradient g of
the excite's output, summed against the SiLU value over each map
(``flairtpu/models/efficientnet.py:193-199``'s VJP), on the squeeze's plan
and with its ordered combine.

MobileOne's squeeze-excite (``flairtpu/models/mobileone.py:60-74,
110-112``) takes two more kernels of the same source: :func:`se_squeeze_sum`,
the float32 mean of the block's float32 branch sum (no BatchNorm, no
activation), on the squeeze's plan and ordered combine, and
:func:`se_excite_relu`, ``relu(v * gate)`` into the compute dtype and, where
the next block adds it as its skip, float32. The gate between them is
:func:`gate_from` with a ReLU between the two small convs. The sum squeeze
adds every value on its own, so its mean is a fixed function of its plan:
:func:`se_squeeze_sum_plain` given that plan adds in the same order and has
its bits (without one, ``torch.mean``'s order); the ReLU excite keeps the
plain version's bits.

``se_squeeze``, ``se_excite`` and ``se_backward`` run the plain PyTorch
version for a CPU tensor and launch the kernel for a bfloat16 CUDA tensor;
they have no fallback. The squeeze's sigmoid runs on the special-function units, so its
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
BACKWARD_ARGTYPES = [ctypes.c_void_p] + SQUEEZE_ARGTYPES
OCCUPANCY_ARGTYPES = [ctypes.POINTER(ctypes.c_int)]
SUM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
EXCITE_RELU_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_void_p]

# kernel launches on CUDA tensors since the last reset (the CPU path does not count)
squeeze_launches = 0
excite_launches = 0
backward_launches = 0
squeeze_sum_launches = 0
excite_relu_launches = 0

THREADS = 256        # csrc/se_gate.cu kThreads
MAX_GROUP_TILE = 256  # csrc/se_gate.cu kMaxGroupTile
MIN_PIXELS = 4        # pixels a thread sums at the least, where the map allows
BUSY = 0.9            # the share of a block's threads a tile keeps busy, where it can
# csrc/se_gate.cu's squeeze instances (SqueezeMode, in order), the sum
# squeeze's float32 pixels in flight (kSumUnroll) and the ReLU excite's
# output bits (ExciteOutputs)
SQUEEZE_MODES = ("silu", "grad", "sum")
SUM_UNROLL = 2
EXCITE_OUTPUTS = {"bf16": 1, "f32": 2}


def silu_bn(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """float32 ``silu(y * scale + shift)`` over (B, C, H, W), as the excite
    computes it: ``v * sigmoid(v)``, each step rounded on its own."""
    v = y.float() * scale[:, None, None] + shift[:, None, None]
    return v * torch.sigmoid(v)


def se_squeeze_plain(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(B, C) float32 mean over the map of :func:`silu_bn`."""
    return silu_bn(y, scale, shift).mean(dim=(2, 3))


def se_backward_plain(g: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor) -> torch.Tensor:
    """The gate's (B, C) float32 gradient: the sum over the map of g (the
    excite output's gradient, y's dtype) times :func:`silu_bn`."""
    return (g.float() * silu_bn(y, scale, shift)).sum(dim=(2, 3))


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


_CO_RESIDENT: dict[tuple, int] = {}
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def co_resident(device: torch.device, kernel: str = "se_squeeze") -> int:
    """The blocks of ``kernel`` (the squeeze, or ``se_backward``) that
    ``device`` holds at once: its SMs times the occupancy the CUDA runtime
    reports for the built kernel (queried once a device)."""
    key = (device.index, kernel)
    n = _CO_RESIDENT.get(key)
    if n is None:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _build.entry("se_gate", OCCUPANCY_ARGTYPES, f"{kernel}_occupancy")(
                ctypes.byref(per_sm))
        _build.check(err, f"{kernel} occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        n = _CO_RESIDENT[key] = sms * max(1, per_sm.value)
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


def se_backward(g: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor) -> torch.Tensor:
    """As :func:`se_backward_plain`; g like y, channels_last. CPU tensors:
    the plain version. bfloat16 CUDA tensors: the kernel, or an error."""
    global backward_launches
    _check(y, scale, shift, "se_backward")
    if (g.device != y.device or g.dtype != y.dtype or g.shape != y.shape
            or not g.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"se_backward: g must be a channels_last {y.dtype} tensor of shape "
                         f"{tuple(y.shape)} on {y.device}")
    if y.device.type == "cpu":
        return se_backward_plain(g, y, scale, shift)
    _check_kernel(y, "se_backward")
    if g.data_ptr() % 16:
        raise ValueError("se_backward: g must be 16-byte aligned")
    B, C, H, W = y.shape
    plan = squeeze_plan(B, H * W, C, co_resident(y.device, "se_backward"))
    stream = _build.stream_handle(y)
    partial = torch.empty(plan.partials, dtype=torch.float32, device=y.device)
    tickets = _tickets(y.device, stream, B * plan.tiles)
    dgate = torch.empty((B, C), dtype=torch.float32, device=y.device)
    err = _build.entry("se_gate", BACKWARD_ARGTYPES, "se_backward")(
        g.data_ptr(), y.data_ptr(), scale.data_ptr(), shift.data_ptr(), partial.data_ptr(),
        tickets.data_ptr(), dgate.data_ptr(), B, H * W, C, plan.group_tile, plan.blocks, stream)
    _build.check(err, "se_backward")
    backward_launches += 1
    return dgate


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


def _segments(batch: int, hw: int, plan: SqueezePlan) -> list[tuple[int, int, int]]:
    """The (column, first pixel, end pixel) runs of the squeeze's blocks, in
    block order: block i takes units [U i / G, U (i + 1) / G) of the batch
    x tiles x HW units laid end to end (csrc/se_gate.cu)."""
    units = batch * plan.tiles * hw
    runs = []
    for i in range(plan.blocks):
        u, u1 = units * i // plan.blocks, units * (i + 1) // plan.blocks
        while u < u1:
            col = u // hw
            end = min(u1, (col + 1) * hw)
            runs.append((col, u - col * hw, end - col * hw))
            u = end
    return runs


def se_squeeze_sum_plain(v: torch.Tensor, plan: SqueezePlan | None = None) -> torch.Tensor:
    """(B, C) float32 mean over the map of the float32 ``v`` (B, C, H, W).
    Without ``plan``: ``v.mean((2, 3))``. With the kernel's plan, in the
    kernel's order, so with its bits: in each block's run of a column, the
    thread of row r (of 256 / group_tile rows) adds pixels start + r, start
    + r + rows, ... to 0 one at a time; the rows are added to 0 in order;
    the column's runs in block order; the sum divided by HW."""
    if plan is None:
        return v.float().mean(dim=(2, 3))
    B, C, H, W = v.shape
    hw, width = H * W, plan.group_tile * 8
    rows = THREADS // plan.group_tile
    n = B * plan.tiles * hw
    cols = v.permute(0, 2, 3, 1).reshape(B, hw, plan.tiles, width).transpose(1, 2)
    flat = torch.cat([cols.reshape(n, width), cols.new_zeros((1, width))])  # row n: a 0 term
    runs = torch.tensor(_segments(B, hw, plan), dtype=torch.long, device=v.device)
    col, start, end = (runs[:, i, None, None] for i in range(3))
    steps = int(-(-(runs[:, 2] - runs[:, 1]).max().item() // rows))
    p = start + torch.arange(rows, device=v.device)[:, None] \
        + rows * torch.arange(steps, device=v.device)
    at = torch.where(p < end, col * hw + p, n)  # (runs, rows, steps)
    acc = v.new_zeros((len(runs), rows, width), dtype=torch.float32)
    for k in range(steps):  # a thread's pixels, one at a time
        acc = acc + flat[at[:, :, k]]
    total = acc.new_zeros((len(runs), width))
    for r in range(rows):  # the block's rows, in order
        total = total + acc[:, r]
    total = torch.cat([total, total.new_zeros((1, width))])
    # each column's runs in block order (the runs are listed so)
    order = [[] for _ in range(B * plan.tiles)]
    for j, c in enumerate(runs[:, 0].tolist()):
        order[c].append(j)
    depth = max(map(len, order))
    pick = torch.tensor([o + [len(runs)] * (depth - len(o)) for o in order], device=v.device)
    mean = total.new_zeros((B * plan.tiles, width))
    for m in range(depth):
        mean = mean + total[pick[:, m]]
    # a tensor divisor: PyTorch divides a CUDA tensor by a Python scalar as
    # a multiply by its reciprocal, the kernel by a rounded division
    return (mean / torch.full_like(mean, float(hw))).reshape(B, C)


def _check_sum_map(v: torch.Tensor, what: str) -> None:
    if v.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: unsupported device {v.device}")
    if (v.dim() != 4 or v.dtype != torch.float32
            or not v.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"{what}: v must be a float32 channels_last (B, C, H, W) tensor, "
                         f"got {v.dtype} {tuple(v.shape)}")
    if v.device.type == "cuda" and (v.shape[1] % 8 or v.data_ptr() % 16):
        raise ValueError(f"{what}: the kernel takes C a multiple of 8 and a 16-byte aligned "
                         f"map (C = {v.shape[1]})")


def sum_plan(v: torch.Tensor) -> SqueezePlan:
    """The sum squeeze's plan for ``v`` on its card."""
    B, C, H, W = v.shape
    return squeeze_plan(B, H * W, C, co_resident(v.device, "se_squeeze_sum"))


def se_squeeze_sum(v: torch.Tensor) -> torch.Tensor:
    """As :func:`se_squeeze_sum_plain` (with the kernel's plan on the card).
    CPU tensors: the plain version. float32 CUDA tensors: the kernel, or an
    error."""
    global squeeze_sum_launches
    _check_sum_map(v, "se_squeeze_sum")
    if v.device.type == "cpu":
        return se_squeeze_sum_plain(v)
    B, C, H, W = v.shape
    plan = sum_plan(v)
    stream = _build.stream_handle(v)
    partial = torch.empty(plan.partials, dtype=torch.float32, device=v.device)
    tickets = _tickets(v.device, stream, B * plan.tiles)
    mean = torch.empty((B, C), dtype=torch.float32, device=v.device)
    err = _build.entry("se_gate", SUM_ARGTYPES, "se_squeeze_sum")(
        v.data_ptr(), partial.data_ptr(), tickets.data_ptr(), mean.data_ptr(), B, H * W, C,
        plan.group_tile, plan.blocks, stream)
    _build.check(err, "se_squeeze_sum")
    squeeze_sum_launches += 1
    return mean


def se_excite_relu_plain(v: torch.Tensor, gate: torch.Tensor, dtype: torch.dtype,
                         keep_f32: bool = False):
    """``torch.relu(v * gate)`` in float32 on the float32 ``v`` (B, C, H, W)
    and the (B, C) float32 gate: (out in ``dtype``, the float32 value if
    ``keep_f32``)."""
    out = torch.relu(v * gate[:, :, None, None])
    return out.to(dtype), (out if keep_f32 else None)


def se_excite_relu(v: torch.Tensor, gate: torch.Tensor, dtype: torch.dtype,
                   keep_f32: bool = False):
    """As :func:`se_excite_relu_plain`. CPU tensors: the plain version.
    float32 CUDA maps into bfloat16: the kernel, or an error."""
    global excite_relu_launches
    _check_sum_map(v, "se_excite_relu")
    B, C = v.shape[:2]
    if (gate.device != v.device or gate.dtype != torch.float32 or gate.shape != (B, C)
            or not gate.is_contiguous()):
        raise ValueError(f"se_excite_relu: gate must be a contiguous ({B}, {C}) float32 tensor "
                         f"on {v.device}")
    if v.device.type == "cpu":
        return se_excite_relu_plain(v, gate, dtype, keep_f32)
    if dtype != torch.bfloat16:
        raise TypeError(f"se_excite_relu: out dtype {dtype} (the kernel writes bfloat16)")
    out = torch.empty_like(v, dtype=dtype)
    out32 = torch.empty_like(v) if keep_f32 else None
    outputs = EXCITE_OUTPUTS["bf16"] | (EXCITE_OUTPUTS["f32"] if keep_f32 else 0)
    err = _build.entry("se_gate", EXCITE_RELU_ARGTYPES, "se_excite_relu")(
        v.data_ptr(), gate.data_ptr(), out.data_ptr(), None if out32 is None else out32.data_ptr(),
        B, v.shape[2] * v.shape[3], C, outputs, _build.stream_handle(v))
    _build.check(err, "se_excite_relu")
    excite_relu_launches += 1
    return out, out32


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The biased 1x1 conv of weight ``w`` (O, I, 1, 1) and bias ``b`` on
    (B, C) ``x``, in x's dtype."""
    w = (w if w.dtype == x.dtype else w.to(x.dtype)).reshape(w.shape[0], w.shape[1])
    return F.linear(x, w, b if b.dtype == x.dtype else b.to(x.dtype))


def gate_from(mean: torch.Tensor, w_r: torch.Tensor, b_r: torch.Tensor, w_e: torch.Tensor,
              b_e: torch.Tensor, dtype: torch.dtype, act: str = "silu") -> torch.Tensor:
    """The (B, C) float32 gate from the squeeze's mean: the reduce conv
    (``w_r``, ``b_r``), the activation ``act`` (EfficientNet's "silu",
    ``flairtpu/models/efficientnet.py:194-199``, or MobileOne's "relu",
    ``flairtpu/models/mobileone.py:68-74``) and the expand conv (``w_e``,
    ``b_e``) in ``dtype``, then the sigmoid in float32."""
    if act not in ("silu", "relu"):
        raise ValueError(f"gate_from: act is 'silu' or 'relu', got {act!r}")
    g = _linear(mean.to(dtype), w_r, b_r)
    g = _linear(g * torch.sigmoid(g) if act == "silu" else torch.relu(g), w_e, b_e)
    return torch.sigmoid(g.float()).contiguous()


def se_gate_vector(mean: torch.Tensor, reduce: nn.Conv2d, expand: nn.Conv2d,
                   dtype: torch.dtype, act: str = "silu") -> torch.Tensor:
    """:func:`gate_from` with the modules ``reduce`` and ``expand``."""
    return gate_from(mean, reduce.weight, reduce.bias, expand.weight, expand.bias, dtype, act)


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
