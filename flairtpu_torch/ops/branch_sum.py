"""MobileOne's branch sum (``csrc/branch_sum.cu``): the inference BatchNorms
of a block's conv branches and of its skip, summed in ``flairtpu``'s order,
then the ReLU, or at a squeeze-excite block the float32 sum alone.
Counterpart of ``flairtpu/models/mobileone.py:97-112``, which XLA fused on
the TPU.

A block's terms, in the order ``flairtpu`` adds them to its 0.0: the k x k
branches ``rbr_conv.0..n-1``, the 1x1 scale branch ``rbr_scale`` (where the
kernel is larger than 1), both conv outputs in the compute dtype, then the
skip ``rbr_skip``, a bare BatchNorm of the block's float32 input (where the
block has one). Each BatchNorm is an inference (scale, shift), stacked a
row a term in ``scale`` and ``shift`` (terms, C). Three modes (``out``):
``"relu"`` (the ReLU, out in the compute dtype), ``"relu_f32"`` (and its
float32 value, which the next block's skip reads) and ``"sum"`` (the
float32 sum alone, no activation: a squeeze-excite block's, which
``ops/se_gate.py``'s MobileOne squeeze and excite take).

:func:`block_epilogue` runs a whole block after its convs through the
kernels (the sum, and at a squeeze-excite block the squeeze, the gate's two
small convs with a ReLU between them and the excite), and
:func:`block_epilogue_plain` through the plain versions.

``branch_sum`` runs the plain PyTorch version for CPU tensors and launches
the kernel for bfloat16 CUDA tensors; it has no fallback. Every multiply
and add is rounded on its own in both, so the kernel has the plain
version's bits.
"""

from __future__ import annotations

import ctypes

import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops import se_gate as sg

ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

MAX_BRANCHES = 5  # csrc/branch_sum.cu kMaxBranches: 4 k x k branches (s0) and the scale
# csrc/branch_sum.cu's activation codes (conv_epilogue.cu's for none and ReLU)
ACT_CODES = {None: 0, "relu": 1}
# csrc/branch_sum.cu's output bits
OUT_BF16, OUT_F32 = 1, 2
# a mode: (activation, outputs)
MODES = {"relu": ("relu", OUT_BF16), "relu_f32": ("relu", OUT_BF16 | OUT_F32),
         "sum": (None, OUT_F32)}

# kernel launches on CUDA tensors since the last reset (the CPU path does not count)
launches = 0


def branch_sum_plain(ys, scale: torch.Tensor, shift: torch.Tensor,
                     skip: torch.Tensor | None = None, out: str = "relu"):
    """``ys``: the branches' conv outputs (B, C, H, W) in the compute dtype,
    the scale branch last; ``skip``: the block's float32 input or None;
    ``scale``, ``shift``: (terms, C) float32. Returns (out in ys' dtype or
    None, the float32 value or None) as :data:`MODES` says: ``0.0 + (y_0 *
    s_0 + t_0) + ... [+ (skip * s_n + t_n)]`` in float32, each step rounded
    on its own, then ``torch.relu`` where the mode has it."""
    act, outputs = _mode(out)
    v = 0.0 + _term(ys[0], scale[0], shift[0])
    for j, y in enumerate(ys[1:], start=1):
        v = v + _term(y, scale[j], shift[j])
    if skip is not None:
        v = v + _term(skip, scale[len(ys)], shift[len(ys)])
    if act == "relu":
        v = torch.relu(v)
    return (v.to(ys[0].dtype) if outputs & OUT_BF16 else None,
            v if outputs & OUT_F32 else None)


def _term(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return y.float() * s[:, None, None] + t[:, None, None]


def _mode(out: str) -> tuple:
    try:
        return MODES[out]
    except KeyError:
        raise ValueError(f"branch_sum: out is one of {', '.join(MODES)}, got {out!r}") from None


def _check(ys, scale, shift, skip, out: str) -> None:
    if not 1 <= len(ys) <= MAX_BRANCHES:
        raise ValueError(f"branch_sum: 1 to {MAX_BRANCHES} branches, got {len(ys)}")
    y0 = ys[0]
    if y0.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"branch_sum: unsupported device {y0.device}")
    if y0.dim() != 4 or not y0.dtype.is_floating_point:
        raise ValueError(f"branch_sum: a branch must be a floating (B, C, H, W) tensor, got "
                         f"{y0.dtype} {tuple(y0.shape)}")
    for y in ys:
        if (y.device != y0.device or y.dtype != y0.dtype or y.shape != y0.shape
                or not y.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(f"branch_sum: every branch a channels_last {y0.dtype} tensor of "
                             f"shape {tuple(y0.shape)} on {y0.device}")
    if skip is not None and (skip.device != y0.device or skip.dtype != torch.float32
                             or skip.shape != y0.shape
                             or not skip.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"branch_sum: the skip must be a channels_last float32 tensor of shape "
                         f"{tuple(y0.shape)} on {y0.device}")
    terms = (len(ys) + (skip is not None), y0.shape[1])
    for v, name in ((scale, "scale"), (shift, "shift")):
        if (v.device != y0.device or v.dtype != torch.float32 or tuple(v.shape) != terms
                or not v.is_contiguous()):
            raise ValueError(f"branch_sum: {name} must be a contiguous {terms} float32 tensor "
                             f"on {y0.device}")
    _mode(out)


def branch_sum(ys, scale: torch.Tensor, shift: torch.Tensor, skip: torch.Tensor | None = None,
               out: str = "relu"):
    """As :func:`branch_sum_plain`; every map channels_last on one device.
    CPU tensors: the plain version. bfloat16 CUDA tensors: the kernel, or
    an error."""
    global launches
    ys = list(ys)
    _check(ys, scale, shift, skip, out)
    if ys[0].device.type == "cpu":
        return branch_sum_plain(ys, scale, shift, skip, out)
    if ys[0].dtype != torch.bfloat16:
        raise TypeError(f"branch_sum: branch dtype {ys[0].dtype} (the kernel takes bfloat16)")
    act, outputs = MODES[out]
    y0 = ys[0]
    o = torch.empty_like(y0) if outputs & OUT_BF16 else None
    o32 = torch.empty_like(y0, dtype=torch.float32) if outputs & OUT_F32 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    C = y0.shape[1]
    err = _build.entry("branch_sum", ARGTYPES)(
        *(ptr(ys[j]) if j < len(ys) else None for j in range(MAX_BRANCHES)), len(ys), ptr(skip),
        scale.data_ptr(), shift.data_ptr(), ptr(o), ptr(o32), y0.numel() // C, C,
        ACT_CODES[act], _build.stream_handle(y0))
    _build.check(err, "branch_sum")
    launches += 1
    return o, o32


def block_epilogue(ys, scale: torch.Tensor, shift: torch.Tensor, skip=None, se=None,
                   keep_f32: bool = False, plain: bool = False):
    """A MobileOne block after its convs (``flairtpu/models/mobileone.py:
    97-112``): the branch sum with the ReLU; at a squeeze-excite block
    (``se`` = (reduce, expand), the gate's biased 1x1 convs) the float32
    sum, its float32 mean (the squeeze), the gate (``ops/se_gate.py:
    gate_from`` with a ReLU) and ``relu(v * gate)`` (the excite). Returns
    (out in ys' dtype, its float32 value if ``keep_f32``). ``plain``: every
    step through its plain version, the squeeze's on the card in the
    kernel's order (its plan), so that the block has the kernels' bits."""
    if se is None:
        f = branch_sum_plain if plain else branch_sum
        return f(ys, scale, shift, skip, "relu_f32" if keep_f32 else "relu")
    v = (branch_sum_plain if plain else branch_sum)(ys, scale, shift, skip, "sum")[1]
    if plain:
        mean = sg.se_squeeze_sum_plain(v, sg.sum_plan(v) if v.is_cuda else None)
    else:
        mean = sg.se_squeeze_sum(v)
    gate = sg.se_gate_vector(mean, *se, ys[0].dtype, act="relu")
    excite = sg.se_excite_relu_plain if plain else sg.se_excite_relu
    return excite(v, gate, ys[0].dtype, keep_f32)


def block_epilogue_plain(ys, scale, shift, skip=None, se=None, keep_f32: bool = False):
    """:func:`block_epilogue` through the plain versions."""
    return block_epilogue(ys, scale, shift, skip, se, keep_f32, plain=True)
