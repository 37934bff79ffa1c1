"""Weighted cross-entropy with its gradient and the confusion matrix of the
first-maximum argmax, over per-pixel float32 logits (``csrc/weighted_ce.cu``).

Replaces what XLA fused around ``flairtpu``'s loss:
``flairtpu/train/loop.py:255-269`` (``_loss``: torch's
``CrossEntropyLoss(weight=w)``, a weighted mean of the NLL normalized by
``max(sum of the targets' weights, 1e-8)``, the weight-0 classes' weights
included), its VJP, and the confusion matrix of the train and eval steps
(``loop.py:307-310, 399-400`` with ``flairtpu/ops/confmat.py:19-41``): rows =
target, columns = the first maximum of the logits.

:class:`WeightedCE` is the ``autograd.Function``: its forward is one pass
over the logits that also adds the batch's counts into a K x K int32
confusion matrix on the logits' device (kept there for a whole epoch, so no
step waits on the host); its backward writes ``g * (softmax - onehot) *
w[t] / max(wsum, 1e-8)``. Eval calls :func:`weighted_ce` under no_grad.

Each wrapper runs the plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors; it has no fallback, and counts its launches (one a
call: each entry point is one launch). :func:`launch_plan` sizes a call's
grid (a persistent grid: the card's SMs times the kernel's occupancy, never
more blocks than tiles of TILE pixels) and the forward's scratch: the int32
ticket counter, then a (sum, weight sum) pair a block. The scratch is
cached, one buffer per (device, stream): the kernel leaves the counter at
0 and calls on one stream run in order, so no call needs a memset, and
nothing syncs with the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops.confmat import confusion_matrix

FORWARD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_void_p]
BACKWARD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_void_p]
OCCUPANCY_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
MAX_CLASSES = 32
THREADS = 256
TILE = 256  # pixels a tile, one a thread (csrc/weighted_ce.cu kTile)
STAGES = {"forward": 3, "backward": 3}  # tiles of a block's ring (kForwardStages, ...)
COUNTER_WORDS = 4  # int32s before the forward's partials: the ticket, then padding

# kernel launches on CUDA tensors since the last reset, one count per entry
# point (the CPU path does not count)
launches = 0  # forward
backward_launches = 0


def weighted_ce_plain(logits: torch.Tensor, target: torch.Tensor, weight: torch.Tensor,
                      cm: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """logits (..., K) float32, target (...) int32 in [0, K), weight (K,) ->
    (loss, weight sum), 0-d float32; the argmax's counts added into ``cm``
    (K, K) int32 when given."""
    k = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot_w = torch.nn.functional.one_hot(target.long(), k).float() * weight
    loss_sum = -(logp * onehot_w).sum()
    w_sum = onehot_w.sum()
    if cm is not None:
        cm += confusion_matrix(logits.argmax(dim=-1), target, k, cm.dtype)
    return loss_sum / torch.clamp_min(w_sum, 1e-8), w_sum


def weighted_ce_grad_plain(logits: torch.Tensor, target: torch.Tensor, weight: torch.Tensor,
                           w_sum: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The loss's gradient: ``grad * (softmax - onehot) * w[t] / max(wsum, 1e-8)``."""
    k = logits.shape[-1]
    p = torch.softmax(logits.float(), dim=-1)
    onehot = torch.nn.functional.one_hot(target.long(), k).float()
    scale = weight[target.long()] * (grad / torch.clamp_min(w_sum, 1e-8))
    return (p - onehot) * scale[..., None]


def _check(logits, target, weight, cm) -> None:
    if logits.dtype != torch.float32 or logits.dim() < 2 or not logits.is_contiguous():
        raise ValueError("weighted_ce: logits must be a contiguous (..., K) float32 tensor "
                         f"(K innermost), got {logits.dtype} {tuple(logits.shape)} with "
                         f"strides {logits.stride()}")
    k = logits.shape[-1]
    if not 1 <= k <= MAX_CLASSES:
        raise ValueError(f"weighted_ce: {k} classes (at most {MAX_CLASSES})")
    if (target.dtype != torch.int32 or target.shape != logits.shape[:-1]
            or not target.is_contiguous() or target.device != logits.device):
        raise ValueError(f"weighted_ce: target must be a contiguous "
                         f"{tuple(logits.shape[:-1])} int32 tensor on {logits.device}")
    if (weight.dtype != torch.float32 or tuple(weight.shape) != (k,)
            or weight.device != logits.device or not weight.is_contiguous()):
        raise ValueError(f"weighted_ce: weight must be a contiguous ({k},) float32 tensor "
                         f"on {logits.device}")
    if cm is not None and (cm.dtype != torch.int32 or tuple(cm.shape) != (k, k)
                           or not cm.is_contiguous() or cm.device != logits.device):
        raise ValueError(f"weighted_ce: cm must be a contiguous ({k}, {k}) int32 tensor "
                         f"on {logits.device}")


def _on_card(logits: torch.Tensor) -> bool:
    if logits.device.type == "cpu":
        return False
    if logits.device.type != "cuda":
        raise RuntimeError(f"weighted_ce: unsupported device {logits.device}")
    return True


class Plan(NamedTuple):
    """One call's launch: ``grid`` blocks walk the ``tiles`` tiles of TILE
    pixels (tile b, b + grid, ...); the first ``bulk_tiles`` move by TMA
    bulk copies, the rest (the last, ragged tile; every tile where a pointer
    is not 16-byte aligned) by 4-byte loads. A block's ring holds
    ``ring_bytes`` of dynamic shared memory, ``stage_bytes`` a tile (its
    logits, then its targets); the forward's scratch is ``scratch_words``
    32-bit words."""
    grid: int
    tiles: int
    bulk_tiles: int
    stage_bytes: int
    ring_bytes: int
    scratch_words: int


def launch_plan(n: int, k: int, mode: str, co_resident: int, aligned: bool = True) -> Plan:
    """The launch of a ``mode`` call ("forward" or "backward") over ``n``
    pixels of ``k`` classes, with at most ``co_resident`` blocks (the card's
    SMs times the kernel's occupancy). ``aligned``: the pointers are 16-byte
    aligned; the kernel checks them itself, so only ``bulk_tiles`` (what it
    will copy by TMA) depends on it."""
    tiles = -(-n // TILE)
    grid = max(1, min(co_resident, tiles))
    stage = TILE * (k + 1) * 4
    return Plan(grid, tiles, n // TILE if aligned else 0, stage, STAGES[mode] * stage,
                COUNTER_WORDS + 2 * grid if mode == "forward" else 0)


_CO_RESIDENT: dict[tuple, int] = {}
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _co_resident(device: torch.device, mode: str, k: int) -> int:
    """The blocks of ``mode``'s kernel that ``device`` holds at once: its
    SMs times the kernel's occupancy at k classes (queried once)."""
    key = (device.index, mode, k)
    n = _CO_RESIDENT.get(key)
    if n is None:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _build.entry("weighted_ce", OCCUPANCY_ARGTYPES, "weighted_ce_occupancy")(
                int(mode == "backward"), k, ctypes.byref(per_sm))
        _build.check(err, "weighted_ce occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        n = _CO_RESIDENT[key] = sms * max(1, per_sm.value)
    return n


def _scratch(device: torch.device, stream: int, words: int) -> torch.Tensor:
    """The forward's scratch on ``stream``: its ticket counter zero, and
    left zero by every call; grown (zeroed anew) when a call needs more."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = _SCRATCH[key] = torch.zeros(words, dtype=torch.int32, device=device)
    return buf


def weighted_ce(logits: torch.Tensor, target: torch.Tensor, weight: torch.Tensor,
                cm: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """As :func:`weighted_ce_plain` (no gradient). CPU tensors: the plain
    version. CUDA tensors: the kernel, or an error."""
    global launches
    _check(logits, target, weight, cm)
    if not _on_card(logits):
        return weighted_ce_plain(logits, target, weight, cm)
    n, k = target.numel(), logits.shape[-1]
    plan = launch_plan(n, k, "forward", _co_resident(logits.device, "forward", k))
    stream = _build.stream_handle(logits)
    scratch = _scratch(logits.device, stream, plan.scratch_words)
    out = torch.empty(2, dtype=torch.float32, device=logits.device)
    err = _build.entry("weighted_ce", FORWARD_ARGTYPES, "weighted_ce_forward")(
        logits.data_ptr(), target.data_ptr(), weight.data_ptr(),
        None if cm is None else cm.data_ptr(), scratch.data_ptr(), plan.grid, out.data_ptr(),
        n, k, stream)
    _build.check(err, "weighted_ce")
    launches += 1
    return out[0], out[1]


def weighted_ce_grad(logits: torch.Tensor, target: torch.Tensor, weight: torch.Tensor,
                     w_sum: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """As :func:`weighted_ce_grad_plain`; ``w_sum`` and ``grad`` are 0-d
    float32 tensors on the logits' device."""
    global backward_launches
    _check(logits, target, weight, None)
    if not _on_card(logits):
        return weighted_ce_grad_plain(logits, target, weight, w_sum, grad)
    grad = grad.float().reshape(1).contiguous()
    d = torch.empty_like(logits)
    n, k = target.numel(), logits.shape[-1]
    plan = launch_plan(n, k, "backward", _co_resident(logits.device, "backward", k))
    err = _build.entry("weighted_ce", BACKWARD_ARGTYPES, "weighted_ce_backward")(
        logits.data_ptr(), target.data_ptr(), weight.data_ptr(), w_sum.data_ptr(),
        grad.data_ptr(), d.data_ptr(), plan.grid, n, k, _build.stream_handle(logits))
    _build.check(err, "weighted_ce_backward")
    backward_launches += 1
    return d


class WeightedCE(torch.autograd.Function):
    """loss = WeightedCE.apply(logits, target, weight, cm): the weighted
    mean NLL, differentiable in ``logits``; the argmax's counts go into
    ``cm`` (None: not counted)."""

    @staticmethod
    def forward(ctx, logits, target, weight, cm):
        loss, w_sum = weighted_ce(logits, target, weight, cm)
        ctx.save_for_backward(logits, target, weight, w_sum)
        return loss

    @staticmethod
    def backward(ctx, grad):
        logits, target, weight, w_sum = ctx.saved_tensors
        return weighted_ce_grad(logits, target, weight, w_sum, grad), None, None, None
