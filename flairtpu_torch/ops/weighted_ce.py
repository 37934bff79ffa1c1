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
kernel for CUDA tensors; it has no fallback, and counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops.confmat import confusion_matrix

FORWARD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_void_p]
BACKWARD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_void_p]
MAX_CLASSES = 32
THREADS = 256
MAX_BLOCKS = 1056  # 8 blocks of 256 threads on each of the H100's 132 SMs

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


def _blocks(n: int) -> int:
    return max(1, min(-(-n // THREADS), MAX_BLOCKS))


def weighted_ce(logits: torch.Tensor, target: torch.Tensor, weight: torch.Tensor,
                cm: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """As :func:`weighted_ce_plain` (no gradient). CPU tensors: the plain
    version. CUDA tensors: the kernel, or an error."""
    global launches
    _check(logits, target, weight, cm)
    if not _on_card(logits):
        return weighted_ce_plain(logits, target, weight, cm)
    n, k = target.numel(), logits.shape[-1]
    blocks = _blocks(n)
    partials = torch.empty(2 * blocks, dtype=torch.float32, device=logits.device)
    out = torch.empty(2, dtype=torch.float32, device=logits.device)
    err = _build.entry("weighted_ce", FORWARD_ARGTYPES, "weighted_ce_forward")(
        logits.data_ptr(), target.data_ptr(), weight.data_ptr(),
        None if cm is None else cm.data_ptr(), partials.data_ptr(), blocks, out.data_ptr(),
        n, k, _build.stream_handle(logits))
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
    err = _build.entry("weighted_ce", BACKWARD_ARGTYPES, "weighted_ce_backward")(
        logits.data_ptr(), target.data_ptr(), weight.data_ptr(), w_sum.data_ptr(),
        grad.data_ptr(), d.data_ptr(), _blocks(n), n, k, _build.stream_handle(logits))
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
