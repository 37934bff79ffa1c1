"""Full-tile softmax payloads of the streaming zone route
(``csrc/tile_softmax.cu``).

Replaces what XLA fused on the TPU in ``ZoneEngine.device_fn``
(``flairtpu/zone/engine.py:138-145``) on the whole-tile logits that the
fused tail's logits mode writes (``ops/fused_tail.py:fused_tail_logits`` at
margin 0), (B, S, S, K) float32, K innermost:

- :func:`tile_probs` (``full_probs``, the average stitches): the softmax as
  (B, K, S, S) float32;
- :func:`tile_argmax` (``full_argmax``, the max stitch): the first-maximum
  class (B, S, S) uint8 and 1 / sum exp(x - max), (B, S, S) float32.

The per-pixel arithmetic is that of ``ops/fused.py:softmax`` and of the
device route's stitch kernels (``ops/stitch.py``), the class sum in
ascending order. Each wrapper runs the plain PyTorch version for a CPU
tensor and launches the kernel for a CUDA tensor; it has no fallback. The
counts in ``launches`` grow only on kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops.fused import class_sum, softmax

MAX_CLASSES = 32
PROBS, ARGMAX = 0, 1  # the kernel's modes
ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

# kernel launches on CUDA tensors since the last reset (the CPU path does not count)
launches = {"tile_probs": 0, "tile_argmax": 0}


def tile_probs_plain(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, S, S, K) -> softmax (B, K, S, S) float32."""
    return softmax(logits).permute(0, 3, 1, 2).contiguous()


def tile_argmax_plain(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """logits (B, S, S, K) -> (first-maximum class uint8, 1 / sum exp(x - max)
    float32), both (B, S, S)."""
    x = logits.to(torch.float32)
    m = x.amax(dim=-1, keepdim=True)
    return x.argmax(dim=-1).to(torch.uint8), 1.0 / class_sum(torch.exp(x - m))


def _check(name: str, logits: torch.Tensor) -> tuple[int, int, int]:
    """Raise unless the kernel takes ``logits``; returns (B, S, K)."""
    if logits.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {logits.device}")
    if logits.dtype != torch.float32 or logits.dim() != 4 or not logits.is_contiguous():
        raise ValueError(f"{name}: logits must be a contiguous (B, S, S, K) float32 tensor "
                         f"(got {tuple(logits.shape)} {logits.dtype})")
    B, S, S2, K = logits.shape
    if S != S2 or not 1 <= K <= MAX_CLASSES or B < 1:
        raise ValueError(f"{name}: logits {tuple(logits.shape)}: square tiles and 1 <= K <= "
                         f"{MAX_CLASSES} classes")
    return B, S, K


def _launch(name: str, mode: int, logits: torch.Tensor, out0: torch.Tensor,
            out1: torch.Tensor | None) -> None:
    B, S, K = logits.shape[0], logits.shape[1], logits.shape[3]
    err = _build.entry("tile_softmax", ARGTYPES)(
        mode, logits.data_ptr(), out0.data_ptr(), None if out1 is None else out1.data_ptr(),
        B, S, K, _build.stream_handle(logits))
    _build.check(err, "tile_softmax")
    launches[name] += 1


def tile_probs(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, S, K) float32 logits -> softmax (B, K, S, S) float32. CPU
    tensor: the plain version. CUDA tensor: the kernel, or an error."""
    if logits.device.type == "cpu":
        return tile_probs_plain(logits)
    B, S, K = _check("tile_probs", logits)
    out = torch.empty((B, K, S, S), dtype=torch.float32, device=logits.device)
    _launch("tile_probs", PROBS, logits, out, None)
    return out


def tile_argmax(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, S, K) float32 logits -> (class uint8, prob float32) (B, S, S).
    CPU tensor: the plain version. CUDA tensor: the kernel, or an error."""
    if logits.device.type == "cpu":
        return tile_argmax_plain(logits)
    B, S, _ = _check("tile_argmax", logits)
    cls = torch.empty((B, S, S), dtype=torch.uint8, device=logits.device)
    prob = torch.empty((B, S, S), dtype=torch.float32, device=logits.device)
    _launch("tile_argmax", ARGMAX, logits, cls, prob)
    return cls, prob
