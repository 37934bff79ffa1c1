"""Tile-order stitching of the average, average_weights and max methods
(``csrc/accumulate_probs.cu``, ``csrc/merge_max.cu``,
``csrc/stitch_finalize.cu``).

Replaces what XLA fused on the TPU in ``DeviceZoneRunner._run_accumulate``
and ``_run_max`` (``flairtpu/zone/device_engine.py:203-221, 517-539``) on
top of ``flairtpu/ops/fused.py:scatter_accumulate``. The planes are in
padded zone coordinates, at the tiles' padded origins; the finalize step
crops them.

- :func:`accumulate_probs`: one batch of full-tile logits -> softmax, times
  ``w * valid``, added in tile order into ``acc`` (Hp, Wp, K) and ``div``
  (Hp, Wp);
- :func:`merge_max`: one batch -> (argmax, max probability) per pixel,
  merged in tile order into ``best_p`` (Hp, Wp) float32 and ``best_c``
  (Hp, Wp) uint8 where strictly greater;
- :func:`stitch_finalize_mean` / :func:`stitch_finalize_max`: the planes ->
  (2, h, w) uint8 class and prob of the crop.

The batch kernels take the batch's footprint (:func:`footprint`), computed
on the host from the origins the host already holds, so no launch waits on
a device-to-host copy. Each wrapper runs the plain PyTorch version for a CPU
tensor and launches the kernel for a CUDA tensor; it has no fallback. The
counts in ``launches`` (one per kernel) grow only on kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops.fused import class_sum, prob_to_u8, scatter_accumulate, softmax

MAX_CLASSES = 32
_P, _I = ctypes.c_void_p, ctypes.c_int
ACCUMULATE_ARGTYPES = [_P] * 6 + [_I] * 8 + [_P]
MERGE_ARGTYPES = [_P] * 5 + [_I] * 8 + [_P]
FINALIZE_ARGTYPES = [_I] + [_P] * 3 + [_I] * 6 + [_P]

# kernel launches on CUDA tensors since the last reset (the CPU path does not count)
launches = {"accumulate_probs": 0, "merge_max": 0, "stitch_finalize": 0}


def footprint(origins: np.ndarray, valid: np.ndarray, size: int) -> tuple[int, int, int, int]:
    """(y0, x0, rows, cols): the rectangle that holds every tile of a batch
    whose valid is not 0; origins (B, 2) (row, col) on the host."""
    org = np.asarray(origins)[np.asarray(valid) != 0]
    y0, x0 = (int(v) for v in org.min(axis=0))
    y1, x1 = (int(v) + size for v in org.max(axis=0))
    return y0, x0, y1 - y0, x1 - x0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def accumulate_probs_plain(logits: torch.Tensor, origins: torch.Tensor, valid: torch.Tensor,
                           weights: torch.Tensor | None, acc: torch.Tensor,
                           div: torch.Tensor) -> None:
    """The reference's steps (``device_engine.py:203-210``): softmax of each
    tile, times ``w * valid`` (w formed first), scatter-added in tile order."""
    S = logits.shape[1]
    w = weights if weights is not None else torch.ones((S, S), dtype=torch.float32,
                                                       device=logits.device)
    wv = w[None] * valid[:, None, None]
    scatter_accumulate(acc, softmax(logits) * wv[..., None], origins)
    scatter_accumulate(div.unsqueeze(-1), wv[..., None], origins)


def merge_max_plain(logits: torch.Tensor, origins: torch.Tensor, best_p: torch.Tensor,
                    best_c: torch.Tensor) -> None:
    """The reference's scan (``device_engine.py:517-534``) over every tile of
    the batch: first-maximum argmax and 1 / sum exp(x - max) (the sum in
    ascending class order), taken where strictly greater than ``best_p``."""
    x = logits.to(torch.float32)
    m = x.amax(dim=-1, keepdim=True)
    cls = x.argmax(dim=-1).to(torch.uint8)
    prob = 1.0 / class_sum(torch.exp(x - m))
    S = logits.shape[1]
    for i, (r0, c0) in enumerate(origins.tolist()):
        cur_p, cur_c = best_p[r0:r0 + S, c0:c0 + S], best_c[r0:r0 + S, c0:c0 + S]
        better = prob[i] > cur_p
        cur_c.copy_(torch.where(better, cls[i], cur_c))
        cur_p.copy_(torch.where(better, prob[i], cur_p))


def _crop(t: torch.Tensor, crop) -> torch.Tensor:
    oy, ox, h, w = crop
    return t[oy:oy + h, ox:ox + w]


def stitch_finalize_mean_plain(acc: torch.Tensor, div: torch.Tensor, crop) -> torch.Tensor:
    """mean = acc / max(div, 1e-8); (first-maximum argmax, round(255 max)) of
    the crop (oy, ox, h, w), as (2, h, w) uint8 (``device_engine.py:216-220``)."""
    mean = _crop(acc, crop) / torch.clamp_min(_crop(div, crop), 1e-8)[..., None]
    return torch.stack([mean.argmax(dim=-1).to(torch.uint8), prob_to_u8(mean.amax(dim=-1))])


def stitch_finalize_max_plain(best_p: torch.Tensor, best_c: torch.Tensor, crop) -> torch.Tensor:
    """(best_c, round(255 best_p)) of the crop, as (2, h, w) uint8
    (``device_engine.py:539``)."""
    return torch.stack([_crop(best_c, crop), prob_to_u8(_crop(best_p, crop))])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _on_card(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {t.device}")
    return True


def _require(name: str, what: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
             device: torch.device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous {tuple(shape)} {dtype} tensor "
                         f"on {device} (got {tuple(t.shape)} {t.dtype} on {t.device})")


def _check_batch(name: str, logits, origins, valid, planes: tuple, fp) -> tuple[int, int, int]:
    """Checks shared by the two batch kernels; returns (B, S, K)."""
    if logits.dtype != torch.float32 or logits.dim() != 4 or not logits.is_contiguous():
        raise ValueError(f"{name}: logits must be a contiguous (B, S, S, K) float32 tensor")
    B, S, S2, K = logits.shape
    if S != S2 or not 1 <= K <= MAX_CLASSES:
        raise ValueError(f"{name}: logits {tuple(logits.shape)}: square tiles and 1 <= K <= "
                         f"{MAX_CLASSES} classes")
    dev = logits.device
    _require(name, "origins", origins, torch.int32, (B, 2), dev)
    _require(name, "valid", valid, torch.float32, (B,), dev)
    for what, t, dtype, shape in planes:
        _require(name, what, t, dtype, shape, dev)
    rows, cols = planes[0][1].shape[:2]
    y0, x0, fh, fw = fp
    if not (0 <= y0 and 0 <= x0 and fh >= 1 and fw >= 1 and y0 + fh <= rows
            and x0 + fw <= cols):
        raise ValueError(f"{name}: footprint {fp} outside the ({rows}, {cols}) planes")
    return B, S, K


def accumulate_probs(logits: torch.Tensor, origins: torch.Tensor, valid: torch.Tensor,
                     weights: torch.Tensor | None, acc: torch.Tensor, div: torch.Tensor,
                     fp: tuple[int, int, int, int]) -> None:
    """Add one batch into ``acc`` (Hp, Wp, K) and ``div`` (Hp, Wp) in place.

    logits (B, S, S, K) float32; origins (B, 2) int32 in the planes; valid
    (B,) float32; weights (S, S) float32 or None (plain average); ``fp`` the
    batch's footprint (:func:`footprint`). CPU tensors: the plain version.
    CUDA tensors: the kernel, or an error."""
    name = "accumulate_probs"
    if not _on_card(name, logits):
        return accumulate_probs_plain(logits, origins, valid, weights, acc, div)
    Hp, Wp = div.shape[:2] if div.dim() == 2 else (-1, -1)
    B, S, K = _check_batch(name, logits, origins, valid,
                           (("acc", acc, torch.float32, (Hp, Wp, logits.shape[-1])),
                            ("div", div, torch.float32, (Hp, Wp))), fp)
    if weights is not None:
        _require(name, "weights", weights, torch.float32, (S, S), logits.device)
    err = _build.entry(name, ACCUMULATE_ARGTYPES)(
        logits.data_ptr(), origins.data_ptr(), valid.data_ptr(),
        None if weights is None else weights.data_ptr(), acc.data_ptr(), div.data_ptr(),
        B, S, K, Wp, *fp, _build.stream_handle(logits))
    _build.check(err, name)
    launches[name] += 1


def merge_max(logits: torch.Tensor, origins: torch.Tensor, valid: torch.Tensor,
              best_p: torch.Tensor, best_c: torch.Tensor, fp: tuple[int, int, int, int]) -> None:
    """Merge one batch into ``best_p`` (Hp, Wp) float32 and ``best_c``
    (Hp, Wp) uint8 in place. The kernel leaves out tiles whose valid is 0
    (padding duplicates, which cannot win); the plain version merges every
    tile, as the reference does, to the same planes. CPU tensors: the plain
    version. CUDA tensors: the kernel, or an error."""
    name = "merge_max"
    if not _on_card(name, logits):
        return merge_max_plain(logits, origins, best_p, best_c)
    Hp, Wp = best_p.shape if best_p.dim() == 2 else (-1, -1)
    B, S, K = _check_batch(name, logits, origins, valid,
                           (("best_p", best_p, torch.float32, (Hp, Wp)),
                            ("best_c", best_c, torch.uint8, (Hp, Wp))), fp)
    err = _build.entry(name, MERGE_ARGTYPES)(
        logits.data_ptr(), origins.data_ptr(), valid.data_ptr(), best_p.data_ptr(),
        best_c.data_ptr(), B, S, K, Wp, *fp, _build.stream_handle(logits))
    _build.check(err, name)
    launches[name] += 1


def _finalize(mode: int, a0: torch.Tensor, a1: torch.Tensor, k: int, crop) -> torch.Tensor:
    name = "stitch_finalize"
    oy, ox, h, w = crop
    rows, cols = a1.shape
    if not (0 <= oy and 0 <= ox and h >= 1 and w >= 1 and oy + h <= rows and ox + w <= cols):
        raise ValueError(f"{name}: crop {crop} outside the ({rows}, {cols}) planes")
    out = torch.empty((2, h, w), dtype=torch.uint8, device=a0.device)
    err = _build.entry(name, FINALIZE_ARGTYPES)(
        mode, a0.data_ptr(), a1.data_ptr(), out.data_ptr(), k, cols, oy, ox, h, w,
        _build.stream_handle(a0))
    _build.check(err, name)
    launches[name] += 1
    return out


def stitch_finalize_mean(acc: torch.Tensor, div: torch.Tensor, crop) -> torch.Tensor:
    """acc (Hp, Wp, K), div (Hp, Wp) float32 -> (2, h, w) uint8 class and prob
    of the crop (oy, ox, h, w). CPU tensors: the plain version. CUDA
    tensors: the kernel, or an error."""
    if not _on_card("stitch_finalize", acc):
        return stitch_finalize_mean_plain(acc, div, crop)
    Hp, Wp = div.shape if div.dim() == 2 else (-1, -1)
    k = acc.shape[-1]
    _require("stitch_finalize", "acc", acc, torch.float32, (Hp, Wp, k), acc.device)
    _require("stitch_finalize", "div", div, torch.float32, (Hp, Wp), acc.device)
    return _finalize(0, acc, div, k, crop)


def stitch_finalize_max(best_p: torch.Tensor, best_c: torch.Tensor, crop) -> torch.Tensor:
    """best_p (Hp, Wp) float32, best_c (Hp, Wp) uint8 -> (2, h, w) uint8
    class and prob of the crop (oy, ox, h, w). CPU tensors: the plain
    version. CUDA tensors: the kernel, or an error."""
    if not _on_card("stitch_finalize", best_p):
        return stitch_finalize_max_plain(best_p, best_c, crop)
    shape = tuple(best_p.shape)
    _require("stitch_finalize", "best_p", best_p, torch.float32, shape, best_p.device)
    _require("stitch_finalize", "best_c", best_c, torch.uint8, shape, best_p.device)
    if len(shape) != 2:
        raise ValueError(f"stitch_finalize: best_p must be (Hp, Wp), got {shape}")
    return _finalize(1, best_p, best_c, 1, crop)
