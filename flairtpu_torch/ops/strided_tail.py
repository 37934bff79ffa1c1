"""Strided-head tail: the align-corners upsample of the head's float32
logits, the softmax epilogue and the exact-clipping plane writes in one
CUDA kernel (``csrc/strided_tail.cu``), for the smp decoders whose head
runs at a stride (deeplabv3plus, fpn and pan at U = 4, deeplabv3 and
pspnet at U = 8) and for linknet's full-resolution logits (U = 1).

Replaces what XLA fused on the TPU after those heads: the windowed
align-corners upsample (``flairtpu/models/deeplab.py:73-91``, called at
``flairtpu/models/factory.py:285-293``), ``softmax_argmax``
(``flairtpu/ops/fused.py:38-45``) and the exact-clip plane writes
(``flairtpu/zone/device_engine.py:140-160``). Its three modes are
``fused_tail``'s (``ops/fused_tail.py``), with the same windows and planes:

- :func:`strided_tail` (argmax): the class and probability of each tile's
  owned window (``windows[b] = (R0, C0, rlo, rhi, clo, chi)``, indices into
  the s x s interior) into the zone's two uint8 planes, or into (B, s, s)
  tiles;
- :func:`strided_tail_probs` (``class_prob``): round(255 * softmax), the
  class sum in ascending order, into one (H, W, K) uint8 plane;
- :func:`strided_tail_logits` (the average and max stitches, the streaming
  route's full-tile payloads): the whole tile's upsampled float32 logits
  (B, S, S, K) at margin 0.

Only the rows and columns [m, S - m) of the upsample are computed, as
``flairtpu``'s window does: two taps a row and a column, the H pass then the
W pass, with the weights of ``_align_corners_weights``
(:func:`flairtpu_torch.models.deeplab.align_corners_taps`). The plain
version multiplies by those weight matrices' rows, as ``flairtpu`` does,
then runs ``ops/fused.py``'s softmax epilogues and writes the windows; at
U = 1 the matrices are the identity and it crops. Each wrapper runs the
plain version for a CPU tensor and launches the kernel for a float32 CUDA
tensor, or raises; it counts its own launches. The kernel computes the H
pass once per (window row, source column) of a band of window rows that
one block stages; :func:`launch_plan` sizes the bands, the staged source
run and the block's shared memory, and passes them to the C entry point.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from flairtpu_torch.models.deeplab import align_corners_taps, align_corners_weights
from flairtpu_torch.ops import _build
from flairtpu_torch.ops.fused import prob_to_u8, softmax, softmax_argmax, write_windows
from flairtpu_torch.ops.fused_tail import full_windows

MAX_CLASSES = 32
ARGMAX, PROBS, LOGITS = 0, 1, 2  # the kernel's modes
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
# the kernel's launch constants (csrc/strided_tail.cu: kThreads, kRunPad,
# kOutPadBytes): threads a block, floats past a staged source run, bytes past
# a staged output run
THREADS, RUN_PAD, OUT_PAD_BYTES = 256, 6, 16
# a band's window rows (at U = 1, where a staged row serves one window row:
# IDENTITY_BAND_ROWS), a chunk's window columns, and the shared memory a
# block may opt into on an H100
BAND_ROWS, IDENTITY_BAND_ROWS = 8, 2
CHUNK_COLS = 256
MAX_SMEM_BYTES = 232448

# kernel launches on CUDA tensors since the last reset, one count per
# wrapper (the CPU path does not count)
launches = 0  # strided_tail (argmax)
probs_launches = 0  # strided_tail_probs
logits_launches = 0  # strided_tail_logits


@dataclass(frozen=True)
class StridedTail:
    """The tail of a strided-head model: its upsample factor ``up`` (the
    tile over the head's logits), its classes and the device it runs on. It
    holds no weights: the head is the model's, a convolution."""

    up: int
    n_classes: int
    device: torch.device

    def wrappers(self) -> tuple:
        """(argmax, probs, logits): this kind's kernel wrappers."""
        return strided_tail, strided_tail_probs, strided_tail_logits

    def plain_versions(self) -> tuple:
        """(argmax, probs, logits): the wrappers' plain versions."""
        return strided_tail_plain, strided_tail_probs_plain, strided_tail_logits_plain

    def geometry(self, size: int, margin: int) -> StridedGeometry:
        return strided_geometry(size, margin, self.up)


@dataclass(frozen=True)
class StridedGeometry:
    """Tiles of ``size`` pixels, the head's logits ``size // up`` a side, the
    window [margin, size - margin) of the upsample kept: ``out_extent`` =
    size - 2 margin."""

    size: int
    margin: int
    up: int

    @property
    def n_in(self) -> int:
        return self.size // self.up

    @property
    def out_extent(self) -> int:
        return self.size - 2 * self.margin


def strided_geometry(size: int, margin: int, up: int) -> StridedGeometry:
    if size % up or not 0 <= 2 * margin < size:
        raise ValueError(f"strided tail: a {size}-pixel tile, margin {margin}, upsample {up} "
                         "(the tile must be a multiple of the upsample, the margin under half)")
    return StridedGeometry(size, margin, up)


def taps(g: StridedGeometry) -> tuple[np.ndarray, np.ndarray]:
    """((2, s) int32 source indices lo, hi; (2, s) float32 weights) of the
    window's rows (and columns): ``_align_corners_weights(size, n_in)``'s
    rows [margin, size - margin) as two taps each."""
    lo, hi, w_lo, w_hi = align_corners_taps(g.size, g.n_in)
    win = slice(g.margin, g.size - g.margin)
    return (np.stack([lo[win], hi[win]]).astype(np.int32),
            np.stack([w_lo[win], w_hi[win]]).astype(np.float32))


def taps_needed(g: StridedGeometry, lo: int, hi: int) -> int:
    """Distinct source indices with a nonzero weight that output window
    indices [lo, hi) read."""
    idx, wts = taps(g)
    return len(set(idx[0][lo:hi][wts[0][lo:hi] > 0]) | set(idx[1][lo:hi][wts[1][lo:hi] > 0]))


def strided_cost(g: StridedGeometry, windows: np.ndarray, k: int, mode: str) -> tuple[int, int]:
    """(operations, bytes) of one call as the separable function needs them:
    each needed source logit read once, each window pixel written once (2
    bytes, k bytes or 4k bytes); for U > 1 the H pass's 3 operations (two
    products, a sum) a class at each (window row, needed source column), the
    W pass's 3 a class at each window pixel (U = 1: the identity, none); the
    softmax 3 more a value (argmax) or 5 (probs)."""
    ops = nbytes = 0
    for _, _, rlo, rhi, clo, chi in windows.tolist():
        if rlo >= rhi or clo >= chi:
            continue
        pix = (rhi - rlo) * (chi - clo)
        cols = taps_needed(g, clo, chi)
        nbytes += taps_needed(g, rlo, rhi) * cols * k * 4
        nbytes += pix * {"argmax": 2, "probs": k, "logits": 4 * k}[mode]
        if g.up > 1:
            ops += 3 * k * ((rhi - rlo) * cols + pix)
        ops += pix * k * {"argmax": 3, "probs": 5, "logits": 0}[mode]
    return ops, nbytes


def kernel_taps(g: StridedGeometry) -> tuple[np.ndarray, np.ndarray]:
    """:func:`taps` as the kernel takes them: hi = lo where hi's weight is
    0, so that every index a block reads carries a weight and lies in the
    source run it stages (the product of a weight 0 is 0 either way)."""
    idx, wts = taps(g)
    idx = idx.copy()
    idx[1] = np.where(wts[1] > 0, idx[1], idx[0])
    return idx, wts


@lru_cache(maxsize=None)
def device_taps(g: StridedGeometry, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`kernel_taps` on ``device``, kept for every geometry a process
    uses: a new one's blocking copy waits for all the work queued on the
    card before it."""
    idx, wts = kernel_taps(g)
    return torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device)


@dataclass(frozen=True)
class Plan:
    """A launch of the kernel: ``rows`` window rows by ``cols`` window
    columns a block, the most source rows and columns any block stages, its
    shared memory and the grid (column chunks, bands, tiles)."""

    rows: int
    cols: int
    src_rows: int
    src_cols: int
    smem_bytes: int
    grid: tuple[int, int, int]


def _round4(v: int) -> int:
    return (v + 3) & ~3


def smem_bytes(rows: int, cols: int, src_rows: int, src_cols: int, k: int, mode: int,
               identity: bool) -> int:
    """A block's shared memory, as the kernel lays it out: the staged source
    rows (``src_cols * k`` floats and RUN_PAD, in whole 16-byte chunks), at
    U > 1 the H pass's rows (each staged column an odd number of 16-byte
    chunks of classes), and for probs and logits two output row buffers,
    used in turn."""
    stage = src_rows * _round4(src_cols * k + RUN_PAD)
    hbuf = 0 if identity else rows * src_cols * 4 * (((k + 3) // 4) | 1)
    out = {ARGMAX: 0, PROBS: (cols * k + OUT_PAD_BYTES + 15) & ~15,
           LOGITS: 4 * _round4(cols * k + OUT_PAD_BYTES // 4)}[mode]
    return 4 * (stage + hbuf) + 2 * out


def staged_extent(lo: np.ndarray, hi: np.ndarray, step: int) -> int:
    """The most source indices [lo[first], hi[last]] that a block of
    ``step`` consecutive window indices stages (the taps are nondecreasing)."""
    first = np.arange(0, len(lo), step)
    last = np.minimum(first + step, len(lo)) - 1
    return int((hi[last] - lo[first]).max()) + 1


@lru_cache(maxsize=64)
def launch_plan(g: StridedGeometry, k: int, mode: int, batch: int, rows: int | None = None,
                cols: int | None = None) -> Plan:
    """The launch of one call of ``batch`` tiles: a band of BAND_ROWS (or
    ``rows``) window rows by CHUNK_COLS (or ``cols``) columns a block, the
    chunk halved until a block's shared memory fits MAX_SMEM_BYTES."""
    idx, _ = kernel_taps(g)
    rows = rows or (IDENTITY_BAND_ROWS if g.up == 1 else BAND_ROWS)
    s, cols = g.out_extent, cols or CHUNK_COLS
    src_rows = staged_extent(idx[0], idx[1], rows)
    while True:
        src_cols = staged_extent(idx[0], idx[1], cols)
        smem = smem_bytes(rows, cols, src_rows, src_cols, k, mode, g.up == 1)
        if smem <= MAX_SMEM_BYTES or cols <= 32:
            break
        cols //= 2
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"strided_tail: no launch fits {MAX_SMEM_BYTES} bytes of shared "
                         f"memory at {g}, {k} classes")
    return Plan(rows, cols, src_rows, src_cols, smem, (-(-s // cols), -(-s // rows), batch))


def upsample_window(x: torch.Tensor, g: StridedGeometry) -> torch.Tensor:
    """x (B, n, n, K) float32 -> rows and columns [margin, size - margin) of
    the align-corners upsample to size, (B, s, s, K) float32: the rows of
    the weight matrices, as ``flairtpu/models/deeplab.py:73-91``; at U = 1
    the crop (the matrices are the identity)."""
    lo, hi = g.margin, g.size - g.margin
    if g.up == 1:
        return x[:, lo:hi, lo:hi].float()
    w = torch.from_numpy(align_corners_weights(g.size, g.n_in)[lo:hi]).to(x.device)
    y = torch.einsum("oh,bhwk->bowk", w, x.float())
    return torch.einsum("pw,bowk->bopk", w, y)


def strided_tail_plain(x: torch.Tensor, p: StridedTail, g: StridedGeometry,
                       planes: torch.Tensor | None = None, windows: torch.Tensor | None = None):
    """Plain PyTorch: x -> (class, prob) uint8 (B, s, s), or with ``planes``
    and ``windows`` the owned windows written into the planes (returns the
    planes)."""
    cls, prob = softmax_argmax(upsample_window(x, g), dim=-1)
    cls, prob = cls.to(torch.uint8), prob_to_u8(prob)
    if planes is None:
        return cls, prob
    write_windows([planes[0], planes[1]], [cls, prob], windows)
    return planes


def strided_tail_probs_plain(x: torch.Tensor, p: StridedTail, g: StridedGeometry,
                             plane: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: round(255 * softmax) of each tile's owned window into
    ``plane`` (H, W, K); returns the plane."""
    write_windows([plane], [prob_to_u8(softmax(upsample_window(x, g), dim=-1))], windows)
    return plane


def strided_tail_logits_plain(x: torch.Tensor, p: StridedTail, g: StridedGeometry,
                              out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch: the window's upsampled float32 logits (B, s, s, K),
    into ``out`` when given."""
    logits = upsample_window(x, g).contiguous()
    return logits if out is None else out.copy_(logits)


def _on_card(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one (the
    kernel); raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    return True


def _check_input(name: str, x: torch.Tensor, p: StridedTail, g: StridedGeometry) -> None:
    """Raise unless x is what the kernel takes."""
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: logits must be a contiguous (B, n, n, K) float32 tensor "
                         f"(got {tuple(x.shape)} {x.dtype})")
    B, n, n2, K = x.shape
    if (n, n2) != (g.n_in, g.n_in) or K != p.n_classes or not 1 <= K <= MAX_CLASSES:
        raise ValueError(f"{name}: logits {tuple(x.shape)} for ({B}, {g.n_in}, {g.n_in}, "
                         f"{p.n_classes}), 1 <= K <= {MAX_CLASSES}")


def _check_plane(name: str, plane: torch.Tensor, x: torch.Tensor, dims: int, dtype,
                 k: int | None) -> None:
    if (plane.device != x.device or plane.dtype != dtype or plane.dim() != dims
            or not plane.is_contiguous() or (k is not None and plane.shape[-1] != k)):
        raise ValueError(f"{name}: the output must be a contiguous {dims}-d {dtype} tensor"
                         f"{f' of {k} classes' if k else ''} on {x.device}")


def _check_windows(name: str, windows, x: torch.Tensor) -> None:
    B = x.shape[0]
    if (windows is None or windows.device != x.device or windows.dtype != torch.int32
            or tuple(windows.shape) != (B, 6) or not windows.is_contiguous()):
        raise ValueError(f"{name}: windows must be a contiguous ({B}, 6) int32 tensor "
                         f"on {x.device}")


def _launch(x: torch.Tensor, g: StridedGeometry, windows: torch.Tensor, out0: torch.Tensor,
            out1: torch.Tensor | None, pitch: int, mode: int) -> None:
    idx, wts = device_taps(g, x.device)
    plan = launch_plan(g, x.shape[3], mode, x.shape[0])
    err = _build.entry("strided_tail", ARGTYPES)(
        x.data_ptr(), idx.data_ptr(), wts.data_ptr(), windows.data_ptr(), out0.data_ptr(),
        None if out1 is None else out1.data_ptr(), pitch, x.shape[0], g.n_in, g.out_extent,
        x.shape[3], mode, plan.rows, plan.cols, plan.src_rows, plan.src_cols, int(g.up == 1),
        plan.smem_bytes, _build.stream_handle(x))
    _build.check(err, "strided_tail")


def strided_tail(x: torch.Tensor, p: StridedTail, g: StridedGeometry,
                 planes: torch.Tensor | None = None, windows: torch.Tensor | None = None):
    """x (B, n, n, K) float32 head logits -> (class, prob) uint8 (B, s, s);
    or, with ``planes`` (2, H, W) uint8 and ``windows`` (B, 6) int32, each
    tile's owned window written into the planes (returns the planes).

    CPU tensor: the plain version. float32 CUDA tensor: the kernel, or an
    error."""
    global launches
    if not _on_card("strided_tail", x):
        return strided_tail_plain(x, p, g, planes, windows)
    _check_input("strided_tail", x, p, g)
    B, s = x.shape[0], g.out_extent
    tiles = planes is None
    if tiles:
        planes = torch.empty((2, B * s, s), dtype=torch.uint8, device=x.device)
        windows = full_windows(B, s, x.device)
    elif planes.shape[0] != 2:
        raise ValueError("strided_tail: planes must be (2, H, W)")
    _check_plane("strided_tail", planes, x, 3, torch.uint8, None)
    _check_windows("strided_tail", windows, x)
    _launch(x, g, windows, planes[0], planes[1], planes.shape[2], ARGMAX)
    launches += 1
    if tiles:
        return planes[0].view(B, s, s), planes[1].view(B, s, s)
    return planes


def strided_tail_probs(x: torch.Tensor, p: StridedTail, g: StridedGeometry,
                       plane: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """x (B, n, n, K) float32 -> each tile's owned window of round(255 *
    softmax) written into ``plane`` (H, W, K) uint8 through ``windows``;
    returns the plane.

    CPU tensor: the plain version. float32 CUDA tensor: the kernel, or an
    error."""
    global probs_launches
    if not _on_card("strided_tail_probs", x):
        return strided_tail_probs_plain(x, p, g, plane, windows)
    _check_input("strided_tail_probs", x, p, g)
    _check_plane("strided_tail_probs", plane, x, 3, torch.uint8, p.n_classes)
    _check_windows("strided_tail_probs", windows, x)
    _launch(x, g, windows, plane, None, plane.shape[1], PROBS)
    probs_launches += 1
    return plane


def strided_tail_logits(x: torch.Tensor, p: StridedTail, g: StridedGeometry,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, n, n, K) float32 -> the upsampled float32 logits (B, s, s, K)
    (at margin 0 the whole tile), into ``out`` when given.

    CPU tensor: the plain version. float32 CUDA tensor: the kernel, or an
    error."""
    global logits_launches
    if not _on_card("strided_tail_logits", x):
        return strided_tail_logits_plain(x, p, g, out)
    _check_input("strided_tail_logits", x, p, g)
    B, s, k = x.shape[0], g.out_extent, p.n_classes
    if out is None:
        out = torch.empty((B, s, s, k), dtype=torch.float32, device=x.device)
    elif tuple(out.shape) != (B, s, s, k):
        raise ValueError(f"strided_tail_logits: out must be ({B}, {s}, {s}, {k})")
    _check_plane("strided_tail_logits", out, x, 4, torch.float32, k)
    _launch(x, g, full_windows(B, s, x.device), out, None, s, LOGITS)
    logits_launches += 1
    return out
