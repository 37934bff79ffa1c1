"""Device-resident zone inference: gather -> forward -> stitch on the card
(counterpart of ``flairtpu/zone/device_engine.py:56-221, 512-748``).

The whole margin-padded zone sits in device memory; each batch of
tiles is gathered and normalized by one kernel (``ops/gather.py``) and runs
through the encoder and all decoder blocks but the last (cuDNN convolutions,
each followed by the conv-epilogue kernel, ``ops/epilogue.py``). Then, by
stitching method and output type (a U-Net's tail; the strided-head smp
models run their whole decoder and head and the same three modes of
``ops/strided_tail.py``, which upsamples the head's logits, see
``flairtpu/zone/device_engine.py:110-122``):

- exact-clipping, argmax: the fused decoder-tail kernel
  (``ops/fused_tail.py``) writes the uint8 class and probability of each
  tile's owned window straight into two planes. The windows
  (:func:`exact_windows`) give each plane pixel to the tile that the
  reference's tile-order writes leave there (last write wins), so the kernel
  needs no ordering;
- class_prob (any method: the reference forces exact clipping): the tail's
  probs mode writes round(255 * softmax) of each class through the same
  windows into one (H, W, K) plane;
- average, average_weights and max decode the whole tile (margin 0): the
  tail's logits mode writes each batch's float32 logits (linknet's head
  logits are those already, and are handed through), and
  ``ops/stitch.py``'s kernels add them, in tile order, into accumulators in
  padded zone coordinates, then crop them to the uint8 class and prob
  planes.

The result comes back to the host in one transfer.

The banded route (``FLAIRTPU_ZONE_BANDS`` = n > 1, exact clipping with
argmax output, ``flairtpu/zone/device_engine.py:416-510, 618-623``) keeps
the margin-padded zone in pinned host memory and cuts the tile rows into n
bands: each band's slab of zone rows goes up on one CUDA stream, its
batches run on a second, and its owned rows of the two planes come back on
a third, so that one band's copies overlap another band's compute. The
sharded programs are not ported yet.

Zones are uint8, uint16, int16 or float32 (``ZONE_DTYPES``), uploaded in
their own dtype.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from flairtpu_torch.config import not_ported
from flairtpu_torch.ops import stitch, tile_softmax
from flairtpu_torch.ops.fused_tail import TailParams
from flairtpu_torch.ops.gather import gather_normalize
from flairtpu_torch.ops.strided_tail import StridedTail
from flairtpu_torch.zone.grid import Tile, TileGrid
from flairtpu_torch.zone.weights import patch_weights

DEFAULT_BUDGET = 6 << 30
# raster dtypes both zone routes take (the gather kernel's instances)
ZONE_DTYPES = tuple(np.dtype(t) for t in (np.uint8, np.uint16, np.int16, np.float32))


def device_budget_bytes() -> int:
    return int(os.environ.get("FLAIRTPU_DEVICE_ZONE_BYTES", DEFAULT_BUDGET))


def zone_bands(method: str, output_type: str, tiles: list[Tile]) -> int:
    """The band count when a device run takes the banded route, else 0:
    ``FLAIRTPU_ZONE_BANDS`` = n > 1 for exact clipping with argmax output
    over at least n distinct tile rows (``flairtpu/zone/device_engine.py:
    620-623``)."""
    n = int(os.environ.get("FLAIRTPU_ZONE_BANDS", "1"))
    if (method == "exact-clipping" and output_type == "argmax" and n > 1
            and len({t.row0 for t in tiles}) >= n):
        return n
    return 0


def band_rows(rows: list[int], n_bands: int) -> list[list[int]]:
    """The distinct tile rows cut into at most n bands of ceil(rows / n), in
    descending row order, empty bands dropped (``device_engine.py:434-438``)."""
    rows = sorted(set(rows), reverse=True)
    per = -(-len(rows) // n_bands)
    return [b for b in (rows[i * per:(i + 1) * per] for i in range(n_bands)) if b]


def band_plans(grid: TileGrid, n_bands: int, batch: int) -> list[dict]:
    """Each band of :func:`band_rows`, in its run order: ``tiles`` (their
    indices in the grid, in grid order), ``rows`` (first padded zone row of
    its slab, slab rows), ``origins`` (n, 2) int32 of its tiles in the
    slab and ``windows`` (n, 6) int32, their owned windows of
    :func:`exact_windows` with the origin row shifted by ``out_lo`` into
    band planes of ``out_h`` rows, both padded to whole batches with
    duplicates of the last tile, whose windows are empty; and ``own``: the
    band plane rows [lo, hi) that its tiles own (empty when they own
    none). Whole batches keep every batch at the unbanded route's shapes:
    cuDNN picks its algorithms by shape, and a short batch need not give
    the same bits."""
    S, m = grid.patch_size, grid.margin
    s = S - 2 * m
    pad_lo = zone_padding(grid.height, grid.width, S, m)[0]
    tiles = grid.tiles
    windows = exact_windows(tiles, grid.height, grid.width, s, len(tiles))
    bands = []
    for rows in band_rows([t.row0 for t in tiles], n_bands):
        keep = set(rows)
        idx = [i for i, t in enumerate(tiles) if t.row0 in keep]
        top = min(rows)
        n_pad = (-len(idx)) % batch
        win = np.concatenate([windows[idx], np.zeros((n_pad, 6), np.int32)])
        out_lo = int(win[:len(idx), 0].min())
        win[:len(idx), 0] -= out_lo
        owned = win[:, 2] < win[:, 3]  # tiles whose window is not empty
        own = ((int((win[owned, 0] + win[owned, 2]).min()),
                int((win[owned, 0] + win[owned, 3]).max())) if owned.any() else (0, 0))
        bands.append(dict(
            tiles=idx, rows=(top + pad_lo, max(rows) - top + S), out_lo=out_lo, own=own,
            out_h=int(win[:, 0].max()) + s, windows=win,
            origins=np.array([(tiles[i].row0 - top, tiles[i].col0 + pad_lo)
                              for i in idx + idx[-1:] * n_pad], np.int32)))
    return bands


def zone_padding(height: int, width: int, size: int, margin: int) -> tuple[int, int, int]:
    """(pad_lo, pad_hi_rows, pad_hi_cols) of the padded zone: origins live in
    [0, H+2m-S] (the grid clamps the last row/col), so m on each side covers
    every S-row gather; zones smaller than a patch need extra tail padding so
    that the padded extent reaches S."""
    return margin, max(margin, size - height - margin), max(margin, size - width - margin)


def estimate_bytes(grid: TileGrid, n_channels: int, n_classes: int, method: str,
                   output_type: str, batch: int, itemsize: int = 1, head_up: int = 0) -> int:
    """Device bytes a zone run allocates beyond the model: the staged zone
    and its padded copy (``itemsize`` bytes an element), and the planes and
    buffers of the program that ``method`` and ``output_type`` select;
    ``head_up`` > 0: a strided-head model's float32 head logits, (batch,
    S / head_up, S / head_up, K), a batch (a U-Net's tail keeps them on
    chip)."""
    H, W, S, m = grid.height, grid.width, grid.patch_size, grid.margin
    lo, hi_r, hi_c = zone_padding(H, W, S, m)
    Hp, Wp = H + lo + hi_r, W + lo + hi_c
    s = S - 2 * m
    Ho, Wo = max(H, s), max(W, s)
    zone = (H * W + Hp * Wp) * n_channels * itemsize
    if head_up:
        zone += batch * (S // head_up) ** 2 * n_classes * 4
    if output_type == "class_prob":
        return zone + Ho * Wo * n_classes
    if method == "exact-clipping":
        return zone + Ho * Wo * 2
    logits = batch * S * S * n_classes * 4
    planes = Hp * Wp * ((n_classes + 1) * 4 if method != "max" else 5)
    return zone + logits + planes + H * W * 2


def require_zone_dtype(dtype, route: str) -> None:
    """Both zone routes take the rasters of ``ZONE_DTYPES``; others raise
    (ROADMAP slice 2 item 6)."""
    if np.dtype(dtype).newbyteorder("=") not in ZONE_DTYPES:
        raise not_ported(f"{np.dtype(dtype)} zone rasters on {route}", "slice 2")


def torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dtype).newbyteorder("="))).dtype


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """A uint16 tensor as int16 (the same bytes) for zero fills and device
    copies, which PyTorch does not run on uint16 everywhere."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


class PinnedBuffers:
    """Pinned host buffers of one shape and dtype taken in turn, ``depth``
    of each: a zone staged into one is consumed before the buffer comes
    round again (batch mode stages one zone ahead). Off the card, plain
    memory."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.pin = device.type == "cuda"
        self.depth = depth
        self.buffers: dict[tuple, list[torch.Tensor]] = {}
        self.turns: dict[tuple, int] = {}

    def take(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        bufs = self.buffers.setdefault(key, [])
        turn = self.turns.get(key, 0)
        self.turns[key] = turn + 1
        if len(bufs) < self.depth:
            bufs.append(torch.empty(shape, dtype=dtype, pin_memory=self.pin))
        return bufs[turn % self.depth]


def upload_zone(host: torch.Tensor, device: torch.device) -> dict:
    """Start the copy of an (H, W, C) host zone to ``device`` on the current
    stream: {'zone_dev', 'h2d_start', 'h2d_done'}. From pinned memory the
    copy is asynchronous and the two timing events bound it; from pageable
    memory it is done when this returns (events None)."""
    if device.type != "cuda" or not host.is_pinned():
        return {"zone_dev": as_bits(host).to(device).view(host.dtype), "h2d_start": None,
                "h2d_done": None}
    start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    zone_dev = as_bits(host).to(device, non_blocking=True).view(host.dtype)
    done.record()
    return {"zone_dev": zone_dev, "h2d_start": start, "h2d_done": done}


def stage_array(arr: np.ndarray, device: torch.device,
                pad: tuple[int, int, int] | None = None,
                buffers: PinnedBuffers | None = None) -> dict:
    """Keep a (C, H, W) zone read as an (H, W, C) host tensor, ``zone_host``,
    in the raster's dtype, and start its upload to ``device``, unless the
    zone is too large for the device route (``nbytes * 4`` over
    :func:`device_budget_bytes`, as ``flairtpu/zone/engine.py:349-358``):
    such a zone streams, and a device run that takes it after all uploads it
    then (:meth:`DeviceZoneRunner.run`).

    ``pad`` (lo, hi_rows, hi_cols): the run takes the banded route, which
    uploads its slabs itself: the zone is margin-padded here once, into
    ``zone_padded`` = (pad, (Hp, Wp, C) tensor), and not uploaded.

    On the card an uploaded or padded zone sits in pinned host memory,
    taken from ``buffers`` when given, which the staged dict keeps beyond
    the copy."""
    require_zone_dtype(arr.dtype, "the device route")
    C, H, W = arr.shape
    lo, hi_r, hi_c = pad or (0, 0, 0)
    upload = pad is None and arr.nbytes * 4 <= device_budget_bytes()
    shape, dtype = (H + lo + hi_r, W + lo + hi_c, C), torch_dtype(arr.dtype)
    if buffers is not None and (upload or pad is not None):
        host = buffers.take(shape, dtype)
    else:
        host = torch.empty(shape, dtype=dtype,
                           pin_memory=(upload or pad is not None) and device.type == "cuda")
    view = host.numpy()
    if pad is not None:  # zero the margins: a reused buffer holds the last zone
        view[:lo] = view[lo + H:] = 0
        view[lo:lo + H, :lo] = view[lo:lo + H, lo + W:] = 0
    view[lo:lo + H, lo:lo + W] = np.moveaxis(arr, 0, -1)
    if pad is not None:
        return {"zone_host": host[lo:lo + H, lo:lo + W], "zone_padded": (tuple(pad), host)}
    staged = {"zone_host": host}
    if upload:
        staged.update(upload_zone(host, device))
    return staged


def _owned(starts: list[int], s: int) -> list[tuple[int, int]]:
    """One axis of last-write-wins: intervals [a, a + s) written in the order
    of ``starts`` -> for each, the [lo, hi) relative to a that no later
    interval overwrites. The starts must be monotone, as the grid's columns
    ascend and its rows descend: then only the next interval cuts, the later
    ones lie further out."""
    out = []
    for a, nxt in zip(starts, starts[1:] + [None]):
        if nxt is None:
            out.append((0, s))
        elif nxt >= a:  # later intervals lie to the right: keep [a, nxt)
            out.append((0, min(s, nxt - a)))
        else:  # later intervals lie to the left: keep [nxt + s, a + s)
            out.append((min(s, max(0, nxt + s - a)), s))
    return out


def exact_windows(tiles: list[Tile], height: int, width: int, s: int,
                  n_total: int) -> np.ndarray:
    """(n_total, 6) int32 (R0, C0, rlo, rhi, clo, chi) per tile: the s x s
    interior's origin in the (max(H, s), max(W, s)) planes, clamped as the
    reference clamps it for zones smaller than a tile, and the window of the
    interior the tile owns when tiles write in grid order, last write wins.

    The grid enumerates columns as the outer loop and rows as the inner one,
    with the same rows in every column, so pixel (y, x) belongs to the last
    column whose interior holds x and, in it, to the last row whose interior
    holds y: the window is the product of two per-axis intervals. Tiles
    beyond ``len(tiles)`` (duplicates that pad the last batch) and tiles that
    own nothing get an empty window."""
    Ho, Wo = max(height, s), max(width, s)
    col_start = {t.col0: min(t.icol0, Wo - s) for t in tiles}
    row_start = {t.row0: min(t.irow0, Ho - s) for t in tiles}
    cols = dict(zip(col_start, _owned(list(col_start.values()), s)))
    rows = dict(zip(row_start, _owned(list(row_start.values()), s)))
    out = np.zeros((n_total, 6), np.int32)
    for i, t in enumerate(tiles):
        (rlo, rhi), (clo, chi) = rows[t.row0], cols[t.col0]
        out[i, :2] = row_start[t.row0], col_start[t.col0]
        if rlo < rhi and clo < chi:
            out[i, 2:] = rlo, rhi, clo, chi
    return out


_LANE_STREAMS: dict[int, list] = {}


def lane_streams(device: torch.device) -> list:
    """The banded route's three CUDA streams on ``device`` (H2D, compute,
    D2H), made once: the caching allocator keeps freed blocks per stream, so
    a compute stream made anew for each run would allocate its activations
    anew."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _LANE_STREAMS:
        _LANE_STREAMS[index] = [torch.cuda.Stream(device) for _ in range(3)]
    return _LANE_STREAMS[index]


class _Lane:
    """One stage of the banded pipeline: on the card a CUDA stream of its
    own, whose work waits on the events given and is bounded by two timing
    events; on the CPU (``stream`` None) the host, running each stage when
    it is called."""

    def __init__(self, device: torch.device, stream=None):
        self.stream = stream
        if stream is not None:  # after the work already queued (weights, buffers)
            stream.wait_stream(torch.cuda.current_stream(device))
        self.spans: list = []

    def keep(self, *tensors: torch.Tensor) -> None:
        """The caching allocator may reuse these only after this stream's work."""
        if self.stream is not None:
            for t in tensors:
                t.record_stream(self.stream)

    def run(self, waits, fn):
        """fn() on this lane after ``waits`` (events; None is no wait);
        returns the event of its end (None on the CPU)."""
        if self.stream is None:
            t0 = time.perf_counter()
            fn()
            self.spans.append(time.perf_counter() - t0)
            return None
        with torch.cuda.stream(self.stream):
            for ev in waits:
                if ev is not None:
                    self.stream.wait_event(ev)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
        self.spans.append((start, end))
        return end

    def seconds(self) -> float:
        """The sum of the spans, once their work is done."""
        return sum(s if isinstance(s, float) else s[0].elapsed_time(s[1]) / 1e3
                   for s in self.spans)


class DeviceZoneRunner:
    """Runs the zone programs on the model's device. Its per-batch forward
    (``_tail_input`` and the three ``_forward_*``) also serves the streaming
    route (``zone/engine.py:ZoneEngine``)."""

    # the stitch kernels' and the full-tile softmax kernels' wrappers (a
    # subclass may swap in other functions of the same names and arguments)
    stitch_ops = stitch
    tile_ops = tile_softmax

    def __init__(self, config: dict, model, tail: TailParams | StridedTail):
        self.config = config
        self.model = model
        self.tail = tail
        self.size = int(config["img_pixels_detection"])
        self.margin = int(config["margin"])
        self.batch = int(config.get("batch_size", 8))
        self.n_classes = int(config["n_classes"])
        self.output_type = config["output_type"]
        norma = config["norma_task"][0]
        self.norm = dict(norm_type=norma["norm_type"],
                         means=tuple(norma.get("norm_means") or ()),
                         stds=tuple(norma.get("norm_stds") or ()))
        # the tail kernels' wrappers, (argmax, probs, logits) (a subclass may
        # swap in functions of the same arguments)
        self.tail_fns = tail.wrappers()
        self.geometry = tail.geometry(self.size, self.margin)
        self.full_geometry = tail.geometry(self.size, 0)

    @property
    def device(self) -> torch.device:
        return self.tail.device

    def _tail_input(self, zone: torch.Tensor, origins: torch.Tensor, margin: int):
        """One batch, (B, 2) origins in the padded zone -> the tail's input:
        a U-Net's decoded on the interior plan of ``margin``, a strided-head
        model's head logits."""
        x = gather_normalize(zone, origins, self.size, out_dtype=self.model.dtype,
                             **self.norm)
        return self.model.tail_input(x, margin)

    def _forward_tiles(self, zone: torch.Tensor, origins: torch.Tensor,
                       planes: torch.Tensor, windows: torch.Tensor) -> None:
        """One batch: each tile's owned window (``windows`` (B, 6)) of class
        and prob goes into the (2, H, W) planes."""
        self.tail_fns[0](self._tail_input(zone, origins, self.margin), self.tail,
                         self.geometry, planes, windows)

    def _forward_probs(self, zone: torch.Tensor, origins: torch.Tensor,
                       plane: torch.Tensor, windows: torch.Tensor) -> None:
        """One batch: each tile's owned window of round(255 * softmax) goes
        into the (H, W, K) plane."""
        self.tail_fns[1](self._tail_input(zone, origins, self.margin), self.tail,
                         self.geometry, plane, windows)

    def _forward_logits(self, zone: torch.Tensor, origins: torch.Tensor,
                        out: torch.Tensor | None) -> torch.Tensor:
        """One batch -> the whole tiles' float32 logits (B, S, S, K). At
        U = 1 (linknet) the head's logits are already those: they are handed
        through (copied into ``out`` when given), with no tail launch."""
        x = self._tail_input(zone, origins, 0)
        if self.tail.up == 1:
            return x if out is None else out.copy_(x)
        return self.tail_fns[2](x, self.tail, self.full_geometry, out)

    def _run_exact(self, zone: torch.Tensor, origins: torch.Tensor,
                   windows: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
        """exact-clipping: (n_batches, B, 2) origins and (n_batches, B, 6)
        windows on the device -> the (2, H, W) class and prob planes."""
        planes = torch.zeros((2, *out_hw), dtype=torch.uint8, device=zone.device)
        for org, win in zip(origins, windows):
            self._forward_tiles(zone, org, planes, win)
        return planes

    def _run_exact_banded(self, grid: TileGrid, staged: dict,
                          n_bands: int) -> tuple[np.ndarray, dict]:
        """The banded exact-clipping route (``flairtpu/zone/device_engine.py:
        416-510``) -> the (2, Ho, Wo) host planes and the lanes' span sums.

        Band i (:func:`band_plans`, descending rows) copies its slab, the
        padded zone rows its tiles gather from (a row range of the pinned
        padded host zone, no copy on the host), into device slab i % 2 on
        the H2D lane; runs its batches on the compute lane into device
        planes i % 2, through the zone's owned windows
        (:func:`exact_windows`) shifted into band rows, in whole batches
        (the last one padded with duplicates that own nothing, as
        ``flairtpu`` pads, ``:485-486``); and copies the rows
        it owns back on the D2H lane, straight into the pinned host planes.
        A slab or a plane buffer is reused only after the event of its last
        consumer. Owned rows are disjoint and cover the zone, so the raster
        is the unbanded one bit for bit, whatever the band order."""
        B, s = self.batch, self.size - 2 * self.margin
        H, W = grid.height, grid.width
        Ho, Wo = max(H, s), max(W, s)
        pad = zone_padding(H, W, self.size, self.margin)
        bands = band_plans(grid, n_bands, B)
        dev = self.device
        cuda = dev.type == "cuda"
        t0 = time.perf_counter()
        padded = staged.get("zone_padded")
        if padded is None or padded[0] != pad:  # not staged for this route: pad it now
            host = staged["zone_host"]
            zone_p = torch.zeros((H + pad[0] + pad[1], W + pad[0] + pad[2], host.shape[2]),
                                 dtype=host.dtype, pin_memory=cuda)
            zone_p.numpy()[pad[0]:pad[0] + H, pad[0]:pad[0] + W] = host.numpy()
        else:
            zone_p = padded[1]
        slabs = [torch.empty((max(b["rows"][1] for b in bands), *zone_p.shape[1:]),
                             dtype=zone_p.dtype, device=dev) for _ in range(2)]
        planes = [torch.empty((2, max(b["out_h"] for b in bands), Wo), dtype=torch.uint8,
                              device=dev) for _ in range(2)]
        out = torch.zeros((2, Ho, Wo), dtype=torch.uint8, pin_memory=cuda)
        ob = [torch.from_numpy(b["origins"]).to(dev) for b in bands]
        wb = [torch.from_numpy(b["windows"]).to(dev) for b in bands]
        h2d, comp, d2h = (_Lane(dev, st) for st in (lane_streams(dev) if cuda else [None] * 3))
        h2d.keep(*slabs)
        comp.keep(*slabs, *planes, *ob, *wb)
        d2h.keep(*planes)
        setup = time.perf_counter() - t0

        computed, returned = [None, None], [None, None]  # the end events of buffers 0, 1
        for i, (b, org, win) in enumerate(zip(bands, ob, wb)):
            j = i % 2
            slab, plane = slabs[j], planes[j]
            r0, n_rows = b["rows"]
            uploaded = h2d.run([computed[j]], lambda: as_bits(slab[:n_rows]).copy_(
                as_bits(zone_p[r0:r0 + n_rows]), non_blocking=True))

            def compute():
                plane.zero_()
                for k in range(0, len(org), B):
                    self._forward_tiles(slab, org[k:k + B], plane, win[k:k + B])

            computed[j] = comp.run([uploaded, returned[j]], compute)
            lo, hi = b["own"]

            def copy_back():
                for p in range(2):
                    out[p, b["out_lo"] + lo:b["out_lo"] + hi].copy_(plane[p, lo:hi],
                                                                     non_blocking=True)

            returned[j] = d2h.run([computed[j]], copy_back)
        last = returned[(len(bands) - 1) % 2]
        if last is not None:
            last.synchronize()
        wall = time.perf_counter() - t0 - setup
        return out.numpy(), {"h2d_seconds": h2d.seconds(), "compute_seconds": comp.seconds(),
                             "d2h_seconds": d2h.seconds(), "setup_seconds": setup,
                             "wall_seconds": wall, "bands": len(bands)}

    def _run_exact_probs(self, zone: torch.Tensor, origins: torch.Tensor,
                         windows: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
        """class_prob (``device_engine.py:164-192``): the (H, W, K) uint8
        plane of the interiors' round(255 * softmax), exact clipping."""
        plane = torch.zeros((*out_hw, self.n_classes), dtype=torch.uint8, device=zone.device)
        for org, win in zip(origins, windows):
            self._forward_probs(zone, org, plane, win)
        return plane

    def _run_accumulate(self, zone: torch.Tensor, origins: torch.Tensor,
                        valid: torch.Tensor, footprints: list, weighted: bool,
                        padded_hw: tuple[int, int], crop) -> torch.Tensor:
        """average / average_weights (``device_engine.py:194-221``): whole-tile
        softmax times ``w * valid`` accumulated in tile order into padded
        (Hp, Wp, K) and (Hp, Wp) planes -> (2, h, w) class and prob of the
        crop."""
        dev = zone.device
        acc = torch.zeros((*padded_hw, self.n_classes), dtype=torch.float32, device=dev)
        div = torch.zeros(padded_hw, dtype=torch.float32, device=dev)
        w = (torch.from_numpy(patch_weights(self.size).astype(np.float32)).to(dev)
             if weighted else None)
        logits = None  # one buffer for every batch
        for org, val, fp in zip(origins, valid, footprints):
            logits = self._forward_logits(zone, org, logits)
            self.stitch_ops.accumulate_probs(logits, org, val, w, acc, div, fp)
        return self.stitch_ops.stitch_finalize_mean(acc, div, crop)

    def _run_max(self, zone: torch.Tensor, origins: torch.Tensor, valid: torch.Tensor,
                 footprints: list, padded_hw: tuple[int, int], crop) -> torch.Tensor:
        """max (``device_engine.py:512-539``): whole-tile (argmax, max prob)
        merged in tile order where strictly greater -> (2, h, w) class and
        prob of the crop."""
        dev = zone.device
        best_p = torch.zeros(padded_hw, dtype=torch.float32, device=dev)
        best_c = torch.zeros(padded_hw, dtype=torch.uint8, device=dev)
        logits = None
        for org, val, fp in zip(origins, valid, footprints):
            logits = self._forward_logits(zone, org, logits)
            self.stitch_ops.merge_max(logits, org, val, best_p, best_c, fp)
        return self.stitch_ops.stitch_finalize_max(best_p, best_c, crop)

    def run(self, grid: TileGrid, method: str, staged: dict) -> dict:
        """Returns host arrays, {'cls', 'prob'} (H, W) uint8 or, for
        class_prob, {'probs'} (K, H, W) uint8, and timings.

        ``staged`` (from :func:`stage_array`, via
        :func:`flairtpu_torch.zone.engine.stage_zone`) holds the zone already
        read, with its host-to-device copy in flight, or a zone that staging
        kept on the host, which is copied here (h2d_seconds). The banded
        route (:func:`zone_bands`) uploads no whole zone: it takes the
        staged host zone, padded, slab by slab."""
        if method not in ("exact-clipping", "average", "average_weights", "max"):
            raise ValueError(f"unknown stitching method {method!r}")
        H, W = grid.height, grid.width
        n_bands = zone_bands(method, self.output_type, grid.tiles)
        t0 = time.perf_counter()
        with torch.inference_mode():
            if n_bands:
                host, timings = self._run_exact_banded(grid, staged, n_bands)
            else:
                host, timings = self._run_resident(grid, method, staged)
        t_run = time.perf_counter() - t0
        if self.output_type == "class_prob":
            result = {"probs": np.moveaxis(host[:H, :W], -1, 0)}
        else:
            result = {"cls": host[0, :H, :W], "prob": host[1, :H, :W]}
        n = len(grid.tiles)
        return dict(result, tiles=n, seconds=t_run, read_seconds=staged["read_seconds"],
                    patches_per_sec=n / t_run if t_run else 0.0, **timings)

    def _run_resident(self, grid: TileGrid, method: str,
                      staged: dict) -> tuple[np.ndarray, dict]:
        """The zone on the card whole: the program of ``method`` and the
        output type -> the host planes and the h2d / compute / d2h seconds."""
        S, m, B = self.size, self.margin, self.batch
        H, W = grid.height, grid.width
        pad_lo, pad_hi_r, pad_hi_c = zone_padding(H, W, S, m)
        Hp, Wp = H + pad_lo + pad_hi_r, W + pad_lo + pad_hi_c
        tiles = grid.tiles
        n = len(tiles)
        # pad with duplicates of the last tile: their windows are empty, and
        # in the average and max programs their valid is 0
        all_tiles = tiles + [tiles[-1]] * ((-n) % B)
        origins = np.array(
            [(t.row0 + pad_lo, t.col0 + pad_lo) for t in all_tiles], np.int32)
        valid = np.array([1.0] * n + [0.0] * (len(all_tiles) - n), np.float32)
        s = S - 2 * m
        Ho, Wo = max(H, s), max(W, s)
        # class_prob forces exact clipping for every method, as the reference
        # does (compare.py:68); it is checked first
        exact = self.output_type == "class_prob" or method == "exact-clipping"
        if exact:
            windows = exact_windows(tiles, H, W, s, len(all_tiles))
        else:
            fps = [stitch.footprint(o, v, S) for o, v in
                   zip(origins.reshape(-1, B, 2), valid.reshape(-1, B))]

        timings: dict[str, float] = {}
        t0 = time.perf_counter()
        if "zone_dev" not in staged:  # a zone staged for streaming: upload it now
            staged = dict(staged, **upload_zone(staged["zone_host"], self.device))
        zone = staged["zone_dev"]
        if staged["h2d_done"] is not None:
            # the copy may run on another stream (batch mode's prefetch): this
            # stream waits for it, and the allocator keeps the zone for it
            stream = torch.cuda.current_stream(zone.device)
            stream.wait_event(staged["h2d_done"])
            zone.record_stream(stream)
            staged["h2d_done"].synchronize()  # the host's residual wait on the copy
        timings["h2d_seconds"] = time.perf_counter() - t0

        tc = time.perf_counter()
        zone_p = torch.zeros((Hp, Wp, zone.shape[2]), dtype=as_bits(zone).dtype,
                             device=zone.device)
        zone_p[pad_lo:pad_lo + H, pad_lo:pad_lo + W] = as_bits(zone)
        zone_p = zone_p.view(zone.dtype)
        ob = torch.from_numpy(origins.reshape(-1, B, 2)).to(zone.device)
        if exact:
            wb = torch.from_numpy(windows.reshape(-1, B, 6)).to(zone.device)
            if self.output_type == "class_prob":
                out = self._run_exact_probs(zone_p, ob, wb, (Ho, Wo))
            else:
                out = self._run_exact(zone_p, ob, wb, (Ho, Wo))
        else:
            vb = torch.from_numpy(valid.reshape(-1, B)).to(zone.device)
            crop = (pad_lo, pad_lo, H, W)
            if method == "max":
                out = self._run_max(zone_p, ob, vb, fps, (Hp, Wp), crop)
            else:
                out = self._run_accumulate(zone_p, ob, vb, fps, method == "average_weights",
                                           (Hp, Wp), crop)
        if zone.device.type == "cuda":
            torch.cuda.synchronize(zone.device)
        timings["compute_seconds"] = time.perf_counter() - tc
        td = time.perf_counter()
        host = out.cpu().numpy()  # one device-to-host copy of the result
        timings["d2h_seconds"] = time.perf_counter() - td
        return host, timings
