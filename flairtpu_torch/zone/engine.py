"""flair-detect pipeline (counterpart of ``flairtpu/zone/engine.py:47-506``):
model preparation, output paths, zone staging, one pass over the zone on
one of two routes, and the GeoTIFF write, or with ``compare`` the sweep of
``zone/compare.py``.

- The device route (``zone/device_engine.py``) holds the zone and the
  stitch planes on the card.
- The streaming route (:class:`ZoneEngine`) is for zones whose buffers do
  not fit the device budget, or any zone when ``FLAIRTPU_STREAMING_ZONE`` is
  set: host threads read the tiles, the card runs each batch's forward and
  softmax payload, and the host stitchers (``zone/stitch.py``) build the
  raster.

``use_gpu: true`` (the default) runs on the CUDA card and raises if there is
none; ``use_gpu: false`` runs on the CPU, where the kernels' plain PyTorch
versions run. There is no other route to the CPU.
"""

from __future__ import annotations

import datetime
import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from flairtpu_torch.io import TiffReader, TiffWriter, Window
from flairtpu_torch.models.convert import load_weights
from flairtpu_torch.models.factory import create_model
from flairtpu_torch.models.fold import fold_model
from flairtpu_torch.models.quantize import (check_quantizable, quantize_model,
                                            read_calibration_batches)
from flairtpu_torch.ops.fused_tail import full_windows
from flairtpu_torch.utils.logger import tee_stdout, untee_stdout
from flairtpu_torch.zone.device_engine import (DeviceZoneRunner, PinnedBuffers, as_bits,
                                               device_budget_bytes, estimate_bytes,
                                               require_zone_dtype, stage_array, torch_dtype,
                                               zone_bands, zone_padding)
from flairtpu_torch.zone.grid import TileGrid, get_stride, slice_grid
from flairtpu_torch.zone.stitch import make_stitcher

QUEUE_DEPTH = 4  # batches read ahead of the card (flairtpu/zone/engine.py:196)
# where the streaming route's seconds go on the host: pinned payload
# buffers, waits on the reader, the launches, waits on the card and on the
# device-to-host copies, the stitcher; then the card's own spans of each
# batch's upload, forward and copy back (CUDA events; on the CPU the forward
# runs inside ``dispatch``)
STREAM_TIMERS = ("setup", "reader_wait", "dispatch", "card_wait", "d2h_wait", "stitch",
                 "device_h2d", "device_compute", "device_d2h")


def resolve_device(config: dict) -> torch.device:
    """``use_gpu`` true -> the CUDA card (raises without one); false -> CPU."""
    if not config.get("use_gpu", True):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "use_gpu is true but CUDA is not available; set use_gpu: false to "
            "run flair-detect on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def compute_dtype(device: torch.device) -> torch.dtype:
    """bfloat16 convolutions on the card, float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


# ---------------------------------------------------------------------------
# model preparation (reference zone_detect/model.py:61-88 + main.py:186-203)
# ---------------------------------------------------------------------------

def prepare_model(config: dict, device: torch.device):
    """Build the model, load its weights strictly, move it to ``device``,
    prepare it for inference (conv weights in the compute dtype, BatchNorm
    (scale, shift) pairs) and derive its tail (``models/factory.py:
    FlairSegmentationModel.zone_tail``): the fused tail's parameters for the
    archs that end in the U-Net's last block (unet, manet, unetplusplus), or
    the strided-head smp models' ``StridedTail`` (deeplabv3plus, deeplabv3,
    fpn, pspnet, pan, linknet; ``flairtpu/zone/engine.py:51-53``). Returns
    (model, tail).

    The knobs (``flairtpu/zone/engine.py:60-77``): ``quantize: int8`` folds,
    calibrates on 16 tiles of the zone and quantizes (``models/quantize.py``;
    with ``bn_fold`` too, its float sites run in the compute dtype, as they
    do without it, see there); ``bn_fold`` alone folds BatchNorm into the
    conv weights (``models/fold.py``). Either model has the runners'
    ``dtype`` / ``tail_input`` surface."""
    dtype = compute_dtype(device)
    model = create_model(config, dtype=dtype)
    load_weights(model, config["model_weights"])
    print("    [x] loaded model and weights...")
    model = model.to(device, memory_format=torch.channels_last).eval()
    if config.get("quantize"):
        check_quantizable(model)  # before the zone's calibration tiles are read
        zone_model = quantize_model(config, model, read_calibration_batches(config))
        print("    [x] int8-quantized encoder (w8a8, calibrated on the zone)...")
        return zone_model, zone_model.tail
    if config.get("bn_fold"):
        zone_model = fold_model(model)
        print("    [x] folded BatchNorm into the conv weights (pure "
              f"{str(dtype).removeprefix('torch.')} walk)...")
        return zone_model, zone_model.tail
    model.prepare_inference()
    return model, model.zone_tail()


# ---------------------------------------------------------------------------
# the streaming route (counterpart of flairtpu/zone/engine.py:85-238)
# ---------------------------------------------------------------------------

def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """q.put that gives up once ``stop`` is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            pass
    return False


def _get(q: queue.Queue, stop: threading.Event):
    """q.get that gives up (None) once ``stop`` is set."""
    while not stop.is_set():
        try:
            return q.get(timeout=0.05)
        except queue.Empty:
            pass
    return None


class ZoneEngine:
    """Streams a zone through the card batch by batch.

    Reader threads decode each tile's window (boundless) into a batch buffer;
    the card gathers and normalizes the batch and runs the per-batch forward
    of ``runner``, a :class:`DeviceZoneRunner` (so a subclass that swaps in
    the plain versions swaps them here too), to the payload the stitcher
    needs; the payload comes back to the host, where the stitcher of
    ``zone/stitch.py`` takes it tile by tile.

    On the card, batches go up from pinned buffers (the producer refills one
    only after its upload's event), payloads come back into two pinned
    buffers in turn, and batch n is stitched only after batch n + 1 is
    enqueued, so the host's stitching overlaps the card's next batch."""

    def __init__(self, config: dict, runner: DeviceZoneRunner):
        self.config = config
        self.runner = runner
        self.device = runner.device
        self.size, self.margin, self.batch_size = runner.size, runner.margin, runner.batch
        self.channels = config["channels"]

    def device_fn(self, kind: str):
        """(fn, split, parts) for a payload kind: fn maps one uploaded batch,
        a (B S, S, C) tensor of the zone's dtype on the device (tile i at rows
        [i S, (i + 1) S)), to a tuple of payload tensors, whose (shape, dtype)
        are ``parts``; split maps their host copies and a tile index to that
        tile's payload, as the stitchers take it."""
        r, S, B, K = self.runner, self.size, self.batch_size, self.runner.n_classes
        s, dev = S - 2 * self.margin, self.device
        origins = torch.zeros((B, 2), dtype=torch.int32)
        origins[:, 0] = torch.arange(B, dtype=torch.int32) * S
        origins = origins.to(dev)
        if kind == "cropped_argmax":  # (cls, prob) uint8 (s, s) a tile
            windows, parts = full_windows(B, s, dev), [((2, B * s, s), torch.uint8)]

            def fn(batch):
                planes = torch.empty(parts[0][0], dtype=torch.uint8, device=dev)
                r._forward_tiles(batch, origins, planes, windows)
                return (planes,)

            def split(host, i):
                return host[0][0, i * s:(i + 1) * s], host[0][1, i * s:(i + 1) * s]
        elif kind == "cropped_probs":  # round(255 * softmax) uint8 (K, s, s) a tile
            windows, parts = full_windows(B, s, dev), [((B * s, s, K), torch.uint8)]

            def fn(batch):
                plane = torch.empty(parts[0][0], dtype=torch.uint8, device=dev)
                r._forward_probs(batch, origins, plane, windows)
                return (plane,)

            def split(host, i):
                return np.moveaxis(host[0][i * s:(i + 1) * s], -1, 0)
        elif kind == "full_probs":  # softmax float32 (K, S, S) a tile
            def fn(batch):
                return (r.tile_ops.tile_probs(r._forward_logits(batch, origins, None)),)

            def split(host, i):
                return host[0][i]

            parts = [((B, K, S, S), torch.float32)]
        elif kind == "full_argmax":  # (cls uint8, prob float32) (S, S) a tile
            def fn(batch):
                return r.tile_ops.tile_argmax(r._forward_logits(batch, origins, None))

            def split(host, i):
                return host[0][i], host[1][i]

            parts = [((B, S, S), torch.uint8), ((B, S, S), torch.float32)]
        else:
            raise ValueError(kind)
        return fn, split, parts

    def _read_batches(self, reader: TiffReader, grid: TileGrid, out_q: queue.Queue,
                      free: queue.Queue, stop: threading.Event, num_workers: int,
                      pinned: bool, dtype: torch.dtype) -> None:
        """Producer: decode tile windows into batch buffers of the zone's
        dtype; the last batch is padded with duplicates of its last tile. A
        buffer comes back on ``free`` with the event of its upload; a new one
        (pinned for the card) is made only while none is free, up to one for
        each batch the queue holds, one going up and one being read. Ends
        with None on
        ``out_q``, or the exception that stopped it."""
        S, B, C = self.size, self.batch_size, len(self.channels)
        made = 0

        def read_tile(job):
            t, dst = job
            try:
                arr = reader.read(self.channels, window=Window(t.col0, t.row0, S, S),
                                  boundless=True)
                dst[...] = np.moveaxis(arr, 0, -1)
            except Exception as error:
                # a zero tile on a decode error, like the reference's
                # CPLE_BaseError handler (src/zone_detect/dataset.py:115-122)
                print(f"read error on tile {t.index}: {error}")
                dst[...] = 0

        try:
            tiles = grid.tiles
            with ThreadPoolExecutor(max_workers=num_workers) as ex:
                for i in range(0, len(tiles), B):
                    try:
                        item = free.get_nowait()
                    except queue.Empty:
                        if made < QUEUE_DEPTH + 2:
                            made += 1
                            item = (torch.empty((B, S, S, C), dtype=dtype,
                                                pin_memory=pinned), None)
                        else:
                            item = _get(free, stop)
                    if item is None:
                        return
                    buf, uploaded = item
                    if uploaded is not None:  # the buffer's last upload must be done
                        uploaded.synchronize()
                    host, chunk = buf.numpy(), tiles[i:i + B]
                    list(ex.map(read_tile, zip(chunk, host)))
                    host[len(chunk):] = host[len(chunk) - 1]
                    if not _put(out_q, (chunk, buf), stop):
                        return
            _put(out_q, None, stop)
        except BaseException as error:  # the consumer raises it too
            _put(out_q, error, stop)
            raise

    def run(self, reader: TiffReader, grid: TileGrid, stitcher) -> dict:
        """Stream the zone of ``reader`` over ``grid`` into ``stitcher`` and
        finalize it. Returns the reference's stats (tiles, seconds,
        patches_per_sec, cumulative patch_times_ms) and where the seconds
        went (``STREAM_TIMERS``, each ``<name>_seconds``), with ``d2h_bytes``."""
        require_zone_dtype(reader.dtype, "the streaming route")
        dtype = torch_dtype(reader.dtype)
        fn, split, parts = self.device_fn(stitcher.needs)
        S, B, C = self.size, self.batch_size, len(self.channels)
        cuda = self.device.type == "cuda"
        num_workers = max(int(self.config.get("num_worker", 2)), 1)
        t = dict.fromkeys(STREAM_TIMERS, 0.0)
        t0 = time.perf_counter()
        free: queue.Queue = queue.Queue()  # batch buffers back from the card
        q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        stop = threading.Event()
        producer = threading.Thread(
            target=self._read_batches,
            args=(reader, grid, q, free, stop, num_workers, cuda, dtype),
            daemon=True)
        producer.start()
        if cuda:  # the upload target and two pinned payload buffers, used in turn
            batch_dev = torch.empty((B * S, S, C), dtype=dtype, device=self.device)
            slots = [tuple(torch.empty(shape, dtype=dtype, pin_memory=True)
                           for shape, dtype in parts) for _ in range(2)]
        t["setup"] = time.perf_counter() - t0
        n_tiles, n_batches, d2h_bytes = 0, 0, 0
        patch_times_ms: list[float] = []
        pending = None  # (tiles, host payload, events): stitched after the next enqueue
        try:
            with torch.inference_mode():
                while True:
                    tw = time.perf_counter()
                    item = q.get()
                    t["reader_wait"] += time.perf_counter() - tw
                    if isinstance(item, BaseException):
                        raise item
                    if item is None:
                        break
                    tiles, buf = item
                    td = time.perf_counter()
                    if cuda:
                        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                        ev[0].record()
                        as_bits(batch_dev).copy_(as_bits(buf).view(B * S, S, C),
                                                 non_blocking=True)
                        ev[1].record()
                        free.put((buf, ev[1]))
                        result = fn(batch_dev)
                        ev[2].record()
                        slot = slots[n_batches % 2]
                        for dst, src in zip(slot, result):
                            dst.copy_(src, non_blocking=True)
                        ev[3].record()
                        host = tuple(h.numpy() for h in slot)
                    else:
                        result = fn(buf.view(B * S, S, C))
                        free.put((buf, None))
                        ev, host = None, tuple(r.numpy() for r in result)
                    n_batches += 1
                    d2h_bytes += sum(r.numel() * r.element_size() for r in result)
                    t["dispatch"] += time.perf_counter() - td
                    if pending is not None:
                        n_tiles += self._drain(pending, stitcher, split, patch_times_ms, t, t0)
                    pending = (tiles, host, ev)
                if pending is not None:
                    n_tiles += self._drain(pending, stitcher, split, patch_times_ms, t, t0)
            ts = time.perf_counter()
            stitcher.finalize()
            t["stitch"] += time.perf_counter() - ts
        finally:
            stop.set()
            producer.join()
        seconds = time.perf_counter() - t0
        return {"tiles": n_tiles, "seconds": seconds,
                "patches_per_sec": n_tiles / seconds if seconds else 0.0,
                "patch_times_ms": patch_times_ms,
                **{f"{k}_seconds": v for k, v in t.items()}, "d2h_bytes": d2h_bytes}

    @staticmethod
    def _drain(pending, stitcher, split, patch_times_ms: list, t: dict, t0: float) -> int:
        """Wait for a batch's payload on the host and stitch its real tiles."""
        tiles, host, ev = pending
        if ev is not None:
            tw = time.perf_counter()
            ev[2].synchronize()
            t["card_wait"] += time.perf_counter() - tw
            tw = time.perf_counter()
            ev[3].synchronize()
            t["d2h_wait"] += time.perf_counter() - tw
            for name, a, b in (("device_h2d", 0, 1), ("device_compute", 1, 2),
                               ("device_d2h", 2, 3)):
                t[name] += ev[a].elapsed_time(ev[b]) / 1e3
        ts = time.perf_counter()
        now_ms = (ts - t0) * 1000.0
        for i, tile in enumerate(tiles):
            stitcher.add(tile, split(host, i))
            patch_times_ms.append(now_ms)
        t["stitch"] += time.perf_counter() - ts
        return len(tiles)


# ---------------------------------------------------------------------------
# pipeline orchestration (reference main.py:244-436)
# ---------------------------------------------------------------------------

def setup_out_path(config: dict) -> dict:
    """The run's output directory: ``output_path``, or under ``compare`` a
    timestamped directory inside it."""
    out = Path(config["output_path"])
    out.mkdir(parents=True, exist_ok=True)
    if config.get("compare"):
        out = out / datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        out.mkdir(parents=True, exist_ok=True)
        print(f"Creating output directory: {out}")
    config["local_out"] = str(out)
    return config


def setup_indiv_path(config: dict, identifier: str = "") -> str:
    """Collision-avoiding output path (reference utils.py:256-279)."""
    out_name = config["output_name"] + identifier
    if not out_name.endswith(".tif"):
        out_name += ".tif"
    path = Path(config["local_out"]) / out_name
    stem, ext = path.stem, path.suffix
    counter = 1
    while path.exists():
        path = path.with_name(f"{stem}_{counter}{ext}")
        counter += 1
    return str(path)


def describe_device(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)}) x{torch.cuda.device_count()}"
    return "cpu"


def conf_log(config: dict, reader: TiffReader, device: torch.device) -> None:
    mf = config["model_framework"]
    provider = mf["model_provider"]
    tpl = mf.get(provider, {})
    model_template = f"{provider} - " + str(
        tpl.get("org_model") or tpl.get("encoder_decoder") or "?")
    print(f"""
    |- output path: {config['output_path']}
    |- output raster name: {config['output_name']}

    |- input image path: {config['input_img_path']}
    |- channels: {config['channels']}
    |- input image WxH: {reader.width, reader.height}
    |- resolution: {reader.res}
    |- number of classes: {config['n_classes']}
    |- normalization: {config['norma_task'][0]['norm_type']}
    |- output type: {config['output_type']}

    |- model weights path: {config.get('model_weights', '<in-memory>')}
    |- model template: {model_template}
    |- device: {describe_device(device)}
    |- batch size: {config['batch_size']}
    """)


def _make_writer(config: dict, reader: TiffReader, path_out: str) -> TiffWriter:
    n_bands = 2 if config["output_type"] == "argmax" else int(config["n_classes"])
    return TiffWriter(
        path_out, reader.width, reader.height, n_bands, "uint8",
        transform=reader.transform, crs=reader.crs,
        compress="lzw", tiled=True,
        blockxsize=config["img_pixels_detection"],
        blockysize=config["img_pixels_detection"],
        bigtiff="auto",
        # optional COG-style overview pyramid (nearest; class rasters must
        # not blend labels), e.g. output_overviews: [2, 4, 8]
        overviews=config.get("output_overviews"))


def banded_padding(config: dict, height: int, width: int) -> tuple[int, int, int] | None:
    """The zone's margin padding when flair-detect's run over it takes the
    banded route, which stages the zone padded and uploads no whole zone;
    None otherwise, and under ``compare``, whose runs share one upload."""
    if config.get("compare"):
        return None
    size, margin = config["img_pixels_detection"], config["margin"]
    grid = slice_grid(width, height, size, margin, get_stride(config)[0])
    if not zone_bands("exact-clipping", config["output_type"], grid.tiles):
        return None
    return zone_padding(height, width, size, margin)


def stage_zone(config: dict, device: torch.device, img_path: str | None = None,
               buffers: PinnedBuffers | None = None) -> dict:
    """Read the zone at ``img_path`` (by default the config's) and start its
    host-to-device copy on the current stream without waiting; a zone too
    large for the device route stays on the host, and one for the banded
    route stays there padded (``device_engine.py:stage_array``, into
    ``buffers`` when given). The staged dict names its ``path``
    (``flairtpu/zone/engine.py:328-358``)."""
    path = str(img_path or config["input_img_path"])
    t0 = time.perf_counter()
    with TiffReader(path, cache_blocks=128) as r:
        arr = r.read(config["channels"])
    staged = stage_array(arr, device, banded_padding(config, *arr.shape[1:]), buffers)
    staged.update(path=path, read_seconds=time.perf_counter() - t0)
    return staged


def _run_device(config: dict, model, tail, device: torch.device, grid: TileGrid,
                method: str, reader: TiffReader, path_out: str, staged: dict | None) -> dict:
    """The device route: one device-resident or banded pass, then the raster
    write."""
    res = DeviceZoneRunner(config, model, tail).run(grid, method,
                                                    staged or stage_zone(config, device))
    tw = time.perf_counter()
    writer = _make_writer(config, reader, path_out)
    if "probs" in res:
        writer.write_band(list(range(1, config["n_classes"] + 1)), res["probs"])
    else:
        writer.write_band([1, 2], np.stack([res["cls"], res["prob"]]))
    writer.close()
    stats = {k: v for k, v in res.items() if k not in ("cls", "prob", "probs")}
    stats["write_seconds"] = time.perf_counter() - tw
    # cumulative elapsed time per patch, the reference's timing shape
    # (flairtpu/zone/engine.py:432-437)
    total_ms, n = res["seconds"] * 1000.0, max(res["tiles"], 1)
    stats["patch_times_ms"] = [total_ms * (i + 1) / n for i in range(n)]
    return stats


def run_single(config: dict, model, tail, device: torch.device, stride: int,
               method: str, identifier: str = "",
               staged: dict | None = None) -> tuple[str, dict, TileGrid]:
    """One (grid, stitch, output raster) pass over the zone.

    The device route runs when ``FLAIRTPU_STREAMING_ZONE`` is unset and the
    zone's :func:`estimate_bytes` fits :func:`device_budget_bytes`; otherwise
    the zone streams through :class:`ZoneEngine` into the host stitchers.
    ``staged`` (from :func:`stage_zone`) is a zone already read and on its
    way to the device, which the compare sweep shares across its runs and
    batch mode stages ahead; one of another path is not used, and by
    default the device route reads the zone here."""
    if staged is not None and staged.get("path") != str(config["input_img_path"]):
        staged = None
    size, margin = config["img_pixels_detection"], config["margin"]
    with TiffReader(config["input_img_path"], cache_blocks=128) as reader:
        grid = slice_grid(reader.width, reader.height, size, margin, stride,
                          reader.transform, reader.crs)
        if config.get("write_dataframe"):
            gj = Path(config["local_out"]) / (
                str(config["output_name"]).split(".tif")[0] + "_slicing_job.geojson")
            gj.write_text(json.dumps(grid.to_geojson()))
        conf_log(config, reader, device)
        print(f"    [x] sliced input raster to {len(grid)} squares...")
        path_out = setup_indiv_path(config, identifier)

        need = estimate_bytes(grid, len(config["channels"]), int(config["n_classes"]),
                              method, config["output_type"], int(config["batch_size"]),
                              reader.dtype.itemsize, tail.up)
        use_device = (not os.environ.get("FLAIRTPU_STREAMING_ZONE")
                      and need <= device_budget_bytes())
        print(f"    [x] zone path: {'device-resident' if use_device else 'streaming'}")
        print("    [ ] starting inference...\n")
        if use_device:
            stats = _run_device(config, model, tail, device, grid, method, reader, path_out,
                                staged)
        else:
            engine = ZoneEngine(config, DeviceZoneRunner(config, model, tail))
            writer = _make_writer(config, reader, path_out)
            stats = engine.run(reader, grid, make_stitcher(method, writer, grid, config))
            writer.close()
            print("    [x] streaming: " + ", ".join(
                f"{k} {stats[f'{k}_seconds']:.4f} s" for k in STREAM_TIMERS))
    print(f"    [X] done writing to {Path(path_out).name} raster file "
          f"({stats['tiles']} tiles, {stats['patches_per_sec']:.1f} patches/s).\n")
    return path_out, stats, grid


def run_pipeline(config: dict, prepared: tuple | None = None,
                 staged: dict | None = None) -> dict:
    """flair-detect entry (reference main.py:244-436); returns the run's
    stats, or with ``compare`` the sweep's stats by method string.

    ``prepared``: an already prepared (model, tail), which then serves every
    zone of a department (``flairtpu/zone/engine.py:470-492``); ``staged``:
    the zone already staged by :func:`stage_zone`."""
    device = resolve_device(config)
    config = setup_out_path(config)
    log_file = Path(config["local_out"]) / (
        f"{config['output_name']}_"
        f"{datetime.datetime.now().strftime('%Y%m%d_%H%M%S')}.log")
    tee_stdout(str(log_file), capture_stderr=True)
    print(f"    [LOGGER] Writing logs to: {log_file}")
    try:
        print(f"""
    ##############################################
    ZONE DETECTION
    ##############################################

    PyTorch device: {describe_device(device)}""")
        model, tail = prepared or prepare_model(config, device)
        # the int8 model's calibration, once per model (set-up, not the pass)
        calib = {"calibration_seconds": model.calibration_seconds} if hasattr(
            model, "calibration_seconds") else {}
        if config.get("compare"):
            from flairtpu_torch.zone.compare import run_compare

            return {k: dict(v, **calib) for k, v in
                    run_compare(config, model, tail, device).items()}
        _, stats, _ = run_single(config, model, tail, device, get_stride(config)[0],
                                 "exact-clipping", staged=staged)
        return dict(stats, **calib)
    finally:
        untee_stdout()
