"""Patch predict stage (counterpart of ``flairtpu/predict/runner.py:41-99``;
reference flair/main.py:187-203, tasks.py:113-142).

Each batch of test patches goes to the device once; ``augment_normalize``
normalizes it (every choice the identity); the model's zone tail runs at
margin 0 into (B, S, S) class tiles (``full_windows``), its argmax taken
from the whole tile as ``flairtpu``'s predict takes it from the full
logits (``flairtpu/predict/runner.py:50``): for the U-Net, MAnet and UNet++
the encoder and the decoder through the node before the last run with
their running statistics through ``conv_epilogue`` and ``fused_tail`` (the
port of the Pallas tail, ``ops/fused_tail.py``) runs the last block, the
head and the argmax; for the other archs the decoder and head run on whole
tiles and ``strided_tail`` (``ops/strided_tail.py``) upsamples the head's
logits (U = 4, 8, or 1 for linknet) and takes the argmax. Only the uint8 classes come back, into
pinned memory; PRED files are written on a thread pool while the next batch
computes. The ragged last batch is padded with copies of its last patch (and
of its last metadata row, for a metadata model), so every batch has one
shape.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from flairtpu_torch.data.patches import PatchDataset, PatchLoader
from flairtpu_torch.io import TiffReader, TiffWriter
from flairtpu_torch.ops.augment import augment_normalize


def write_prediction(pred: np.ndarray, src_path: str, out_dir: Path,
                     georeferencing: bool = True) -> Path:
    """Write one PRED_<name>.tif (reference writer.py:32-50 layout)."""
    name = src_path.split("/")[-1]
    out_file = out_dir / f"PRED_{name}"
    if georeferencing:
        with TiffReader(src_path) as src:
            profile = src.profile
        profile.update(count=1, compress="lzw", dtype="uint8")
        with TiffWriter.from_profile(out_file, profile) as w:
            w.write_band(1, pred.astype(np.uint8))
    else:
        with TiffWriter(out_file, pred.shape[1], pred.shape[0], 1, "uint8",
                        compress="lzw", tiled=False) as w:
            w.write_band(1, pred.astype(np.uint8))
    return out_file


def predict(config: dict, dict_test: dict, out_dir: str | Path, trainer,
            batch_size: int | None = None, progress=print) -> dict:
    """Writes PRED_*.tif for every test patch; returns {'dir', 'patches',
    'seconds'}."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    bs = batch_size or int(config.get("batch_size", 4))
    device, dtype, model = trainer.device, trainer.dtype, trainer.model
    on_card = device.type == "cuda"
    ds = PatchDataset(dict_test, config["channels"], use_metadata=trainer.use_metadata,
                      with_masks=False)
    loader = PatchLoader(ds, bs, shuffle=False, drop_last=False,
                         num_workers=int(config.get("num_workers", 4)), pin=on_card)
    geo = bool(config.get("georeferencing_output", True))
    tail = None
    t0 = time.perf_counter()
    n_done = 0
    with torch.inference_mode(), ThreadPoolExecutor(max_workers=4) as pool:
        futures = []
        pending = None  # (host classes, event, n, ids): fetched after the next batch is queued

        def flush(p):
            nonlocal n_done
            host, event, n, ids = p
            if event is not None:
                event.synchronize()
            preds = host.numpy()[:n]
            for pred, src in zip(preds, ids):
                futures.append(pool.submit(write_prediction, pred, src, out_dir, geo))
            n_done += n

        for batch in loader:
            img, mtd = batch["img"], batch.get("mtd")
            n, size = img.shape[0], img.shape[1]
            if n < bs:
                img = torch.cat([img, img[-1:].expand(bs - n, *img.shape[1:])])
                if mtd is not None:
                    mtd = torch.cat([mtd, mtd[-1:].expand(bs - n, *mtd.shape[1:])])
            if tail is None:
                tail = model.zone_tail()
                argmax = tail.wrappers()[0]
                geometry = tail.geometry(size, 0)
            x, _ = augment_normalize(img.to(device, non_blocking=True), None, None,
                                     trainer.norm_mean, trainer.norm_mul, trainer.num_classes,
                                     dtype)
            if mtd is not None:
                mtd = mtd.to(device, non_blocking=True)
            cls, _ = argmax(model.tail_input(x, 0, mtd=mtd), tail, geometry)
            host = torch.empty(cls.shape, dtype=torch.uint8, pin_memory=on_card)
            host.copy_(cls, non_blocking=on_card)
            event = None
            if on_card:
                event = torch.cuda.Event()
                event.record()
            if pending is not None:
                flush(pending)
            pending = (host, event, n, batch["id"])
        if pending is not None:
            flush(pending)
        for f in futures:
            f.result()
    seconds = time.perf_counter() - t0
    progress(f"    [x] wrote {n_done} predictions to {out_dir}")
    return {"dir": out_dir, "patches": n_done, "seconds": seconds}
