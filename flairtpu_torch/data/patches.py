"""Patch dataset and threaded prefetching loader (counterpart of
``flairtpu/data/patches.py`` and the ``threads`` backend of
``flairtpu/data/grain_loader.py:93-99``).

As ``flairtpu``'s: images ship as raw NHWC, normalization and augmentation
run on the device (``ops/augment.py``), decode threads read the TIFFs, and
the seeded epoch shuffle (``np.random.default_rng(seed + epoch)``) is the
same, so both packages see the same batches in the same order. Two
differences: the mask stays the uint8 read from disk (labels from 1; the
device pass subtracts the 1 and cleans the labels, so a quarter of the bytes
cross the bus; values above 255 clip to 255, which the cleaning maps to 0 as
it maps any label past the class count), and a loader for a CUDA device
collates each batch straight into pinned host memory, from which the copy to
the card is asynchronous.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from flairtpu_torch.io import TiffReader


class PatchDataset:
    """Random-access reader over a manifest dict {'IMG', 'MSK', 'MTD'}."""

    def __init__(self, files: dict, channels=(1, 2, 3, 4, 5), use_metadata: bool = False,
                 with_masks: bool = True):
        self.images = list(files["IMG"])
        self.masks = list(files.get("MSK", []))
        self.metadata = list(files.get("MTD", []))
        self.channels = list(channels)
        self.use_metadata = use_metadata
        self.with_masks = with_masks and any(self.masks)

    def __len__(self) -> int:
        return len(self.images)

    def read(self, idx: int) -> dict:
        out: dict = {"id": self.images[idx]}
        with TiffReader(self.images[idx], cache_blocks=4) as r:
            img = r.read(self.channels)  # (C, H, W), native dtype
        out["img"] = np.ascontiguousarray(np.moveaxis(img, 0, -1))  # NHWC
        if self.with_masks:
            with TiffReader(self.masks[idx], cache_blocks=4) as r:
                msk = r.read(1)
            if msk.dtype != np.uint8:
                msk = np.clip(msk, 0, 255).astype(np.uint8)
            out["msk"] = msk
        if self.use_metadata:
            out["mtd"] = np.asarray(self.metadata[idx], np.float32)
        return out


class PatchLoader:
    """Batched iterator with threaded decode and bounded prefetch.

    Yields dicts: ``img`` (B, H, W, C) and ``msk`` (B, H, W) uint8 and, for a
    dataset with ``use_metadata``, ``mtd`` (B, 45) float32, as torch tensors
    (pinned when ``pin`` is set), and ``id`` (list of paths). Each
    ``__iter__`` advances the epoch for shuffling."""

    def __init__(self, dataset: PatchDataset, batch_size: int, shuffle: bool = False,
                 seed: int = 2022, drop_last: bool = False, num_workers: int = 4,
                 prefetch: int = 4, pin: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.pin = pin
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self, epoch: int | None = None) -> list[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            e = self._epoch if epoch is None else epoch
            rng = np.random.default_rng(self.seed + e)
            rng.shuffle(idx)
        batches = []
        for i in range(0, len(idx), self.batch_size):
            b = idx[i:i + self.batch_size]
            if self.drop_last and len(b) < self.batch_size:
                break
            batches.append(b)
        return batches

    def _stack(self, arrays: list[np.ndarray]) -> torch.Tensor:
        out = torch.empty((len(arrays), *arrays[0].shape),
                          dtype=torch.from_numpy(arrays[0][:0]).dtype, pin_memory=self.pin)
        np.stack(arrays, out=out.numpy())
        return out

    def _collate(self, items: list[dict]) -> dict:
        batch = {"img": self._stack([it["img"] for it in items]),
                 "id": [it["id"] for it in items]}
        if "msk" in items[0]:
            batch["msk"] = self._stack([it["msk"] for it in items])
        if "mtd" in items[0]:
            batch["mtd"] = self._stack([it["mtd"] for it in items])
        return batch

    def __iter__(self):
        batches = self._index_batches()
        self._epoch += 1
        return self._iter_prefetched(batches)

    def epoch_iter(self, epoch: int, start_batch: int = 0):
        """Deterministic iterator for ``epoch`` (seed + epoch shuffle)
        skipping the first ``start_batch`` batches (mid-epoch resume). Does
        not advance the loader's own epoch counter."""
        return self._iter_prefetched(self._index_batches(epoch)[start_batch:])

    def _iter_prefetched(self, batches: list):
        if not batches:
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    for b in batches:
                        if stop.is_set():
                            break
                        q.put(self._collate(list(ex.map(self.dataset.read, b))))
            except BaseException as e:  # handed to the consumer, which raises it
                q.put(e)
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)


def make_loader(backend: str, dataset: PatchDataset, **kwargs) -> PatchLoader:
    """Loader factory (``flairtpu/data/grain_loader.py:93-99``): the
    ``threads`` backend; ``config.py`` refuses ``grain``."""
    if backend != "threads":
        raise ValueError(f"loader backend {backend!r}: only 'threads' is ported")
    return PatchLoader(dataset, **kwargs)
