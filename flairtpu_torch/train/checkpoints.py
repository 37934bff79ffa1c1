"""Checkpoints: best / last / resume, the step autosave and the weights-only
init with class-count surgery (counterpart of ``flairtpu/train/
checkpoints.py:51-264``).

The same names and rules as ``flairtpu``'s (reference tasks.py:47-56,
96-101, flair/main.py:106-138): the best checkpoint
``ckpt-{epoch:02d}-{value:.2f}_{name}`` under the monitored metric and its
mode (one kept, and a ``best`` file naming it), ``last`` after every epoch,
``history.json``. Each checkpoint is one file written by ``torch.save``:
``state_dict`` (the model's smp-keyed parameters and BatchNorm running
statistics, on the CPU), and unless ``ckpt_weights_only`` the epoch, the
epoch's metrics and ``opt_state`` (the learning rate: SGD has no other
state). ``flairtpu``'s native ``.msgpack`` / ``.flax`` weights are read
(``paths.ckpt_model_path`` of a predict-only run or of
``init_weights_only_from_ckpt``) and written (:func:`save_weights_msgpack`)
as ``flairtpu`` reads and writes them; its Orbax checkpoint directories are
not read (Orbax's zstd-compressed OCDBT stores need ``tensorstore``, which
is not installed beside the card).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from flairtpu_torch.config import not_ported
from flairtpu_torch.models.convert import (NATIVE_SUFFIXES, from_flax, normalize_keys,
                                           read_native, write_native)


def _cpu(value):
    """Tensors (in nested dicts too) copied to the CPU; other values as they are."""
    if isinstance(value, dict):
        return {k: _cpu(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    return value


def _write(path: Path, payload: dict) -> None:
    """torch.save to a temporary name, then an atomic rename."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    tmp.replace(path)


class CheckpointManager:
    """Best/last checkpoint writer with the reference's naming and monitor rules."""

    def __init__(self, out_dir: str | Path, model_name: str = "model",
                 monitor: str = "val_loss", mode: str = "min",
                 save_last: bool = True, weights_only: bool = False):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.model_name = model_name
        self.monitor = monitor
        self.mode = mode
        self.save_last = save_last
        self.weights_only = weights_only
        self.best_metric: float | None = None
        self.best_path: Path | None = None

    def _is_better(self, value: float) -> bool:
        if self.best_metric is None:
            return True
        return value < self.best_metric if self.mode == "min" else value > self.best_metric

    def _save(self, path: Path, state: dict) -> None:
        payload = {"state_dict": _cpu(state["state_dict"])}
        if not self.weights_only:
            payload.update({k: v for k, v in state.items() if k != "state_dict"})
        _write(path, payload)

    def on_epoch_end(self, epoch: int, metrics: dict[str, float], state: dict) -> bool:
        """Save the best (and last); returns True if this epoch became the best.
        ``state``: {'state_dict', 'opt_state'}."""
        value = float(metrics[self.monitor])
        is_best = self._is_better(value)
        full = dict(state, epoch=epoch, **{k: float(v) for k, v in metrics.items()})
        if is_best:
            self.best_metric = value
            name = f"ckpt-{epoch:02d}-{value:.2f}_{self.model_name}"
            new_best = self.out_dir / name
            self._save(new_best, full)
            if self.best_path is not None and self.best_path.exists() \
                    and self.best_path != new_best:
                self.best_path.unlink()  # save_top_k=1
            self.best_path = new_best
            (self.out_dir / "best").write_text(name)
        if self.save_last:
            self._save(self.out_dir / "last", full)
        return is_best

    @staticmethod
    def restore(path: str | Path) -> dict:
        """A checkpoint written by :meth:`on_epoch_end`."""
        path = Path(path)
        if path.is_dir():
            raise not_ported(f"the Orbax checkpoint directory {str(path)!r}",
                             "slice 4 follow-up: checkpoint interchange with flairtpu")
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore_best(self) -> dict:
        if self.best_path is None:
            marker = self.out_dir / "best"
            if marker.exists():
                self.best_path = self.out_dir / marker.read_text().strip()
        if self.best_path is None:
            raise FileNotFoundError(f"no best checkpoint under {self.out_dir}")
        return self.restore(self.best_path)


class StepAutosaver:
    """Step-level autosave and exact mid-epoch resume (``flairtpu``'s
    ``StepAutosaver``, ``checkpoints.py:143-195``): every ``every_steps``
    train steps, the train state, the augmentation generator's state and the
    epoch's running confusion matrix go to a fresh slot file, then
    ``host.json`` (epoch, step, the running loss sum, the controllers'
    states) flips to it atomically, then older slots are removed. A kill at
    any point leaves the last snapshot whole."""

    def __init__(self, out_dir: str | Path, every_steps: int):
        self.dir = Path(out_dir) / "autosave"
        self.every = int(every_steps)

    def due(self, step_in_epoch: int) -> bool:
        return self.every > 0 and (step_in_epoch + 1) % self.every == 0

    def save(self, arrays: dict, host: dict) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        prev = sorted(self.dir.glob("arrays-*"))
        n = max((int(p.name.split("-")[1]) for p in prev), default=0) + 1
        slot = self.dir / f"arrays-{n:06d}"
        _write(slot, _cpu(arrays))
        tmp = self.dir / "host.json.tmp"
        tmp.write_text(json.dumps({"slot": slot.name, **host}))
        tmp.replace(self.dir / "host.json")
        for p in prev:
            p.unlink(missing_ok=True)

    def restore(self) -> tuple[dict, dict] | None:
        """The latest (arrays, host) snapshot, or None."""
        meta = self.dir / "host.json"
        if not meta.exists():
            return None
        host = json.loads(meta.read_text())
        return torch.load(self.dir / host["slot"], map_location="cpu", weights_only=True), host

    def clear(self) -> None:
        """Remove the autosave (training finished normally)."""
        if self.dir.exists():
            for p in self.dir.iterdir():
                p.unlink()
            self.dir.rmdir()


def load_state_dict_file(path: str | Path, arch: str = "unet") -> dict[str, np.ndarray]:
    """{smp key: array} of a torch ``.pth``/``.pt``/``.ckpt`` (Lightning
    wrappers stripped), of a checkpoint this package wrote, or of
    ``flairtpu``'s native ``.msgpack`` / ``.flax`` weights of ``arch`` (its
    modules that ``arch`` does not have are left out)."""
    p = Path(path)
    if p.is_dir():
        raise not_ported(f"the Orbax checkpoint directory {str(p)!r}",
                         "slice 4 follow-up: checkpoint interchange with flairtpu")
    if p.suffix in NATIVE_SUFFIXES:
        sd = from_flax(*read_native(p), arch, skip_unknown=True)
        return {k: v.numpy() for k, v in sd.items()}
    obj = torch.load(p, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in obj.items()}
    return normalize_keys(sd)


def init_weights_with_surgery(path: str | Path, model: torch.nn.Module,
                              verbose: bool = True) -> list[str]:
    """Weights-only init tolerating a class-count mismatch
    (``flairtpu/train/checkpoints.py:225-262``; reference
    flair/main.py:120-138), from a torch file or native weights: every model
    tensor whose key and shape the file has loads; the others (the head when
    the class counts differ, or keys the file lacks) become zeros. Returns
    the keys zeroed."""
    loaded = load_state_dict_file(path, getattr(model, "arch", "unet"))
    surgeries = []
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            got = loaded.get(key)
            if got is None or tuple(got.shape) != tuple(t.shape):
                surgeries.append(key)
                t.zero_()
            else:
                t.copy_(torch.from_numpy(np.ascontiguousarray(got)))
    if verbose and surgeries:
        print("[ckpt surgery] zero-initialized (shape mismatch or missing):")
        for s in surgeries:
            print(f"    - {s}")
    return surgeries


def save_weights_msgpack(path: str | Path, model: torch.nn.Module) -> None:
    """Weights-only native export (``flairtpu``'s ``save_weights_msgpack``,
    ``checkpoints.py:195-200``): ``{"params", "batch_stats"}`` of ``model``
    in ``flairtpu``'s tree, loadable by ``flairtpu`` and by ``flair-detect``."""
    write_native(path, model.state_dict(), getattr(model, "arch", "unet"))


def write_history(out_dir: str | Path, history: list[dict]) -> None:
    Path(out_dir, "history.json").write_text(json.dumps(history, indent=2))
