"""Scalar logging (counterpart of ``flairtpu/train/logging.py``): one JSON
line per epoch in ``metrics.jsonl``, and TensorBoard with the reference's
tags (train_loss, val_loss, val_miou, val_iou_<class>) where
``torch.utils.tensorboard`` imports."""

from __future__ import annotations

import json
from pathlib import Path


class MetricsLogger:
    def __init__(self, out_dir: str | Path, name: str = "flair-tpu"):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.out_dir / "metrics.jsonl", "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=str(self.out_dir / "tensorboard" / name))
        except Exception:  # tensorboard not installed: the JSONL alone
            pass

    def log(self, step: int, scalars: dict[str, float]) -> None:
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
