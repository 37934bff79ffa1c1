"""Console + file tee and seeding (reference flair/main.py:36-48, 166)."""

from __future__ import annotations

import random
import sys


class TeeLogger:
    """Duplicates writes to the terminal and a log file.

    Mirrors the reference's Logger (flair/main.py:36-48, zone_detect/main.py:52-64)
    including stderr capture on the zone path.
    """

    def __init__(self, filename: str):
        self.terminal = sys.stdout
        self.log = open(filename, "w", encoding="utf-8")
        self.encoding = getattr(self.terminal, "encoding", "utf-8")

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()


def tee_stdout(filename: str, capture_stderr: bool = False) -> TeeLogger:
    logger = TeeLogger(filename)
    sys.stdout = logger
    if capture_stderr:
        sys.stderr = logger  # type: ignore[assignment]
    return logger


def untee_stdout():
    if isinstance(sys.stdout, TeeLogger):
        sys.stdout.close()
    sys.stdout = sys.__stdout__
    sys.stderr = sys.__stderr__


def seed_everything(seed: int) -> None:
    import numpy as np

    random.seed(seed)
    np.random.seed(seed % (2**32))
