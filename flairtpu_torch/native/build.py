#!/usr/bin/env python3
"""Build libflairio.so (native raster codec fast paths).

Usage: python -m flairtpu_torch.native.build
Plain g++, no pip deps. Safe to re-run; skips when the .so is newer than the
source. The Python codec layer falls back to pure-Python if this was never run.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "flairio.cpp"
OUT = HERE / "libflairio.so"


def build(force: bool = False) -> Path:
    if not force and OUT.exists() and OUT.stat().st_mtime >= SRC.stat().st_mtime:
        return OUT
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-Wall", "-Wextra",
        str(SRC), "-o", str(OUT),
    ]
    print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)
    return OUT


if __name__ == "__main__":
    build(force="--force" in sys.argv)
    print(f"built {OUT}")
