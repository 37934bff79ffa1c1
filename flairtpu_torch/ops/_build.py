"""Build ``flairtpu_torch/csrc/*.cu`` with nvcc at first use and load each
result with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), all sources at
once, one nvcc process each. Libraries go to ``build/flairtpu_torch_kernels/``
beside the package (``FLAIRTPU_TORCH_BUILD_DIR`` overrides it), named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. A file lock serializes concurrent builders. Each
library's one C entry point shares the source's name and is bound once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_ENTRIES: dict[str, ctypes._CFuncPtr] = {}


def build_dir() -> Path:
    env = os.environ.get("FLAIRTPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "flairtpu_torch_kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the flairtpu_torch CUDA kernels")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    return build_dir() / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu that has no library yet; returns name -> path.

    Raises with nvcc's output if any source fails to build."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {src.stem: _lib_path(src) for src in sorted(CSRC.glob("*.cu"))}
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = []
        for name, so in paths.items():
            if so.exists():
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, so, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def bind(lib: ctypes.CDLL, name: str, argtypes: list):
    """``lib``'s C function ``name``, returning a cudaError_t, with ``argtypes``."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def entry(name: str, argtypes: list):
    """The C entry point ``name`` of the library built from ``csrc/<name>.cu``,
    built, loaded and bound on first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = bind(ctypes.CDLL(str(build_all()[name])), name, argtypes)
    return fn


def check(err: int, kernel: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
