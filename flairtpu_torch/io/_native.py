"""ctypes loader for the native C++ raster codec (libflairio.so).

The shared library is built from ``flairtpu_torch/native/flairio.cpp`` by
``flairtpu_torch/native/build.py`` (plain g++ + zlib; no pip deps). Everything it
accelerates has a pure-Python fallback in :mod:`flairtpu_torch.io.codecs`, so the
framework works (slower) if the library has not been built.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

_LIB = None
_LOCK = threading.Lock()
_TRIED = False


class _NativeIO:
    def __init__(self, dll: ctypes.CDLL):
        self._dll = dll
        dll.flairio_lzw_decode.restype = ctypes.c_longlong
        dll.flairio_lzw_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_longlong,
        ]
        dll.flairio_lzw_encode.restype = ctypes.c_longlong
        dll.flairio_lzw_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_longlong,
        ]
        dll.flairio_predictor2_u8.restype = None
        dll.flairio_predictor2_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ]

    def lzw_decode(self, data: bytes, expected_size: int) -> bytes | None:
        out = ctypes.create_string_buffer(expected_size)
        n = self._dll.flairio_lzw_decode(data, len(data), out, expected_size)
        if n < 0:
            return None
        return out.raw[:n]

    def lzw_encode(self, data: bytes) -> bytes | None:
        # Worst case: 12 bits per input byte plus control codes.
        cap = len(data) * 2 + 1024
        out = ctypes.create_string_buffer(cap)
        n = self._dll.flairio_lzw_encode(data, len(data), out, cap)
        if n < 0:
            return None
        return out.raw[:n]

    def predictor2_decode_u8(self, arr) -> None:
        rows, cols, samples = arr.shape
        self._dll.flairio_predictor2_u8(
            arr.ctypes.data_as(ctypes.c_void_p), rows, cols, samples
        )


def _candidate_paths():
    here = Path(__file__).resolve().parent.parent / "native"
    yield here / "libflairio.so"
    env = os.environ.get("FLAIRIO_LIB")
    if env:
        yield Path(env)


def native_lib() -> _NativeIO | None:
    """Return the native codec wrapper, or None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        if os.environ.get("FLAIRIO_DISABLE_NATIVE"):
            _TRIED = True
            return None
        try:  # build lazily on first use (a one-off ~1s g++ invocation)
            from flairtpu_torch.native.build import build

            build()
        except Exception:
            pass
        for p in _candidate_paths():
            if p.is_file():
                try:
                    _LIB = _NativeIO(ctypes.CDLL(str(p)))
                    break
                except OSError:
                    continue
        _TRIED = True
    return _LIB
