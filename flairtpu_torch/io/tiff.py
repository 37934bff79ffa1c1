"""TIFF / BigTIFF / GeoTIFF reader and writer with windowed access.

First-party replacement for the GDAL/rasterio surface the reference uses:
whole-image and channel-selected patch reads (reference src/flair/data_loader.py:60-69),
windowed boundless reads with bilinear resampling (reference
src/zone_detect/dataset.py:92-104), and tiled LZW/deflate BigTIFF outputs with
copied georeferencing profiles (reference src/zone_detect/main.py:206-232,
src/flair/writer.py:32-43).

Supported on read: classic TIFF + BigTIFF, strip and tile layouts, chunky and
planar sample organization, compressions none/LZW/deflate/PackBits, horizontal
predictor, u8/u16/u32/i8/i16/i32/f32/f64 samples, GeoTIFF georeferencing tags.
On write: tiled or striped classic/BigTIFF, chunky layout, none/LZW/deflate,
GeoTIFF tags + GDAL nodata.

Reads are thread-safe (mmap-backed, lock-protected LRU block cache): unlike the
reference's shared rasterio handle (src/zone_detect/dataset.py:59, the README:244
"num_worker <= 2" concurrency hazard), one reader can feed many prefetch threads.
"""

from __future__ import annotations

import math
import mmap
import os
import struct
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from flairtpu_torch.io import codecs

# --- TIFF constants --------------------------------------------------------

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q", 18: "Q"}

TAG_WIDTH = 256
TAG_LENGTH = 257
TAG_BITSPERSAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIPOFFSETS = 273
TAG_SPP = 277
TAG_ROWSPERSTRIP = 278
TAG_STRIPBYTECOUNTS = 279
TAG_PLANARCONFIG = 284
TAG_PREDICTOR = 317
TAG_TILEWIDTH = 322
TAG_TILELENGTH = 323
TAG_TILEOFFSETS = 324
TAG_TILEBYTECOUNTS = 325
TAG_EXTRASAMPLES = 338
TAG_SAMPLEFORMAT = 339
TAG_MODELPIXELSCALE = 33550
TAG_MODELTIEPOINT = 33922
TAG_MODELTRANSFORM = 34264
TAG_GEOKEYDIR = 34735
TAG_GEODOUBLES = 34736
TAG_GEOASCII = 34737
TAG_JPEGTABLES = 347
TAG_GDAL_NODATA = 42113

_COMPRESS_NAMES = {1: None, 5: "lzw", 8: "deflate", 32773: "packbits", 32946: "deflate"}
_COMPRESS_CODES = {None: 1, "none": 1, "raw": 1, "lzw": 5, "LZW": 5,
                   "deflate": 8, "DEFLATE": 8, "zlib": 8}


# --- Geo primitives --------------------------------------------------------

@dataclass(frozen=True)
class Affine:
    """Row-major 2D affine: x = a*col + b*row + c ; y = d*col + e*row + f.

    Field order matches the rasterio convention so profiles read naturally.
    """

    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    @classmethod
    def from_origin(cls, ulx: float, uly: float, xres: float, yres: float) -> "Affine":
        return cls(xres, 0.0, ulx, 0.0, -yres, uly)

    @classmethod
    def identity(cls) -> "Affine":
        return cls(1.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    def xy(self, row: float, col: float) -> tuple[float, float]:
        return (self.a * col + self.b * row + self.c,
                self.d * col + self.e * row + self.f)

    def rowcol(self, x: float, y: float) -> tuple[float, float]:
        det = self.a * self.e - self.b * self.d
        if det == 0:
            raise ValueError("Singular transform")
        col = (self.e * (x - self.c) - self.b * (y - self.f)) / det
        row = (-self.d * (x - self.c) + self.a * (y - self.f)) / det
        return row, col

    def to_tuple(self) -> tuple[float, ...]:
        return (self.a, self.b, self.c, self.d, self.e, self.f)


@dataclass
class Window:
    """Pixel-space read/write window (offsets and sizes may be fractional)."""

    col_off: float
    row_off: float
    width: float
    height: float

    @classmethod
    def from_bounds(cls, left: float, bottom: float, right: float, top: float,
                    transform: Affine) -> "Window":
        row0, col0 = transform.rowcol(left, top)
        row1, col1 = transform.rowcol(right, bottom)
        return cls(col0, row0, col1 - col0, row1 - row0)

    def rounded(self) -> tuple[int, int, int, int]:
        """Integer (col0, row0, w, h): floor offsets, ceil far edge.

        Matches rasterio's geometry_window(...).round_shape(op='ceil') usage on
        the reference write path (src/zone_detect/compare.py:80-82).
        """
        c0 = math.floor(self.col_off + 1e-9)
        r0 = math.floor(self.row_off + 1e-9)
        c1 = math.ceil(self.col_off + self.width - 1e-9)
        r1 = math.ceil(self.row_off + self.height - 1e-9)
        return c0, r0, c1 - c0, r1 - r0

    def toranges(self) -> tuple[tuple[int, int], tuple[int, int]]:
        c0, r0, w, h = self.rounded()
        return (r0, r0 + h), (c0, c0 + w)


def _np_dtype(bits: int, fmt: int, byteorder: str) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt, "u")
    return np.dtype(f"{byteorder}{kind}{bits // 8}")


# --- Reader ----------------------------------------------------------------

class TiffReader:
    """Windowed reader for (Big)TIFF rasters. Thread-safe."""

    def __init__(self, path: str | os.PathLike, cache_blocks: int = 64,
                 ifd_index: int = 0):
        self.path = str(path)
        self._fh = open(self.path, "rb")
        try:
            self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # zero-length file
            raise ValueError(f"Not a TIFF file (empty): {self.path}")
        self._lock = threading.Lock()
        self._cache: OrderedDict[tuple[int, int], np.ndarray] = OrderedDict()
        self._cache_cap = cache_blocks
        self.closed = False
        self._ifd_index = int(ifd_index)  # 0 = full res; 1.. = overview IFDs
        self.overview_offsets: list[int] = []
        self._parse()

    # -- parsing --

    def _parse(self):
        mm = self._mm
        order = mm[0:2]
        if order == b"II":
            self._bo = "<"
        elif order == b"MM":
            self._bo = ">"
        else:
            raise ValueError(f"Not a TIFF file: {self.path}")
        magic = struct.unpack(self._bo + "H", mm[2:4])[0]
        if magic == 42:
            self.bigtiff = False
            ifd_off = struct.unpack(self._bo + "I", mm[4:8])[0]
        elif magic == 43:
            self.bigtiff = True
            offsize, zero = struct.unpack(self._bo + "HH", mm[4:8])
            if offsize != 8 or zero != 0:
                raise ValueError("Unsupported BigTIFF header")
            ifd_off = struct.unpack(self._bo + "Q", mm[8:16])[0]
        else:
            raise ValueError(f"Unknown TIFF magic {magic} in {self.path}")

        # walk the IFD chain: IFD0 is full resolution, subsequent IFDs are
        # COG-style reduced-resolution overviews (NewSubfileType=1)
        chain = [ifd_off]
        nxt = self._next_ifd_offset(ifd_off)
        while nxt and len(chain) < 64:
            chain.append(nxt)
            nxt = self._next_ifd_offset(nxt)
        self.overview_offsets = chain[1:]
        if self._ifd_index >= len(chain):
            raise ValueError(
                f"ifd_index {self._ifd_index} out of range: {self.path} has "
                f"{len(chain)} IFD(s)")
        self.tags = self._read_ifd(chain[self._ifd_index])
        t = self.tags
        self.width = int(t[TAG_WIDTH][0])
        self.height = int(t[TAG_LENGTH][0])
        self.count = int(t.get(TAG_SPP, [1])[0])
        bits = t.get(TAG_BITSPERSAMPLE, [8])
        if len(set(bits)) != 1:
            raise ValueError("Heterogeneous BitsPerSample not supported")
        fmt = t.get(TAG_SAMPLEFORMAT, [1])[0]
        self.dtype = _np_dtype(int(bits[0]), int(fmt), self._bo)
        self._itemsize = self.dtype.itemsize
        self.compression = int(t.get(TAG_COMPRESSION, [1])[0])
        self.predictor = int(t.get(TAG_PREDICTOR, [1])[0])
        self.planar = int(t.get(TAG_PLANARCONFIG, [1])[0])

        if TAG_TILEWIDTH in t:
            self.tiled = True
            self.block_w = int(t[TAG_TILEWIDTH][0])
            self.block_h = int(t[TAG_TILELENGTH][0])
            self._offsets = list(t[TAG_TILEOFFSETS])
            self._counts = list(t[TAG_TILEBYTECOUNTS])
        else:
            self.tiled = False
            self.block_w = self.width
            self.block_h = int(t.get(TAG_ROWSPERSTRIP, [self.height])[0])
            self.block_h = min(self.block_h, self.height)
            self._offsets = list(t[TAG_STRIPOFFSETS])
            self._counts = list(t[TAG_STRIPBYTECOUNTS])
        self._blocks_across = _ceildiv(self.width, self.block_w)
        self._blocks_down = _ceildiv(self.height, self.block_h)

        # georeferencing
        self.transform = Affine.identity()
        if TAG_MODELTRANSFORM in t:
            m = t[TAG_MODELTRANSFORM]
            self.transform = Affine(m[0], m[1], m[3], m[4], m[5], m[7])
        elif TAG_MODELPIXELSCALE in t and TAG_MODELTIEPOINT in t:
            sx, sy = t[TAG_MODELPIXELSCALE][0], t[TAG_MODELPIXELSCALE][1]
            tp = t[TAG_MODELTIEPOINT]
            i, j, x, y = tp[0], tp[1], tp[3], tp[4]
            self.transform = Affine(sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)
        self.crs = self._parse_crs()
        self.nodata = None
        if TAG_GDAL_NODATA in t:
            try:
                self.nodata = float(str(t[TAG_GDAL_NODATA]).strip("\x00 "))
            except ValueError:
                pass

    def _next_ifd_offset(self, off: int) -> int:
        mm, bo = self._mm, self._bo
        if self.bigtiff:
            (n,) = struct.unpack(bo + "Q", mm[off : off + 8])
            pos = off + 8 + int(n) * 20
            return struct.unpack(bo + "Q", mm[pos : pos + 8])[0]
        (n,) = struct.unpack(bo + "H", mm[off : off + 2])
        pos = off + 2 + int(n) * 12
        return struct.unpack(bo + "I", mm[pos : pos + 4])[0]

    def _read_ifd(self, off: int) -> dict:
        mm, bo = self._mm, self._bo
        tags: dict[int, object] = {}
        if self.bigtiff:
            (n,) = struct.unpack(bo + "Q", mm[off : off + 8])
            entry_off, entry_sz, cnt_fmt, val_sz = off + 8, 20, "Q", 8
        else:
            (n,) = struct.unpack(bo + "H", mm[off : off + 2])
            entry_off, entry_sz, cnt_fmt, val_sz = off + 2, 12, "I", 4
        for k in range(int(n)):
            e = entry_off + k * entry_sz
            tag, typ = struct.unpack(bo + "HH", mm[e : e + 4])
            (cnt,) = struct.unpack(bo + cnt_fmt, mm[e + 4 : e + 4 + (8 if self.bigtiff else 4)])
            vpos = e + entry_sz - val_sz
            size = _TYPE_SIZES.get(typ, 1) * cnt
            if size <= val_sz:
                raw = mm[vpos : vpos + size]
            else:
                (ptr,) = struct.unpack(bo + ("Q" if self.bigtiff else "I"), mm[vpos : vpos + val_sz])
                raw = mm[ptr : ptr + size]
            tags[tag] = self._decode_tag(typ, cnt, raw)
        return tags

    def _decode_tag(self, typ: int, cnt: int, raw: bytes):
        bo = self._bo
        if typ == 2:  # ASCII
            return raw.split(b"\x00")[0].decode("ascii", "replace")
        if typ in (5, 10):  # RATIONAL
            fmt = "I" if typ == 5 else "i"
            vals = struct.unpack(bo + fmt * (2 * cnt), raw)
            return [vals[2 * i] / max(vals[2 * i + 1], 1) for i in range(cnt)]
        f = _TYPE_FMT.get(typ)
        if f is None:
            return raw
        return list(struct.unpack(bo + f * cnt, raw))

    def _parse_crs(self):
        # GeoKeys are sorted ascending by ID, so GeographicTypeGeoKey (2048)
        # always precedes ProjectedCSTypeGeoKey (3072). Projected rasters
        # often carry BOTH (GDAL records the geographic base CRS too, e.g.
        # Lambert-93 zones with 4171+2154); the projected key must win or the
        # wrong EPSG propagates into every output raster's profile.
        gk = self.tags.get(TAG_GEOKEYDIR)
        if not gk:
            return None
        nkeys = int(gk[3])
        geographic = None
        for k in range(nkeys):
            key_id, loc, cnt, val = gk[4 + 4 * k : 8 + 4 * k]
            if loc != 0:
                continue
            if key_id == 3072:  # ProjectedCSTypeGeoKey
                return int(val)
            if key_id == 2048:  # GeographicTypeGeoKey
                geographic = int(val)
        return geographic

    # -- public surface --

    @property
    def shape(self) -> tuple[int, int]:
        return (self.height, self.width)

    @property
    def res(self) -> tuple[float, float]:
        return (abs(self.transform.a), abs(self.transform.e))

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        x0, y0 = self.transform.xy(0, 0)
        x1, y1 = self.transform.xy(self.height, self.width)
        return (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))

    @property
    def profile(self) -> dict:
        return {
            "driver": "GTiff",
            "width": self.width,
            "height": self.height,
            "count": self.count,
            "dtype": np.dtype(self.dtype).newbyteorder("=").name,
            "crs": self.crs,
            "transform": self.transform,
            "nodata": self.nodata,
            "compress": _COMPRESS_NAMES.get(self.compression),
            "tiled": self.tiled,
            "blockxsize": self.block_w,
            "blockysize": self.block_h,
        }

    def close(self):
        if not self.closed:
            self._mm.close()
            self._fh.close()
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- block access --

    def _decode_block(self, block_idx: int, plane: int) -> np.ndarray:
        """Decode one tile/strip; returns (rows, cols, samples_in_block)."""
        flat = block_idx + plane * self._blocks_across * self._blocks_down
        off, cnt = int(self._offsets[flat]), int(self._counts[flat])
        raw = bytes(self._mm[off : off + cnt])
        spb = self.count if self.planar == 1 else 1  # samples per block
        if self.tiled:
            rows, cols = self.block_h, self.block_w
        else:
            row0 = (block_idx // self._blocks_across) * self.block_h
            rows = min(self.block_h, self.height - row0)
            cols = self.width
        nbytes = rows * cols * spb * self._itemsize
        decoder = codecs.DECODERS.get(self.compression)
        if decoder is None:
            raise ValueError(f"Unsupported TIFF compression {self.compression}")
        if self.compression == 7 and TAG_JPEGTABLES in self.tags:
            # merge shared JPEG tables: tables stream minus EOI + strip minus SOI
            tables = bytes(self.tags[TAG_JPEGTABLES])
            if len(tables) > 4:
                raw = tables[:-2] + raw[2:]
        data = decoder(raw, nbytes) if self.compression != 1 else raw
        if len(data) < nbytes:
            data = data + b"\x00" * (nbytes - len(data))
        arr = np.frombuffer(data, dtype=self.dtype, count=rows * cols * spb)
        arr = arr.reshape(rows, cols, spb)
        if self.predictor == 2:
            # frombuffer views are read-only; predictor decode works in place.
            arr = codecs.predictor2_decode(np.array(arr, copy=True, order="C"))
        if self.dtype.byteorder not in ("=", "|") and self._bo != ("<" if np.little_endian else ">"):
            arr = arr.astype(self.dtype.newbyteorder("="))
        return arr

    def _get_block(self, block_idx: int, plane: int) -> np.ndarray:
        key = (block_idx, plane)
        with self._lock:
            cached = self._cache.get(key)
            if cached is not None:
                self._cache.move_to_end(key)
                return cached
        arr = self._decode_block(block_idx, plane)
        with self._lock:
            self._cache[key] = arr
            if len(self._cache) > self._cache_cap:
                self._cache.popitem(last=False)
        return arr

    # -- reads --

    def read(self, indexes=None, window: Window | None = None, out_shape=None,
             resampling: str = "nearest", boundless: bool = False, fill_value=0) -> np.ndarray:
        """Read bands into a (bands, h, w) array (or (h, w) for a scalar index).

        ``indexes`` is 1-based (GDAL convention, reference README:187).
        """
        scalar = isinstance(indexes, int)
        if indexes is None:
            bands = list(range(self.count))
        elif scalar:
            bands = [indexes - 1]
        else:
            bands = [i - 1 for i in indexes]
        for b in bands:
            if not 0 <= b < self.count:
                raise IndexError(f"band index out of range: {b + 1} (count={self.count})")

        if window is None:
            c0, r0, w, h = 0, 0, self.width, self.height
        else:
            c0, r0, w, h = window.rounded()
        out = self._read_region(bands, c0, r0, w, h, boundless, fill_value)

        if out_shape is not None:
            tgt = out_shape[-2:]
            if tuple(tgt) != (h, w):
                out = _resample(out, tgt, resampling)
        return out[0] if scalar else out

    def _read_region(self, bands, c0, r0, w, h, boundless, fill_value):
        native = self.dtype.newbyteorder("=")
        out = np.full((len(bands), h, w), fill_value, dtype=native)
        ic0, ir0 = max(c0, 0), max(r0, 0)
        ic1, ir1 = min(c0 + w, self.width), min(r0 + h, self.height)
        if ic1 <= ic0 or ir1 <= ir0:
            if not boundless:
                raise ValueError("Window does not intersect raster; pass boundless=True")
            return out
        if not boundless and (c0 < 0 or r0 < 0 or c0 + w > self.width or r0 + h > self.height):
            # Clip silently to the raster like rasterio's default read.
            pass

        bx0, bx1 = ic0 // self.block_w, (ic1 - 1) // self.block_w
        by0, by1 = ir0 // self.block_h, (ir1 - 1) // self.block_h
        for by in range(by0, by1 + 1):
            for bx in range(bx0, bx1 + 1):
                block_idx = by * self._blocks_across + bx
                brow0, bcol0 = by * self.block_h, bx * self.block_w
                # intersection of block with requested region
                rr0, rr1 = max(ir0, brow0), min(ir1, brow0 + self.block_h)
                cc0, cc1 = max(ic0, bcol0), min(ic1, bcol0 + self.block_w)
                if rr1 <= rr0 or cc1 <= cc0:
                    continue
                if self.planar == 1:
                    blk = self._get_block(block_idx, 0)
                    sub = blk[rr0 - brow0 : rr1 - brow0, cc0 - bcol0 : cc1 - bcol0, :]
                    for oi, b in enumerate(bands):
                        out[oi, rr0 - r0 : rr1 - r0, cc0 - c0 : cc1 - c0] = sub[:, :, b]
                else:
                    for oi, b in enumerate(bands):
                        blk = self._get_block(block_idx, b)
                        out[oi, rr0 - r0 : rr1 - r0, cc0 - c0 : cc1 - c0] = (
                            blk[rr0 - brow0 : rr1 - brow0, cc0 - bcol0 : cc1 - bcol0, 0]
                        )
        return out


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def _resample(arr: np.ndarray, out_hw: tuple[int, int], method: str) -> np.ndarray:
    """Resample (bands, h, w) -> (bands, H, W). 'nearest' or 'bilinear'."""
    b, h, w = arr.shape
    H, W = out_hw
    if (H, W) == (h, w):
        return arr
    if method == "nearest":
        ri = np.minimum((np.arange(H) * h / H).astype(np.int64), h - 1)
        ci = np.minimum((np.arange(W) * w / W).astype(np.int64), w - 1)
        return arr[:, ri[:, None], ci[None, :]]
    # bilinear, pixel-center aligned (GDAL convention)
    ry = (np.arange(H) + 0.5) * h / H - 0.5
    cx = (np.arange(W) + 0.5) * w / W - 0.5
    r0 = np.clip(np.floor(ry).astype(np.int64), 0, h - 1)
    c0 = np.clip(np.floor(cx).astype(np.int64), 0, w - 1)
    r1 = np.minimum(r0 + 1, h - 1)
    c1 = np.minimum(c0 + 1, w - 1)
    fy = np.clip(ry - r0, 0.0, 1.0)[None, :, None]
    fx = np.clip(cx - c0, 0.0, 1.0)[None, None, :]
    a = arr.astype(np.float64)
    top = a[:, r0[:, None], c0[None, :]] * (1 - fx) + a[:, r0[:, None], c1[None, :]] * fx
    bot = a[:, r1[:, None], c0[None, :]] * (1 - fx) + a[:, r1[:, None], c1[None, :]] * fx
    out = top * (1 - fy) + bot * fy
    if np.issubdtype(arr.dtype, np.integer):
        out = np.rint(out)
    return out.astype(arr.dtype)


# --- Writer ----------------------------------------------------------------

class TiffWriter:
    """Random-access raster writer that finalizes to a tiled (Big)TIFF on close.

    Window writes land in an on-disk scratch memmap (so BIGTIFF-scale outputs
    never hold the full raster in RAM, and read-modify-write stitching modes can
    read back what was written, like the reference's `rasterio.open(..., 'w+')`
    at src/zone_detect/main.py:232 + compare.py:106-108). ``close()`` compresses
    blocks in parallel and writes the final TIFF.
    """

    def __init__(self, path: str | os.PathLike, width: int, height: int, count: int,
                 dtype, transform: Affine | None = None, crs: int | None = None,
                 nodata=None, compress: str | None = "deflate", tiled: bool = True,
                 blockxsize: int = 512, blockysize: int = 512,
                 bigtiff: bool | str = "auto", num_threads: int = 8,
                 scratch_dir: str | None = None,
                 overviews: list[int] | None = None):
        self.path = str(path)
        self.width, self.height, self.count = int(width), int(height), int(count)
        self.dtype = np.dtype(dtype)
        self.transform = transform or Affine.identity()
        self.crs = crs
        self.nodata = nodata
        self.compression = _COMPRESS_CODES.get(compress, 8)
        self.tiled = tiled
        if tiled:
            # TIFF requires tile dims % 16 == 0
            self.block_w = max(16, (int(blockxsize) // 16) * 16)
            self.block_h = max(16, (int(blockysize) // 16) * 16)
        else:
            self.block_w, self.block_h = self.width, min(int(blockysize), self.height)
        total = self.width * self.height * self.count * self.dtype.itemsize
        if bigtiff == "auto":
            self.bigtiff = total > (3 << 30)
        else:
            self.bigtiff = bool(bigtiff) and str(bigtiff).upper() != "NO"
        self.num_threads = num_threads
        # COG-style reduced-resolution overview IFDs (e.g. [2, 4, 8]); nearest
        # resampling (class/confidence rasters must not blend label values)
        self.overviews = sorted(overviews or [])
        self.closed = False

        sdir = scratch_dir or os.path.dirname(os.path.abspath(self.path)) or "."
        self._scratch_path = os.path.join(
            sdir, f".{os.path.basename(self.path)}.scratch-{os.getpid()}"
        )
        self._buf = np.memmap(self._scratch_path, dtype=self.dtype, mode="w+",
                              shape=(self.count, self.height, self.width))
        if nodata not in (None, 0):
            self._buf[:] = nodata

    @classmethod
    def from_profile(cls, path, profile: dict, **overrides) -> "TiffWriter":
        """Create a writer from a reader-style profile dict (+ overrides)."""
        p = dict(profile)
        p.update(overrides)
        return cls(
            path,
            width=p["width"], height=p["height"], count=p.get("count", 1),
            dtype=p.get("dtype", "uint8"), transform=p.get("transform"),
            crs=p.get("crs"), nodata=p.get("nodata"),
            compress=p.get("compress", "deflate"),
            tiled=bool(p.get("tiled", True)),
            blockxsize=p.get("blockxsize", 512), blockysize=p.get("blockysize", 512),
            bigtiff=p.get("BIGTIFF", p.get("bigtiff", "auto")),
        )

    # -- band/window writes (reference main.py:421-426 write_band parity) --

    def write_band(self, indexes, data: np.ndarray, window: Window | None = None):
        if isinstance(indexes, int):
            indexes, data = [indexes], data[None] if data.ndim == 2 else data
        if data.ndim == 2:
            data = data[None]
        if window is None:
            c0, r0, w, h = 0, 0, self.width, self.height
        else:
            c0, r0, w, h = window.rounded()
        # clip to raster bounds
        src_r0, src_c0 = max(0, -r0), max(0, -c0)
        rr0, cc0 = max(r0, 0), max(c0, 0)
        rr1, cc1 = min(r0 + h, self.height), min(c0 + w, self.width)
        if rr1 <= rr0 or cc1 <= cc0:
            return
        for bi, band in enumerate(indexes):
            self._buf[band - 1, rr0:rr1, cc0:cc1] = data[
                bi, src_r0 : src_r0 + (rr1 - rr0), src_c0 : src_c0 + (cc1 - cc0)
            ].astype(self.dtype)

    def write(self, data: np.ndarray, window: Window | None = None):
        self.write_band(list(range(1, self.count + 1)), data, window)

    def read(self, window: Window | None = None) -> np.ndarray:
        """Read back written data (for read-modify-write stitching).

        Returns a copy: a view of the scratch memmap would dangle (and
        segfault) once close() unmaps it.
        """
        if window is None:
            return np.array(self._buf)
        c0, r0, w, h = window.rounded()
        rr0, cc0 = max(r0, 0), max(c0, 0)
        rr1, cc1 = min(r0 + h, self.height), min(c0 + w, self.width)
        out = np.zeros((self.count, h, w), dtype=self.dtype)
        if rr1 > rr0 and cc1 > cc0:
            out[:, rr0 - r0 : rr1 - r0, cc0 - c0 : cc1 - c0] = self._buf[:, rr0:rr1, cc0:cc1]
        return out

    @property
    def profile(self) -> dict:
        return {
            "driver": "GTiff", "width": self.width, "height": self.height,
            "count": self.count, "dtype": self.dtype.name, "crs": self.crs,
            "transform": self.transform, "nodata": self.nodata,
            "tiled": self.tiled, "blockxsize": self.block_w, "blockysize": self.block_h,
        }

    # -- finalize --

    def close(self):
        if self.closed:
            return
        try:
            self._finalize()
        finally:
            self._buf._mmap.close()  # type: ignore[attr-defined]
            del self._buf
            try:
                os.remove(self._scratch_path)
            except OSError:
                pass
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _block_bytes(self, arr: np.ndarray, by: int, bx: int,
                     bh: int, bw: int) -> bytes:
        r0, c0 = by * bh, bx * bw
        r1, c1 = min(r0 + bh, arr.shape[1]), min(c0 + bw, arr.shape[2])
        sub = np.asarray(arr[:, r0:r1, c0:c1])  # (count, h, w)
        chunky = np.ascontiguousarray(np.moveaxis(sub, 0, -1))  # (h, w, count)
        if self.tiled and (chunky.shape[0] < bh or chunky.shape[1] < bw):
            pad = np.zeros((bh, bw, self.count), dtype=self.dtype)
            pad[: chunky.shape[0], : chunky.shape[1]] = chunky
            chunky = pad
        if self.compression in (5, 8) and self.dtype.itemsize == 1:
            chunky = codecs.predictor2_encode(chunky)
            self._used_predictor = True
        raw = chunky.tobytes()
        enc = codecs.ENCODERS[self.compression]
        return enc(raw)

    def _finalize(self):
        # IFD0 = full resolution; one chained reduced-resolution IFD per
        # overview factor (NewSubfileType=1, nearest resampling) — the
        # COG-style layout GDAL/QGIS use for fast zoomed-out display
        levels: list[tuple] = [(self._buf, self.width, self.height, 0)]
        for fct in self.overviews:
            ov = self._buf[:, ::fct, ::fct]
            if ov.shape[1] < 1 or ov.shape[2] < 1:
                continue
            levels.append((ov, ov.shape[2], ov.shape[1], 1))

        with open(self.path, "wb") as f:
            if self.bigtiff:
                f.write(b"II" + struct.pack("<HHH", 43, 8, 0) + struct.pack("<Q", 0))
                prev_next_pos = 8
            else:
                f.write(b"II" + struct.pack("<H", 42) + struct.pack("<I", 0))
                prev_next_pos = 4

            for arr, w, h, subfile in levels:
                if self.tiled:
                    bw, bh = self.block_w, self.block_h
                else:
                    bw, bh = w, min(self.block_h, h)
                bx_n, by_n = _ceildiv(w, bw), _ceildiv(h, bh)
                self._used_predictor = False
                order = [(by, bx) for by in range(by_n) for bx in range(bx_n)]
                if self.num_threads > 1 and len(order) > 1:
                    with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
                        blocks = list(ex.map(
                            lambda rc: self._block_bytes(arr, *rc, bh, bw), order))
                else:
                    blocks = [self._block_bytes(arr, *rc, bh, bw) for rc in order]
                offsets, counts = [], []
                for blk in blocks:
                    if f.tell() % 2:
                        f.write(b"\x00")
                    offsets.append(f.tell())
                    counts.append(len(blk))
                    f.write(blk)
                ifd_off, next_pos = self._write_ifd(
                    f, offsets, counts, w, h, bw, bh, subfile)
                end = f.tell()
                f.seek(prev_next_pos)
                f.write(struct.pack("<Q" if self.bigtiff else "<I", ifd_off))
                f.seek(end)
                prev_next_pos = next_pos

    def _write_ifd(self, f, offsets, counts, width: int, height: int,
                   block_w: int, block_h: int, subfile: int = 0) -> tuple[int, int]:
        bigtiff = self.bigtiff
        kind = self.dtype.kind
        sample_fmt = {"u": 1, "i": 2, "f": 3}[kind]
        bits = self.dtype.itemsize * 8

        entries: list[tuple[int, int, list]] = []  # (tag, type, values)

        def add(tag, typ, vals):
            entries.append((tag, typ, list(vals) if isinstance(vals, (list, tuple)) else [vals]))

        off_t = 16 if bigtiff else 4  # LONG8 vs LONG
        if subfile:
            add(254, 4, subfile)  # NewSubfileType: reduced-resolution image
        add(TAG_WIDTH, 4, width)
        add(TAG_LENGTH, 4, height)
        add(TAG_BITSPERSAMPLE, 3, [bits] * self.count)
        add(TAG_COMPRESSION, 3, self.compression)
        rgb = self.count == 3 and self.dtype == np.uint8
        add(TAG_PHOTOMETRIC, 3, 2 if rgb else 1)  # RGB / MinIsBlack
        add(TAG_SPP, 3, self.count)
        if self.count > 1 and not rgb:
            add(TAG_EXTRASAMPLES, 3, [0] * (self.count - 1))
        add(TAG_PLANARCONFIG, 3, 1)
        if getattr(self, "_used_predictor", False):
            add(TAG_PREDICTOR, 3, 2)
        add(TAG_SAMPLEFORMAT, 3, [sample_fmt] * self.count)
        if self.tiled:
            add(TAG_TILEWIDTH, 3, block_w)
            add(TAG_TILELENGTH, 3, block_h)
            add(TAG_TILEOFFSETS, off_t, offsets)
            add(TAG_TILEBYTECOUNTS, off_t if bigtiff else 4, counts)
        else:
            add(TAG_ROWSPERSTRIP, 4, block_h)
            add(TAG_STRIPOFFSETS, off_t, offsets)
            add(TAG_STRIPBYTECOUNTS, off_t if bigtiff else 4, counts)

        tr = self.transform
        if not subfile and tr.to_tuple() != Affine.identity().to_tuple():
            if tr.b == 0 and tr.d == 0:
                add(TAG_MODELPIXELSCALE, 12, [tr.a, -tr.e, 0.0])
                add(TAG_MODELTIEPOINT, 12, [0.0, 0.0, 0.0, tr.c, tr.f, 0.0])
            else:
                add(TAG_MODELTRANSFORM, 12,
                    [tr.a, tr.b, 0, tr.c, tr.d, tr.e, 0, tr.f, 0, 0, 0, 0, 0, 0, 0, 1])
        if not subfile and self.crs is not None:
            epsg = int(self.crs)
            geographic = 4000 <= epsg < 5000
            keys = [1, 1, 0, 3,
                    1024, 0, 1, 2 if geographic else 1,  # GTModelType
                    1025, 0, 1, 1,  # PixelIsArea
                    (2048 if geographic else 3072), 0, 1, epsg]
            add(TAG_GEOKEYDIR, 3, keys)
        if not subfile and self.nodata is not None:
            nd = str(int(self.nodata) if float(self.nodata).is_integer() else self.nodata)
            entries.append((TAG_GDAL_NODATA, 2, nd))

        entries.sort(key=lambda e: e[0])

        # Serialize: out-of-line payloads first, then the IFD itself.
        payloads = []
        packed = []
        for tag, typ, vals in entries:
            if typ == 2:
                raw = vals.encode("ascii") + b"\x00" if isinstance(vals, str) else bytes(vals)
                cnt = len(raw)
            else:
                fmt = _TYPE_FMT[typ]
                cnt = len(vals)
                raw = struct.pack("<" + fmt * cnt, *vals)
            packed.append((tag, typ, cnt, raw))

        if f.tell() % 8:
            f.write(b"\x00" * (8 - f.tell() % 8))
        val_sz = 8 if bigtiff else 4
        # reserve space for IFD after payload area; write payloads now
        payload_pos = {}
        for i, (tag, typ, cnt, raw) in enumerate(packed):
            if len(raw) > val_sz:
                if f.tell() % 2:
                    f.write(b"\x00")
                payload_pos[i] = f.tell()
                f.write(raw)
        if f.tell() % 8:
            f.write(b"\x00" * (8 - f.tell() % 8))
        ifd_off = f.tell()
        n = len(packed)
        if bigtiff:
            f.write(struct.pack("<Q", n))
        else:
            f.write(struct.pack("<H", n))
        for i, (tag, typ, cnt, raw) in enumerate(packed):
            f.write(struct.pack("<HH", tag, typ))
            f.write(struct.pack("<Q" if bigtiff else "<I", cnt))
            if i in payload_pos:
                f.write(struct.pack("<Q" if bigtiff else "<I", payload_pos[i]))
            else:
                f.write(raw.ljust(val_sz, b"\x00"))
        next_pos = f.tell()
        f.write(struct.pack("<Q" if bigtiff else "<I", 0))  # next IFD (patched)
        return ifd_off, next_pos


def write_array(path, array: np.ndarray, transform: Affine | None = None,
                crs: int | None = None, nodata=None, compress="deflate",
                tiled: bool = True, blockxsize: int = 512, blockysize: int = 512,
                bigtiff="auto") -> None:
    """One-shot convenience writer for a (bands, H, W) or (H, W) array."""
    if array.ndim == 2:
        array = array[None]
    c, h, w = array.shape
    with TiffWriter(path, w, h, c, array.dtype, transform=transform, crs=crs,
                    nodata=nodata, compress=compress, tiled=tiled,
                    blockxsize=blockxsize, blockysize=blockysize, bigtiff=bigtiff) as tw:
        tw.write(array)
