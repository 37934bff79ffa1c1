"""Compression codecs for the TIFF engine.

Pure-Python/NumPy implementations of TIFF LZW, PackBits and the horizontal
predictor, with an optional native C++ fast path (``libflairio.so``, loaded via
ctypes) used automatically when present. Deflate rides zlib either way.

TIFF-flavour LZW (Compression=5): MSB-first bit packing, 9-bit initial codes,
ClearCode=256, EOI=257, and the "early change" rule (code width grows one code
earlier than generic LZW).
"""

from __future__ import annotations

import zlib

import numpy as np

from flairtpu_torch.io._native import native_lib

CLEAR_CODE = 256
EOI_CODE = 257


# ---------------------------------------------------------------------------
# LZW
# ---------------------------------------------------------------------------

def lzw_decode(data: bytes, expected_size: int | None = None) -> bytes:
    """Decode TIFF-flavour LZW. Uses libflairio when available."""
    lib = native_lib()
    if lib is not None and expected_size is not None:
        out = lib.lzw_decode(data, expected_size)
        if out is not None:
            return out
    return _lzw_decode_py(data, expected_size)


def _lzw_decode_py(data: bytes, expected_size: int | None = None) -> bytes:
    out = bytearray()
    # Dictionary as list of bytes; entries 0..255 are single bytes.
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(base)
    bitpos = 0
    nbits = 9
    nbytes = len(data)
    maxbit = nbytes * 8
    prev: bytes | None = None

    def read_code() -> int:
        nonlocal bitpos
        if bitpos + nbits > maxbit:
            return EOI_CODE
        byte0 = bitpos >> 3
        # Up to 3 bytes cover any 9..12-bit window.
        chunk = data[byte0 : byte0 + 3]
        val = int.from_bytes(chunk.ljust(3, b"\0"), "big")
        shift = 24 - (bitpos & 7) - nbits
        bitpos += nbits
        return (val >> shift) & ((1 << nbits) - 1)

    while True:
        code = read_code()
        if code == EOI_CODE:
            break
        if code == CLEAR_CODE:
            table = list(base)
            nbits = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
            out += entry
            prev = entry
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError(f"Corrupt LZW stream: code {code} > table size {len(table)}")
            table.append(prev + entry[:1])
            out += entry
            prev = entry
        # TIFF early change: bump width when the NEXT code would not fit.
        if len(table) + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
        if expected_size is not None and len(out) >= expected_size:
            break
    return bytes(out)


def lzw_encode(data: bytes) -> bytes:
    lib = native_lib()
    if lib is not None:
        out = lib.lzw_encode(data)
        if out is not None:
            return out
    return _lzw_encode_py(data)


def _lzw_encode_py(data: bytes) -> bytes:
    out = bytearray()
    bitbuf = 0
    bitcount = 0
    nbits = 9

    def put(code: int):
        nonlocal bitbuf, bitcount
        bitbuf = (bitbuf << nbits) | code
        bitcount += nbits
        while bitcount >= 8:
            bitcount -= 8
            out.append((bitbuf >> bitcount) & 0xFF)

    table: dict[bytes, int] = {bytes([i]): i for i in range(256)}
    next_code = 258
    put(CLEAR_CODE)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
        else:
            put(table[w])
            table[wc] = next_code
            next_code += 1
            # TIFF early change: the matching decoder widens its read size after
            # appending entry (1<<nbits)-2, so the encoder's next emitted code
            # must widen once next_code passes 1<<nbits.
            if next_code == (1 << nbits) and nbits < 12:
                nbits += 1
            elif next_code == 4094:
                put(CLEAR_CODE)
                table = {bytes([i]): i for i in range(256)}
                next_code = 258
                nbits = 9
            w = bytes([b])
    if w:
        put(table[w])
    put(EOI_CODE)
    if bitcount:
        out.append((bitbuf << (8 - bitcount)) & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# PackBits
# ---------------------------------------------------------------------------

def packbits_decode(data: bytes, expected_size: int | None = None) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and (expected_size is None or len(out) < expected_size):
        h = data[i]
        i += 1
        if h < 128:
            out += data[i : i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i : i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    return bytes(out)


# ---------------------------------------------------------------------------
# Deflate
# ---------------------------------------------------------------------------

def deflate_decode(data: bytes, expected_size: int | None = None) -> bytes:
    return zlib.decompress(data)


def deflate_encode(data: bytes, level: int = 6) -> bytes:
    return zlib.compress(data, level)


# ---------------------------------------------------------------------------
# Horizontal predictor (TIFF Predictor=2)
# ---------------------------------------------------------------------------

def predictor2_decode(arr: np.ndarray) -> np.ndarray:
    """Undo horizontal differencing in place along the last (pixel-run) axis.

    ``arr`` has shape (rows, cols, samples) viewed as the raw tile buffer.
    """
    if arr.dtype == np.uint8:
        lib = native_lib()
        if lib is not None and arr.flags.c_contiguous:
            lib.predictor2_decode_u8(arr)
            return arr
    np.cumsum(arr, axis=1, dtype=arr.dtype, out=arr)
    return arr


def predictor2_encode(arr: np.ndarray) -> np.ndarray:
    out = arr.copy()
    out[:, 1:] = arr[:, 1:] - arr[:, :-1]
    return out


# ---------------------------------------------------------------------------
# Dispatch tables
# ---------------------------------------------------------------------------

def jpeg_decode(data: bytes, expected_size: int | None = None) -> bytes:
    """New-style JPEG (Compression=7) via PIL; returns raw interleaved bytes."""
    import io

    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        import numpy as _np

        return _np.asarray(im).tobytes()


DECODERS = {
    1: lambda d, n=None: d,  # none
    5: lzw_decode,
    7: jpeg_decode,
    8: deflate_decode,  # Adobe deflate
    32773: packbits_decode,
    32946: deflate_decode,  # legacy deflate
}

ENCODERS = {
    1: lambda d: d,
    5: lzw_encode,
    8: deflate_encode,
}
