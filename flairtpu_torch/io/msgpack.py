"""The msgpack form of ``flairtpu``'s native weights (``.msgpack`` /
``.flax``), read and written without the ``msgpack`` or ``flax`` packages
(neither is installed beside the card).

The format is flax 0.12.3's ``flax/serialization.py``: ``msgpack_serialize``
packs a tree of dicts with ``use_bin_type=True`` and ``strict_types=True``;
a numpy array is ext type 1 and a numpy scalar ext type 3, whose payload is
itself a msgpack array ``(shape, dtype name, C-order bytes)``
(``_ndarray_to_bytes``); an array of more than ``MAX_CHUNK_SIZE`` bytes is
first split into ``{'__msgpack_chunked_array__': True, 'shape': {...},
'chunks': {...}}`` of flat pieces (``_chunk``). ``msgpack_serialize`` copies
the tree with ``jax.tree_util.tree_map``, which orders every dict's keys;
:func:`packb` orders them too, so both write the same bytes for the same
tree of dicts and numpy arrays.

:func:`unpackb` reads maps, arrays, str, bin, ext (fixext and ext 8/16/32),
ints, floats, bool and nil, and reassembles chunked arrays, as
``msgpack_restore`` does. An ext type other than 1 and 3, a dtype outside
:data:`DTYPES`, a truncated or malformed input raises a ``ValueError`` that
names it; no partial tree is returned.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
# flax.serialization.MAX_CHUNK_SIZE: arrays over it are written in pieces
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
# the array dtypes read and written, by numpy name
DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float16", "float32", "float64")


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _dtype_name(dtype: np.dtype) -> str:
    if dtype.name not in DTYPES:
        raise ValueError(f"msgpack: unsupported array dtype {dtype.name!r} "
                         f"(supported: {', '.join(DTYPES)})")
    return dtype.name


def _pack_int(n: int, out: list) -> None:
    """msgpack-python's smallest encoding of an integer."""
    if n < -(1 << 5):
        if n < -(1 << 15):
            out.append(b"\xd2" + struct.pack(">i", n) if n >= -(1 << 31)
                       else b"\xd3" + struct.pack(">q", n))
        else:
            out.append(b"\xd0" + struct.pack(">b", n) if n >= -(1 << 7)
                       else b"\xd1" + struct.pack(">h", n))
    elif n < (1 << 7):
        out.append(struct.pack(">b", n))  # positive and negative fixint
    elif n < (1 << 16):
        out.append(b"\xcc" + struct.pack(">B", n) if n < (1 << 8)
                   else b"\xcd" + struct.pack(">H", n))
    elif n < (1 << 32):
        out.append(b"\xce" + struct.pack(">I", n))
    elif n < (1 << 64):
        out.append(b"\xcf" + struct.pack(">Q", n))
    else:
        raise ValueError(f"msgpack: integer {n} does not fit in 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: list) -> None:
    """A length header: the fix form below ``fix_max``, else 8 / 16 / 32 bits
    (``codes``: their type bytes; None where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
    elif codes[0] is not None and n < (1 << 8):
        out.append(bytes((codes[0], n)))
    elif n < (1 << 16):
        out.append(bytes((codes[1],)) + struct.pack(">H", n))
    elif n < (1 << 32):
        out.append(bytes((codes[2],)) + struct.pack(">I", n))
    else:
        raise ValueError(f"msgpack: a length of {n} does not fit in 32 bits")


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
    if fixext is not None:
        out.append(bytes((fixext, code)))
    else:
        _pack_len(n, None, 0, (0xc7, 0xc8, 0xc9), out)
        out.append(bytes((code,)))
    out.append(data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """``flax.serialization._ndarray_to_bytes``: (shape, dtype name, bytes)."""
    out = [b"\x93"]
    _pack([int(d) for d in arr.shape], out)
    _pack(_dtype_name(arr.dtype), out)
    _pack(arr.tobytes("C"), out)
    return b"".join(out)


def _pack(obj, out: list, sort: bool = True) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out.append(data)
    elif type(obj) in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (0xc4, 0xc5, 0xc6), out)
        out.append(data)
    elif type(obj) is list:
        _pack_len(len(obj), 0x90, 16, (None, 0xdc, 0xdd), out)
        for v in obj:
            _pack(v, out, sort)
    elif type(obj) is dict:
        _pack_len(len(obj), 0x80, 16, (None, 0xde, 0xdf), out)
        for k in (sorted(obj) if sort else obj):
            _pack(k, out, sort)
            _pack(obj[k], out, sort)
    else:
        raise ValueError(f"msgpack: cannot write a {type(obj).__name__}")


def _chunk(arr: np.ndarray) -> dict:
    """``flax.serialization._chunk``: flat pieces of MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    pieces = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(pieces)}}


def _chunked(tree):
    """The tree in the order flax writes it: every dict's keys sorted, then
    arrays over MAX_CHUNK_SIZE bytes chunked (whose dicts keep their order)."""
    if isinstance(tree, dict):
        return {k: _chunked(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_chunked(v) for v in tree]
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def packb(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for a tree of
    dicts, lists and numpy arrays or scalars (and Python scalars, str and
    bytes)."""
    out: list = []
    _pack(_chunked(tree), out, sort=False)
    return b"".join(out)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"msgpack: truncated input ({n} bytes wanted at offset "
                             f"{self.pos} of {len(self.data)})")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xc4])))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.unpack(">" + "BHI"[b - 0xc7])
            return self.ext(self.unpack(">b"), n)
        if b == 0xca:
            return self.unpack(">f")
        if b == 0xcb:
            return self.unpack(">d")
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xd4 <= b <= 0xd8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):
            return self.str(self.unpack(">" + "BHI"[b - 0xd9]))
        if b in (0xdc, 0xdd):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xdc else ">I"))]
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"msgpack: reserved type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack: a str that is not UTF-8 ({e})") from None

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if isinstance(k, (dict, list)):
                raise ValueError("msgpack: a map key that is a map or an array")
            out[k] = self.read()
        return out

    def ext(self, code: int, n: int):
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code} (flax's ndarray is "
                             f"{EXT_NDARRAY}, its numpy scalar {EXT_NPSCALAR})")
        arr = _ndarray(bytes(self.take(n)))
        return arr[()] if code == EXT_NPSCALAR else arr


def _ndarray(payload: bytes) -> np.ndarray:
    """``flax.serialization._ndarray_from_bytes``, as a writable copy."""
    r = _Reader(payload)
    head = r.read()
    if r.pos != len(payload) or not isinstance(head, list) or len(head) != 3:
        raise ValueError("msgpack: an ndarray payload that is not (shape, dtype, bytes)")
    shape, name, buf = head
    if isinstance(name, bytes):
        name = name.decode("utf-8", "replace")
    if not isinstance(name, str) or name not in DTYPES:
        raise ValueError(f"msgpack: unsupported array dtype {name!r} "
                         f"(supported: {', '.join(DTYPES)})")
    if (not isinstance(shape, list) or not all(type(d) is int and d >= 0 for d in shape)
            or not isinstance(buf, bytes)):
        raise ValueError("msgpack: an ndarray payload that is not (shape, dtype, bytes)")
    dtype = np.dtype(name)
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != len(buf):
        raise ValueError(f"msgpack: an ndarray of shape {tuple(shape)} {name} holds "
                         f"{len(buf)} bytes")
    return np.frombuffer(buf, dtype=dtype, count=count).reshape(shape).copy()


def _unchunk(tree):
    """Chunked arrays back to arrays (``_unchunk_array_leaves_in_place``)."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            try:
                shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
                chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
                return np.concatenate(chunks).reshape(shape)
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"msgpack: a malformed chunked array ({e})") from None
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` reads from ``data``
    (arrays as writable numpy arrays, numpy scalars as numpy scalars)."""
    r = _Reader(bytes(data))
    try:
        tree = r.read()
    except (struct.error, RecursionError) as e:
        raise ValueError(f"msgpack: malformed input ({e})") from None
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the end of the tree")
    return _unchunk(tree)
