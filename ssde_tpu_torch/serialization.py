"""flax's msgpack state format without flax or msgpack (the counterpart of
``flax.serialization.msgpack_serialize`` and ``msgpack_restore``, flax 0.12,
``flax/serialization.py:249-314``), for the JAX package's ``.ckpt`` files.

The subset is what flax writes for a tree of dicts of arrays: maps with str
keys, arrays, str, bin 8/16/32, nil, bool, the int encodings and float
32/64, and two ext types:

- ext 1, an ndarray: a msgpack array (shape, dtype name, C-order buffer);
- ext 3, a numpy scalar: the same encoding, read back as a 0-d value.

A tuple of the JAX state (optax's chain) was written as a map keyed "0",
"1", ..., and optax's ``EmptyState`` as an empty map; they come back so.
The dtype name carries no byte order and flax writes the host's, so a
buffer is read as little-endian, and a big-endian array is refused on
writing. ``bfloat16`` (no numpy dtype without ml_dtypes) is widened to
float32, which is exact. flax's chunked leaves (``__msgpack_chunked_array__``,
arrays over 1 GiB) and its complex scalars (ext 2) are refused by name.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# flax splits a leaf above this many bytes into chunks (MAX_CHUNK_SIZE)
MAX_LEAF_BYTES = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"

# fixed-size items after a type byte: struct format, by type byte
_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    """One msgpack object at a time from ``data``; ``raw`` leaves str as
    bytes (flax reads the ndarray ext so, :266)."""

    def __init__(self, data, raw: bool):
        self.view = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise ValueError("msgpack data ends inside an object")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xc4])))
        if b in (0xc7, 0xc8, 0xc9):
            return self.ext(self.unpack((">B", ">H", ">I")[b - 0xc7]))
        if b in (0xd9, 0xda, 0xdb):
            return self.str(self.unpack((">B", ">H", ">I")[b - 0xd9]))
        if b in (0xdc, 0xdd):
            return self.array(self.unpack(">H" if b == 0xdc else ">I"))
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in flax's subset")

    def str(self, n: int):
        s = bytes(self.take(n))
        return s if self.raw else s.decode("utf-8")

    def array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack map key {key!r} is not a str")
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"msgpack ext type {code} is not read here (flax writes complex "
                         "scalars as ext 2; only arrays, ext 1, and numpy scalars, ext 3)")


def _dtype(name: bytes) -> np.dtype:
    try:
        return np.dtype(name.decode("ascii")).newbyteorder("<")
    except TypeError:
        raise ValueError(f"array dtype {name!r} has no numpy dtype here") from None


def _ndarray_from_bytes(data) -> np.ndarray:
    """flax's ``_ndarray_from_bytes`` (:263-268): a read-only view of ``data``."""
    reader = _Reader(data, raw=True)
    shape, name, buffer = reader.read()
    if reader.pos != len(reader.view):
        raise ValueError("trailing bytes after an ndarray's encoding")
    if name == b"bfloat16":  # the upper half of a float32, widened exactly
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=_dtype(name)).reshape(shape)


def _refuse_chunks(tree) -> None:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError("a chunked array leaf (flax's __msgpack_chunked_array__, an "
                             f"array over {MAX_LEAF_BYTES} bytes) is not read here")
        for v in tree.values():
            _refuse_chunks(v)


def msgpack_restore(data) -> Any:
    """flax's ``msgpack_restore``: the nested dicts of numpy arrays (and
    Python scalars) that ``data`` encodes."""
    reader = _Reader(data, raw=False)
    tree = reader.read()
    if reader.pos != len(reader.view):
        raise ValueError(f"{len(reader.view) - reader.pos} bytes after the msgpack object")
    _refuse_chunks(tree)
    return tree


def _head(n: int, small: Tuple[int, int], *wide: Tuple[int, str]) -> bytes:
    """A length header: the fix form (``small`` = (first byte, limit)) or the
    first of ``wide`` ((type byte, struct format)) whose width holds ``n``."""
    if small and n < small[1]:
        return bytes([small[0] | n])
    for byte, fmt in wide:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([byte]) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack object of {n} entries or bytes is too long")


def _int(x: int) -> bytes:
    if -32 <= x < 0x80:
        return struct.pack(">b", x)
    if x < 0:
        for byte, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"), (0xd3, ">q")):
            lo = -(1 << (8 * struct.calcsize(fmt) - 1))
            if x >= lo:
                return bytes([byte]) + struct.pack(fmt, x)
    else:
        for byte, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"), (0xcf, ">Q")):
            if x < 1 << (8 * struct.calcsize(fmt)):
                return bytes([byte]) + struct.pack(fmt, x)
    raise ValueError(f"integer {x} does not fit msgpack's 64 bits")


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    head = (bytes([fix[n]]) if n in fix
            else _head(n, (), (0xc7, ">B"), (0xc8, ">H"), (0xc9, ">I")))
    return head + struct.pack(">b", code) + data


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes`` (:250-259)."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not serialized")
    if arr.dtype.byteorder == ">":
        raise ValueError("a big-endian array is not serialized: flax's encoding names no "
                         "byte order")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"an array of {arr.nbytes} bytes would be chunked by flax "
                         f"(over {MAX_LEAF_BYTES}); not written here")
    out: List[bytes] = []
    _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], out)
    return b"".join(out)


def _pack(x: Any, out: List[bytes]) -> None:
    """msgpack of ``x`` as ``msgpack.packb(x, use_bin_type=True,
    strict_types=True, default=flax's _msgpack_ext_pack)`` writes it, except
    that map keys go in sorted order, as flax's ``msgpack_serialize`` sends
    the tree through ``jax.tree_util.tree_map`` first."""
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        out.append(_int(x))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is bytes:
        out.append(_head(len(x), (), (0xc4, ">B"), (0xc5, ">H"), (0xc6, ">I")))
        out.append(x)
    elif t is str:
        s = x.encode("utf-8")
        out.append(_head(len(s), (0xa0, 32), (0xd9, ">B"), (0xda, ">H"), (0xdb, ">I")))
        out.append(s)
    elif t is dict:
        out.append(_head(len(x), (0x80, 16), (0xde, ">H"), (0xdf, ">I")))
        for k in sorted(x):
            if type(k) is not str:
                raise TypeError(f"map key {k!r} is not a str")
            _pack(k, out)
            _pack(x[k], out)
    elif t is list:
        out.append(_head(len(x), (0x90, 16), (0xdc, ">H"), (0xdd, ">I")))
        for v in x:
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        out.append(_ext(_EXT_NDARRAY, _ndarray_to_bytes(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x))))
    else:
        raise TypeError(f"cannot serialize {t.__name__} (dicts with str keys, lists, "
                        "numpy arrays and scalars, str, bytes, int, float, bool, None)")


def msgpack_serialize(tree: Any) -> bytes:
    """flax's ``msgpack_serialize``: the same bytes for the same tree of
    dicts (str keys) of numpy arrays, numpy scalars and Python scalars."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)
