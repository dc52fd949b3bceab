"""flax's msgpack checkpoint container, read and written without flax.

``flax.serialization.msgpack_serialize`` / ``msgpack_restore`` in plain
Python and numpy, so the port reads and writes a flax checkpoint where
neither ``flax`` nor the ``msgpack`` package is installed. The bytes are
flax's own:

- the msgpack subset a checkpoint uses: maps with str keys, arrays, str,
  bin, ints, floats, bool and nil, each item written in its smallest
  encoding, as ``msgpack.packb`` does;
- flax's ext types: ``1`` an ndarray, whose payload is the msgpack of
  ``(shape, dtype name, C-order bytes)``; ``2`` a native complex, the
  msgpack of ``(real, imag)``; ``3`` a numpy scalar, an ndarray payload;
- chunked leaves: an array of more than :data:`MAX_CHUNK_SIZE` bytes is
  written as a dict holding ``'__msgpack_chunked_array__'``, its shape and
  its flat chunks, each a dict keyed ``"0"``, ``"1"``, ...;
- flax copies the tree through ``jax.tree_util.tree_map`` before writing,
  which sorts every dict's keys: :func:`serialize` sorts them too.

The outer container is written as flax writes it, with msgpack's strict
types: a tuple, a subclass of int or float, or any other object that is
neither an ndarray, a numpy scalar nor a complex raises ``TypeError``.
``bfloat16`` leaves read as ``ml_dtypes.bfloat16`` where that package is
installed, else widened to float32, which holds every bfloat16 exactly.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np

# msgpack's limit is 2**31 - 1 bytes an object; flax leaves a margin
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class ExtType(NamedTuple):
    """An ext item of a code flax does not define, kept as read."""
    code: int
    data: bytes


# -- writing ------------------------------------------------------------------

def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out.append(n & 0xFF)
    elif 0x80 <= n <= 0xFF:
        out += b"\xcc" + struct.pack(">B", n)
    elif -0x80 <= n < 0:
        out += b"\xd0" + struct.pack(">b", n)
    elif 0xFF < n <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", n)
    elif -0x8000 <= n < -0x80:
        out += b"\xd1" + struct.pack(">h", n)
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", n)
    elif -0x80000000 <= n < -0x8000:
        out += b"\xd2" + struct.pack(">i", n)
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", n)
    elif -0x8000000000000000 <= n < -0x80000000:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise OverflowError("int too big to pack")


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int,
              codes: Tuple[int, ...]) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes``; no 8-bit form where it is 0)."""
    if n < fix_max:
        out.append(fix | n)
    elif codes[0] and n <= 0xFF:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out += bytes((codes[1],)) + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += bytes((codes[2],)) + struct.pack(">I", n)
    else:
        raise ValueError(f"item of {n} bytes or entries is too large")


def _pack_bin(out: bytearray, data) -> None:
    n = len(data)
    if n <= 0xFF:
        out += bytes((0xC4, n))
    elif n <= 0xFFFF:
        out += b"\xc5" + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += b"\xc6" + struct.pack(">I", n)
    else:
        raise ValueError(f"bin of {n} bytes is too large")
    out += data


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += bytes((0xC7, n))
    elif n <= 0xFFFF:
        out += b"\xc8" + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += b"\xc9" + struct.pack(">I", n)
    else:
        raise ValueError(f"ext of {n} bytes is too large")
    out += struct.pack(">b", code)
    out += data


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")), strict=False)


def _pack(out: bytearray, obj: Any, strict: bool) -> None:
    kind = type(obj)
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif kind is int or (not strict and isinstance(obj, int)):
        _pack_int(out, int(obj))
    elif kind is float or (not strict and isinstance(obj, float)):
        out += b"\xcb" + struct.pack(">d", obj)
    elif kind in (bytes, bytearray) or (
            not strict and isinstance(obj, (bytes, bytearray))):
        _pack_bin(out, obj)
    elif kind is str or (not strict and isinstance(obj, str)):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif kind is memoryview:
        _pack_bin(out, obj.tobytes())
    elif kind is list or (not strict and isinstance(obj, (list, tuple))):
        _pack_len(out, len(obj), 0x90, 16, (0, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item, strict)
    elif kind is dict or (not strict and isinstance(obj, dict)):
        _pack_len(out, len(obj), 0x80, 16, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k, strict)
            _pack(out, v, strict)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif isinstance(obj, complex):
        _pack_ext(out, EXT_COMPLEX,
                  packb((obj.real, obj.imag), strict=False))
    else:
        raise TypeError(f"can not serialize {kind.__name__!r} object")


def packb(obj: Any, strict: bool = True) -> bytes:
    """msgpack bytes of ``obj`` (bin for bytes, str for str, as
    ``msgpack.packb(use_bin_type=True)``); ``strict`` is msgpack's
    ``strict_types`` with flax's ext hook."""
    out = bytearray()
    _pack(out, obj, strict)
    return bytes(out)


# -- reading ------------------------------------------------------------------

class _Reader:
    """One pass over a msgpack buffer. ``raw``: str items stay bytes;
    ``views``: bin items are memoryviews of the buffer (no copy)."""

    def __init__(self, data, raw: bool = False, views: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw, self.views = raw, views

    def _take(self, n: int) -> memoryview:
        start = self.pos
        if start + n > len(self.buf):
            raise ValueError("msgpack data ends inside an item")
        self.pos = start + n
        return self.buf[start:start + n]

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n: int):
        data = self._take(n)
        return bytes(data) if self.raw else str(data, "utf-8")

    def _bin(self, n: int):
        data = self._take(n)
        return data if self.views else bytes(data)

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            if type(key) not in (str, bytes):
                raise ValueError(f"{type(key).__name__} is not allowed "
                                 "for map key")
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        return _ext_unpack(code, self._take(n))

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        reader = _CODES.get(b)
        if reader is None:
            raise ValueError(f"byte 0x{b:02x} starts no msgpack item")
        return reader(self)

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise ValueError("extra data after the msgpack object")


def _sized(method: str, fmt: str):
    return lambda r: getattr(r, method)(r._unpack(fmt))


def _fixext(n: int):
    return lambda r: r._ext(n)


_CODES = {
    0xC4: _sized("_bin", ">B"), 0xC5: _sized("_bin", ">H"),
    0xC6: _sized("_bin", ">I"),
    0xC7: _sized("_ext", ">B"), 0xC8: _sized("_ext", ">H"),
    0xC9: _sized("_ext", ">I"),
    0xCA: lambda r: r._unpack(">f"), 0xCB: lambda r: r._unpack(">d"),
    0xCC: lambda r: r._unpack(">B"), 0xCD: lambda r: r._unpack(">H"),
    0xCE: lambda r: r._unpack(">I"), 0xCF: lambda r: r._unpack(">Q"),
    0xD0: lambda r: r._unpack(">b"), 0xD1: lambda r: r._unpack(">h"),
    0xD2: lambda r: r._unpack(">i"), 0xD3: lambda r: r._unpack(">q"),
    0xD4: _fixext(1), 0xD5: _fixext(2), 0xD6: _fixext(4),
    0xD7: _fixext(8), 0xD8: _fixext(16),
    0xD9: _sized("_str", ">B"), 0xDA: _sized("_str", ">H"),
    0xDB: _sized("_str", ">I"),
    0xDC: _sized("_array", ">H"), 0xDD: _sized("_array", ">I"),
    0xDE: _sized("_map", ">H"), 0xDF: _sized("_map", ">I"),
}


def unpackb(data, raw: bool = False) -> Any:
    """The one msgpack object in ``data``, flax's ext types decoded."""
    reader = _Reader(data, raw=raw)
    obj = reader.read()
    reader.done()
    return obj


def _dtype_from_name(name: bytes):
    if name == b"bfloat16":
        try:
            import ml_dtypes
        except ImportError:
            return None
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name.decode("ascii"))


def _ndarray_from_bytes(data) -> np.ndarray:
    reader = _Reader(data, raw=True, views=True)
    shape, name, buffer = reader.read()
    reader.done()
    dtype = _dtype_from_name(name)
    if dtype is None:
        # bfloat16 without ml_dtypes: its bits are the float32's top half
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape, order="C")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _ext_unpack(code: int, data: memoryview) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return ExtType(code, bytes(data))


# -- flax's chunked leaves and its tree copy ----------------------------------

def _tuple_to_dict(items) -> Dict[str, Any]:
    return {str(i): v for i, v in enumerate(items)}


def _dict_to_tuple(d: Dict[str, Any]) -> tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True, "shape": _tuple_to_dict(arr.shape),
            "chunks": _tuple_to_dict([flat[i:i + size]
                                      for i in range(0, flat.size, size)])}


def _unchunk(d: Dict[str, Any]) -> np.ndarray:
    shape = _dict_to_tuple(d["shape"])
    return np.concatenate(_dict_to_tuple(d["chunks"])).reshape(shape)


def _too_big(v) -> bool:
    return isinstance(v, np.ndarray) and v.size * v.dtype.itemsize \
        > MAX_CHUNK_SIZE


def _chunk_leaves(d):
    """flax's ``_chunk_array_leaves_in_place``: oversized arrays in dicts
    (not in lists) become their chunked dicts."""
    if isinstance(d, dict):
        for k, v in d.items():
            if _too_big(v):
                d[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_leaves(v)
    elif _too_big(d):
        return _chunk(d)
    return d


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def _sorted_copy(tree):
    """The tree as ``jax.tree_util.tree_map(lambda x: x, tree)`` rebuilds
    it: every dict with its keys sorted, lists and tuples copied."""
    if isinstance(tree, dict):
        return {k: _sorted_copy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted_copy(v) for v in tree)
    return tree


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    return packb(_chunk_leaves(_sorted_copy(tree)))


def restore(data) -> Any:
    """``flax.serialization.msgpack_restore(data)``: ndarray leaves are
    read-only views of ``data``."""
    return _unchunk_leaves(unpackb(data))
