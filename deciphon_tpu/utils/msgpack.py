"""MessagePack codec: the subset of msgpack-python's API the db formats use.

``packb`` picks the same (smallest) encoding msgpack-python does with
``use_bin_type=True``, so .dtp / .dcp bytes are identical to the ones it
writes.  ``unpackb`` and the streaming ``Unpacker`` decode the full
format; maps come back as dicts, arrays as lists, bin as bytes, str as
str and unknown extension types as ``ExtType``.  Keyword arguments of
msgpack-python that only tune its buffer limits are accepted and ignored.
"""

from __future__ import annotations

import struct
from typing import NamedTuple


class ExtType(NamedTuple):
    """An extension value: type ``code`` and raw ``data``."""

    code: int
    data: bytes


class OutOfData(ValueError):
    """The buffer ended inside a value."""


class ExtraData(ValueError):
    """Bytes remain after the one value ``unpackb`` decoded."""


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        else:
            _pack_len(n, out, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, ExtType):
        _pack_ext(obj, out)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        else:
            _pack_len(n, out, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        else:
            _pack_len(n, out, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError("int too big to pack")
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError("int too small to pack")


def _pack_len(n: int, out: bytearray, codes) -> None:
    c8, c16, c32 = codes
    if c8 is not None and n < 1 << 8:
        out += bytes([c8, n])
    elif n < 1 << 16:
        out += bytes([c16]) + struct.pack(">H", n)
    elif n < 1 << 32:
        out += bytes([c32]) + struct.pack(">I", n)
    else:
        raise ValueError("object too large to pack")


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(ext: ExtType, out: bytearray) -> None:
    code, data = int(ext.code), bytes(ext.data)
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _pack_len(n, out, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def packb(obj, use_bin_type: bool = True) -> bytes:
    """Serialize ``obj``; str packs as str and bytes as bin either way."""
    del use_bin_type
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# fixed-size headers: code -> (struct format, kind)
_FIXED = {
    0xCC: (">B", "int"), 0xCD: (">H", "int"), 0xCE: (">I", "int"),
    0xCF: (">Q", "int"), 0xD0: (">b", "int"), 0xD1: (">h", "int"),
    0xD2: (">i", "int"), 0xD3: (">q", "int"), 0xCA: (">f", "float"),
    0xCB: (">d", "float"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


class Unpacker:
    """Streaming decoder over a file object or ``feed``-ed bytes."""

    def __init__(self, file_like=None, raw: bool = False, **_limits):
        self._file = file_like
        self._raw = raw
        self._buf = bytearray()
        self._pos = 0

    def feed(self, data: bytes) -> None:
        self._buf += data

    def _take(self, n: int) -> bytes:
        while len(self._buf) - self._pos < n:
            chunk = self._file.read(max(n, 1 << 16)) if self._file else b""
            if not chunk:
                raise OutOfData("buffer ended inside a value")
            del self._buf[: self._pos]
            self._pos = 0
            self._buf += chunk
        out = bytes(self._buf[self._pos : self._pos + n])
        self._pos += n
        return out

    def _header(self):
        """(kind, value-or-length) of the next value's header."""
        c = self._take(1)[0]
        if c <= 0x7F:
            return "int", c
        if c >= 0xE0:
            return "int", c - 0x100
        if 0x80 <= c <= 0x8F:
            return "map", c & 0x0F
        if 0x90 <= c <= 0x9F:
            return "array", c & 0x0F
        if 0xA0 <= c <= 0xBF:
            return "str", c & 0x1F
        if c == 0xC0:
            return "nil", None
        if c in (0xC2, 0xC3):
            return "bool", c == 0xC3
        if c in _FIXEXT_LEN:
            return "ext", _FIXEXT_LEN[c]
        if c not in _FIXED:
            raise ValueError(f"invalid MessagePack byte 0x{c:02x}")
        fmt, kind = _FIXED[c]
        (v,) = struct.unpack(fmt, self._take(struct.calcsize(fmt)))
        return kind, v

    def read_map_header(self) -> int:
        kind, n = self._header()
        if kind != "map":
            raise ValueError(f"expected a map, found {kind}")
        return n

    def unpack(self):
        kind, v = self._header()
        if kind in ("int", "float", "nil", "bool"):
            return v
        if kind == "str":
            data = self._take(v)
            return data if self._raw else data.decode("utf-8")
        if kind == "bin":
            return self._take(v)
        if kind == "array":
            return [self.unpack() for _ in range(v)]
        if kind == "map":
            out = {}
            for _ in range(v):
                key = self.unpack()
                out[key] = self.unpack()
            return out
        (code,) = struct.unpack(">b", self._take(1))
        return ExtType(code, self._take(v))

    def skip(self) -> None:
        self.unpack()

    def tell_remaining(self) -> int:
        return len(self._buf) - self._pos


def unpackb(data: bytes, raw: bool = False, **_limits):
    """Decode exactly one value from ``data``."""
    u = Unpacker(raw=raw)
    u.feed(data)
    obj = u.unpack()
    if u.tell_remaining():
        raise ExtraData("unpack(b) received extra data")
    return obj
