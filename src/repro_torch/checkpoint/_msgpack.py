"""A minimal MessagePack encoder and decoder for checkpoint manifests.

The reference writes its manifests with ``msgpack.packb`` and reads them with
``msgpack.unpackb``; the port has no ``msgpack`` package to rely on, so this
module speaks the subset a manifest holds: maps, arrays (lists and tuples),
str, bytes, int (64-bit), float (as float64), bool and None.  :func:`packb`
gives the bytes ``msgpack.packb`` gives for those values (the smallest
encoding of each int, str and container; floats as float64); :func:`unpackb`
reads them back, float32 included, with lists for arrays and str for
strings, as ``msgpack.unpackb`` does by default.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

__all__ = ["packb", "unpackb"]


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int, codes: Tuple[int, ...],
              widths=(">B", ">H", ">I")) -> None:
    """The header of a str, bytes, array or map of ``n`` items: a fix form
    below ``fix_max`` (where the type has one), else the smallest of the
    8-, 16- or 32-bit length codes (``codes``, None where absent)."""
    if fix_max and n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, widths, (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} too large")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} too small")


def _pack(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True:
        out.append(0xC3)
    elif v is False:
        out.append(0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(v, (bytes, bytearray)):
        _pack_len(out, len(v), 0, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for key, item in v.items():
            _pack(out, key)
            _pack(out, item)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(v).__name__} {v!r}")


def packb(value: Any) -> bytes:
    """``value`` as MessagePack bytes."""
    out = bytearray()
    _pack(out, value)
    return bytes(out)


# first byte -> (struct format, size) of a fixed-width scalar
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# first byte -> (kind, struct format of the length)
_SIZED = {
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        chunk = self.buf[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            fmt, size = _SCALARS[b]
            return struct.unpack(fmt, self.take(size))[0]
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "array":
                return [self.read() for _ in range(n)]
            return self._map(n)
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack: map key {key!r} is not a str")
            out[key] = self.read()
        return out


def unpackb(data: bytes) -> Any:
    """The value MessagePack ``data`` encodes (one object, nothing after)."""
    reader = _Reader(bytes(data))
    value = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: extra data after the object")
    return value
