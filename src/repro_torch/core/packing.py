"""MessagePack encoding and decoding for the index's durable records.

The transaction log, the static run footers and the content payloads are
MessagePack documents.  This module writes and reads the subset of the
format they use, in plain Python:

  None, bool, int (signed to -2**63, unsigned to 2**64 - 1), float (float64;
  float32 is read), str, bytes (also bytearray and memoryview), list and
  tuple (read back as lists), dict (keys of any of these types).

Every value takes the shortest encoding the format allows, and strings and
bytes keep distinct types (``str8``/``bin`` families), so ``packb(obj)`` is
byte for byte what ``msgpack.packb(obj, use_bin_type=True)`` writes, and
``unpackb(b)`` gives what ``msgpack.unpackb(b, raw=False,
strict_map_key=False)`` gives.  Extension types and timestamps are refused.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


class PackingError(ValueError):
    """A value outside the supported subset, or malformed input bytes."""


def _pack_int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 0x80:
        out.append(_B.pack(n))
    elif -0x20 <= n < 0:
        out.append(_b.pack(n))
    elif 0 <= n <= 0xFF:
        out.append(b"\xcc" + _B.pack(n))
    elif -0x80 <= n < 0:
        out.append(b"\xd0" + _b.pack(n))
    elif 0 <= n <= 0xFFFF:
        out.append(b"\xcd" + _H.pack(n))
    elif -0x8000 <= n < 0:
        out.append(b"\xd1" + _h.pack(n))
    elif 0 <= n <= 0xFFFFFFFF:
        out.append(b"\xce" + _I.pack(n))
    elif -0x80000000 <= n < 0:
        out.append(b"\xd2" + _i.pack(n))
    elif 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + _Q.pack(n))
    elif -0x8000000000000000 <= n < 0:
        out.append(b"\xd3" + _q.pack(n))
    else:
        raise OverflowError("int too big to pack")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[bytes, ...],
              out: List[bytes]) -> None:
    """A length header: the fix form when ``n <= fix_max``, else the
    8/16/32-bit form (``codes`` lists them, shortest first; a None code
    means the family has no such form)."""
    if n <= fix_max:
        out.append(_B.pack(fix | n))
        return
    for code, st in zip(codes, (_B, _H, _I)):
        if code is not None and n <= (1 << (8 * st.size)) - 1:
            out.append(code + st.pack(n))
            return
    raise PackingError(f"length {n} too long to pack")


_BYTE = [bytes((i,)) for i in range(256)]


def _pack(obj: Any, out: List[bytes]) -> None:
    t = type(obj)
    # the record types first, by exact type (bool is not int here)
    if t is str:
        raw = obj.encode("utf-8")
        if len(raw) <= 31:
            out.append(_BYTE[0xA0 | len(raw)])
        else:
            _pack_len(len(raw), 0xA0, 31, (b"\xd9", b"\xda", b"\xdb"), out)
        out.append(raw)
    elif t is int:
        if 0 <= obj < 0x80:
            out.append(_BYTE[obj])
        else:
            _pack_int(obj, out)
    elif t is dict:
        _pack_len(len(obj), 0x80, 15, (None, b"\xde", b"\xdf"), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is list or t is tuple:
        _pack_len(len(obj), 0x90, 15, (None, b"\xdc", b"\xdd"), out)
        for v in obj:
            _pack(v, out)
    elif obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d.pack(obj))
    elif isinstance(obj, str):
        _pack(str(obj), out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        for code, st in ((b"\xc4", _B), (b"\xc5", _H), (b"\xc6", _I)):
            if n <= (1 << (8 * st.size)) - 1:
                out.append(code + st.pack(n))
                break
        else:
            raise PackingError(f"bytes of {n} too long to pack")
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack(list(obj), out)
    elif isinstance(obj, dict):
        _pack(dict(obj), out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """Encode ``obj``; the bytes ``msgpack.packb(obj, use_bin_type=True)``
    would give."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise PackingError("unexpected end of data")
        b = self.buf[self.pos:end]
        self.pos = end
        return b

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


# fixed-width scalars: code -> struct
_SCALARS = {0xcc: _B, 0xcd: _H, 0xce: _I, 0xcf: _Q,
            0xd0: _b, 0xd1: _h, 0xd2: _i, 0xd3: _q,
            0xca: _f, 0xcb: _d}
# length-prefixed families: code -> (kind, length struct)
_SIZED = {0xd9: ("str", _B), 0xda: ("str", _H), 0xdb: ("str", _I),
          0xc4: ("bin", _B), 0xc5: ("bin", _H), 0xc6: ("bin", _I),
          0xdc: ("array", _H), 0xdd: ("array", _I),
          0xde: ("map", _H), 0xdf: ("map", _I)}


def _unpack(r: _Reader) -> Any:
    c = r.unpack(_B)
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0xA0 <= c <= 0xBF:
        kind, n = "str", c & 0x1F
    elif 0x90 <= c <= 0x9F:
        kind, n = "array", c & 0x0F
    elif 0x80 <= c <= 0x8F:
        kind, n = "map", c & 0x0F
    elif c == 0xC0:
        return None
    elif c == 0xC2:
        return False
    elif c == 0xC3:
        return True
    elif c in _SCALARS:
        return r.unpack(_SCALARS[c])
    elif c in _SIZED:
        kind, st = _SIZED[c]
        n = r.unpack(st)
    else:
        raise PackingError(f"unsupported type code 0x{c:02x}")
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "bin":
        return r.take(n)
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if isinstance(k, list):
            raise PackingError("list is not allowed for map key")
        out[k] = _unpack(r)
    return out


def unpackb(data) -> Any:
    """Decode one document; what ``msgpack.unpackb(data, raw=False,
    strict_map_key=False)`` would give.  Trailing bytes are an error."""
    r = _Reader(bytes(data))
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise PackingError("extra data after the document")
    return obj
