"""A minimal MessagePack encoder and decoder for checkpoint manifests.

The machines the port runs on need not have the ``msgpack`` package, and a
checkpoint's ``manifest.msgpack`` must be byte-compatible with the one the
reference writes through it. This covers the subset a manifest uses: maps,
arrays (lists and tuples), strings, integers, floats, booleans and nil,
each packed in its smallest form as ``msgpack.packb`` does with its
defaults (strings as str8/16/32, floats as float64); ``unpackb`` returns
lists for arrays and ``str`` for strings, as ``msgpack.unpackb`` does, and
also reads float32 items.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int,
              codes: Tuple) -> None:
    """A length: in the fix byte up to ``fix_max``, else after one of
    ``codes`` (8-, 16-, 32-bit length; None where there is no 8-bit
    form)."""
    if n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"length {n} too large")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif 0 <= n <= 0xFF:
        out += bytes((0xCC, n))
    elif -0x80 <= n < 0:
        out.append(0xD0)
        out += struct.pack(">b", n)
    elif 0 <= n <= 0xFFFF:
        out.append(0xCD)
        out += struct.pack(">H", n)
    elif -0x8000 <= n < 0:
        out.append(0xD1)
        out += struct.pack(">h", n)
    elif 0 <= n <= 0xFFFFFFFF:
        out.append(0xCE)
        out += struct.pack(">I", n)
    elif -0x80000000 <= n < 0:
        out.append(0xD2)
        out += struct.pack(">i", n)
    elif 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        out.append(0xCF)
        out += struct.pack(">Q", n)
    elif -0x8000000000000000 <= n < 0:
        out.append(0xD3)
        out += struct.pack(">q", n)
    else:
        raise OverflowError(f"integer {n} does not fit 64 bits")


# fixed-width items: code -> (struct format, size)
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1),
          0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
          0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4),
          0xD3: (">q", 8)}
# code -> (kind, struct format of the length)
_SIZED = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def unpackb(data: bytes) -> Any:
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes left after the object")
    return obj


def _unpack(buf: memoryview, pos: int):
    code = buf[pos]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
    else:
        raise ValueError(f"MessagePack type 0x{code:02x} not supported")
    if kind == "str":
        raw = bytes(buf[pos:pos + n])
        if len(raw) != n:
            raise ValueError("truncated MessagePack data")
        return raw.decode("utf-8"), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos
