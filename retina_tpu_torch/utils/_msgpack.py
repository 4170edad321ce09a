"""The subset of MessagePack that the RFLT frame header and the record
frames (``plugins/framing.py``) use.

``packb`` writes what ``msgpack.packb(obj, use_bin_type=True)`` writes for
nil, bool, int (-2^63 .. 2^64 - 1, in the smallest format), float (always
float64), str, bytes, list, tuple and dict, byte for byte, so a frame
header encoded here equals the reference's. ``unpackb`` reads those
formats (and float32) back, as ``msgpack.unpackb(data, raw=False)`` does:
str as str, bin as bytes, arrays as lists, map keys only str or bytes
(any key with ``strict_map_key=False``, as msgpack's own flag), and
trailing bytes are an error. Anything else raises ``ValueError``.
"""

from __future__ import annotations

import struct


def packb(obj) -> bytes:
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
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, fix=(0xA0, 32), small=0xD9, mid=0xDA, big=0xDB)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, fix=None, small=0xC4, mid=0xC5, big=0xC6)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, fix=(0x90, 16), small=None, mid=0xDC, big=0xDD)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, fix=(0x80, 16), small=None, mid=0xDE, big=0xDF)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise ValueError(f"cannot pack {type(obj).__name__}")


def _pack_len(n: int, out: bytearray, fix, small, mid, big) -> None:
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
    elif small is not None and n < 1 << 8:
        out += bytes((small, n))
    elif n < 1 << 16:
        out += bytes((mid,)) + struct.pack(">H", n)
    elif n < 1 << 32:
        out += bytes((big,)) + struct.pack(">I", n)
    else:
        raise ValueError(f"length {n} too large")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out.append(n & 0xFF)
    elif 0x80 <= n <= 0xFF:
        out += bytes((0xCC, n))
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
        raise ValueError(f"integer {n} does not fit 64 bits")


# Fixed-width formats: first byte -> (struct format, size).
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# Length-prefixed formats: first byte -> (kind, size of the length).
_SIZED = {
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}


def unpackb(data: bytes, strict_map_key: bool = True):
    view = memoryview(data)
    obj, off = _unpack(view, 0, strict_map_key)
    if off != len(view):
        raise ValueError(f"{len(view) - off} extra bytes after the object")
    return obj


def _take(view: memoryview, off: int, n: int) -> tuple[memoryview, int]:
    if off + n > len(view):
        raise ValueError("truncated data")
    return view[off: off + n], off + n


def _unpack(view: memoryview, off: int, strict: bool = True):
    head, off = _take(view, off, 1)
    b = head[0]
    if b < 0x80:
        return b, off
    if b >= 0xE0:
        return b - 0x100, off
    if 0xA0 <= b < 0xC0:
        return _str(view, off, b & 0x1F)
    if 0x90 <= b < 0xA0:
        return _array(view, off, b & 0x0F, strict)
    if 0x80 <= b < 0x90:
        return _map(view, off, b & 0x0F, strict)
    if b == 0xC0:
        return None, off
    if b in (0xC2, 0xC3):
        return b == 0xC3, off
    if b in _FIXED:
        fmt, size = _FIXED[b]
        raw, off = _take(view, off, size)
        return struct.unpack(fmt, raw)[0], off
    if b in _SIZED:
        kind, size = _SIZED[b]
        raw, off = _take(view, off, size)
        n = int.from_bytes(raw, "big")
        if kind == "str":
            return _str(view, off, n)
        if kind == "bin":
            raw, off = _take(view, off, n)
            return bytes(raw), off
        return (_array if kind == "array" else _map)(view, off, n, strict)
    raise ValueError(f"unsupported msgpack format byte {b:#04x}")


def _str(view: memoryview, off: int, n: int):
    raw, off = _take(view, off, n)
    return bytes(raw).decode("utf-8"), off


def _array(view: memoryview, off: int, n: int, strict: bool):
    out = []
    for _ in range(n):
        x, off = _unpack(view, off, strict)
        out.append(x)
    return out, off


def _map(view: memoryview, off: int, n: int, strict: bool):
    out = {}
    for _ in range(n):
        k, off = _unpack(view, off, strict)
        if strict and not isinstance(k, (str, bytes)):
            raise ValueError(f"map key of type {type(k).__name__}")
        out[k], off = _unpack(view, off, strict)
    return out, off
