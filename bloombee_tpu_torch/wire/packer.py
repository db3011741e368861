"""The msgpack subset that wire headers use, in the standard library.

The JAX package frames its headers with `msgpack.packb(header,
use_bin_type=True)` and reads them with `msgpack.unpackb(..., raw=False)`
(bloombee_tpu/wire/rpc.py). The port packs and unpacks the same bytes
without the `msgpack` package: map, array (lists and tuples), str, bin
(bytes, bytearray, memoryview), bool, nil, int (every msgpack width, signed
and unsigned) and float (float64). `packb` is byte-identical to
`msgpack.packb(x, use_bin_type=True)` on those values: the smallest int
encoding (unsigned formats for positive ints, signed ones for negative),
str8 for 32-255 byte strings and float64 for Python floats. `unpackb`
decodes everything msgpack produces for such values, float32 too; ext
types raise.
"""

from __future__ import annotations

import struct

_PACK_D = struct.Struct(">d").pack
_UNPACK = {
    0xCA: struct.Struct(">f"), 0xCB: struct.Struct(">d"),
    0xCC: struct.Struct(">B"), 0xCD: struct.Struct(">H"),
    0xCE: struct.Struct(">I"), 0xCF: struct.Struct(">Q"),
    0xD0: struct.Struct(">b"), 0xD1: struct.Struct(">h"),
    0xD2: struct.Struct(">i"), 0xD3: struct.Struct(">q"),
}


def packb(obj) -> bytes:
    """msgpack bytes of `obj` (what `msgpack.packb(obj, use_bin_type=True)`
    returns); raises TypeError on a type outside the subset and
    OverflowError on an int outside [-2**63, 2**64)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A container or raw header: fixed form below `fix_max`, else the
    8/16/32-bit length forms in `codes` (None where msgpack has none)."""
    if n < fix_max and fix is not None:
        out.append(fix | n)
        return
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"length {n} too large for msgpack")


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
        out.append(0xCB)
        out += _PACK_D(obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += v.to_bytes(1, "big", signed=True)
    elif v > 0:
        for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < 1 << (8 * width):
                out.append(code)
                out += v.to_bytes(width, "big")
                return
        raise OverflowError("Integer value out of range")
    else:
        for code, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * width - 1)):
                out.append(code)
                out += v.to_bytes(width, "big", signed=True)
                return
        raise OverflowError("Integer value out of range")


def unpackb(data) -> object:
    """The value msgpack bytes encode (what `msgpack.unpackb(data,
    raw=False)` returns: str for str, bytes for bin, lists for arrays)."""
    buf = memoryview(data).cast("B")
    obj, off = _unpack(buf, 0)
    if off != len(buf):
        raise ValueError(f"{len(buf) - off} bytes of extra data")
    return obj


def _take(buf: memoryview, off: int, n: int) -> tuple[memoryview, int]:
    end = off + n
    if end > len(buf):
        raise ValueError("truncated msgpack data")
    return buf[off:end], end


def _length(buf: memoryview, off: int, width: int) -> tuple[int, int]:
    raw, off = _take(buf, off, width)
    return int.from_bytes(raw, "big"), off


def _unpack(buf: memoryview, off: int):
    if off >= len(buf):
        raise ValueError("truncated msgpack data")
    code = buf[off]
    off += 1
    if code < 0x80:
        return code, off
    if code >= 0xE0:
        return code - 0x100, off
    if 0xA0 <= code <= 0xBF:
        raw, off = _take(buf, off, code & 0x1F)
        return str(raw, "utf-8"), off
    if 0x90 <= code <= 0x9F:
        return _array(buf, off, code & 0x0F)
    if 0x80 <= code <= 0x8F:
        return _map(buf, off, code & 0x0F)
    if code == 0xC0:
        return None, off
    if code == 0xC2:
        return False, off
    if code == 0xC3:
        return True, off
    fmt = _UNPACK.get(code)
    if fmt is not None:
        raw, off = _take(buf, off, fmt.size)
        return fmt.unpack(raw)[0], off
    if code in (0xC4, 0xC5, 0xC6):
        n, off = _length(buf, off, 1 << (code - 0xC4))
        raw, off = _take(buf, off, n)
        return bytes(raw), off
    if code in (0xD9, 0xDA, 0xDB):
        n, off = _length(buf, off, 1 << (code - 0xD9))
        raw, off = _take(buf, off, n)
        return str(raw, "utf-8"), off
    if code in (0xDC, 0xDD):
        n, off = _length(buf, off, 2 << (code - 0xDC))
        return _array(buf, off, n)
    if code in (0xDE, 0xDF):
        n, off = _length(buf, off, 2 << (code - 0xDE))
        return _map(buf, off, n)
    raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")


def _array(buf: memoryview, off: int, n: int):
    items = []
    for _ in range(n):
        v, off = _unpack(buf, off)
        items.append(v)
    return items, off


def _map(buf: memoryview, off: int, n: int):
    out = {}
    for _ in range(n):
        k, off = _unpack(buf, off)
        v, off = _unpack(buf, off)
        out[k] = v
    return out, off
