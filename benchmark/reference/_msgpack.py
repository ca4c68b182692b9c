# Frozen copy of overcooked_ai_tpu_torch/training/_msgpack.py at commit 594fcf2,
# its imports made relative: the benchmark's plain reference, which later
# changes to the port do not move.
"""A reader of flax's `params.msgpack` files, stdlib and numpy only.

flax's `serialization.to_bytes` writes the params tree as msgpack: nested
maps with string keys, each array leaf an ext value of type 1 (a numpy
scalar: type 3) whose payload is itself msgpack, `[shape, dtype name, raw
bytes]` in C order. `read_msgpack` decodes that subset of msgpack (maps,
arrays, strings, binaries, ext values, ints, floats, nil, booleans) and
turns the array ext values into numpy arrays.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# fixed-width headers: first byte -> (struct format of the value or length, kind)
_FIXED = {
    0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
    0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
    0xca: (">f", "value"), 0xcb: (">d", "value"),
    0xcc: (">B", "value"), 0xcd: (">H", "value"), 0xce: (">I", "value"), 0xcf: (">Q", "value"),
    0xd0: (">b", "value"), 0xd1: (">h", "value"), 0xd2: (">i", "value"), 0xd3: (">q", "value"),
    0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
    0xdc: (">H", "array"), 0xdd: (">I", "array"), 0xde: (">H", "map"), 0xdf: (">I", "map"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _decode(buf: bytes, pos: int):
    """(value, next position) of the msgpack object at `pos`."""
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        kind, n = "map", b & 0x0f
    elif 0x90 <= b <= 0x9f:
        kind, n = "array", b & 0x0f
    elif 0xa0 <= b <= 0xbf:
        kind, n = "str", b & 0x1f
    elif b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b], pos
    elif b in _FIXEXT:
        kind, n = "ext", _FIXEXT[b]
    elif b in _FIXED:
        fmt, kind = _FIXED[b]
        (n,) = struct.unpack_from(fmt, buf, pos)
        pos += struct.calcsize(fmt)
        if kind == "value":
            return n, pos
    else:
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x} at {pos - 1}")
    if kind == "str":
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "ext":
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    out = []
    for _ in range(2 * n if kind == "map" else n):
        v, pos = _decode(buf, pos)
        out.append(v)
    if kind == "map":
        return dict(zip(out[0::2], out[1::2])), pos
    return out, pos


def _ext(code: int, data: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack: unsupported ext type {code}")
    (shape, dtype, raw), _ = _decode(data, 0)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return arr[()] if code == _EXT_NPSCALAR else arr


def read_msgpack(data: bytes):
    """Decode flax-serialized msgpack bytes into nested dicts of numpy arrays."""
    value, pos = _decode(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"msgpack: {len(data) - pos} trailing bytes")
    return value
