"""Read flax ``.msgpack`` parameter files with numpy alone.

The JAX package's ``cli.train_vocoder`` writes ``flax.serialization.
to_bytes(gen_params)``: a msgpack map of str keys whose array leaves are
msgpack ext type 1, holding a packed ``(shape, dtype name, C-order bytes)``
triple (ext type 3 is a numpy scalar, packed the same way).  This module
decodes that subset of msgpack (maps, arrays, str, bin, ints, floats, nil,
bools and those two ext types) and returns ``{"params/<path>": array}``,
the form ``weights.*_rules`` take.  A leaf that flax split into chunks
(arrays above 2³⁰ bytes, ``__msgpack_chunked_array__``) raises; no vocoder
has one.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",       # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}       # str
        if b in sized:
            raw = self.take(self.unpack(sized[b]))
            return bytes(raw) if b <= 0xC6 else str(raw, "utf-8")
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H",
                                         0xC9: ">I"}[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        inner = _Reader(data)
        shape, dtype, buf = inner.value()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        if dtype == "bfloat16":
            # numpy has no bfloat16: widen its bits to float32
            bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(buf, np.dtype(dtype)).copy()
        arr = arr.reshape(tuple(shape))
        return arr[()] if code == EXT_NPSCALAR else arr


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            raise ValueError(f"leaf {prefix!r} was chunked by flax (over "
                             "2**30 bytes): chunked arrays are not read")
        for key, value in tree.items():
            _flatten(value, f"{prefix}/{key}", out)
    else:
        out[prefix] = np.asarray(tree)


def read_flax_msgpack(data: bytes) -> dict[str, np.ndarray]:
    """``flax.serialization.to_bytes`` of a parameter tree →
    ``{"params/a/b/kernel": array}``."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack value")
    if not isinstance(tree, dict):
        raise ValueError("a flax parameter file holds a map at its top")
    out: dict[str, np.ndarray] = {}
    _flatten(tree, "params", out)
    return out
