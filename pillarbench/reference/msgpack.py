"""A msgpack reader for flax checkpoints (ints, str, bin, arrays, maps and
ext type 1, a numpy array), frozen from the port's ``weights`` module so
that the benchmark reads a checkpoint with its own code."""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode("utf-8")
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
        if b in sized:
            return bytes(self._take(self._unpack(sized[b])))
        ext = {0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if b in ext:
            n = self._unpack(ext[b])
            return self._ext(self._unpack("b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(self._unpack("b"), fixext[b])
        scalars = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self._unpack(scalars[b])
        strs = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in strs:
            return self._take(self._unpack(strs[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            n = self._unpack("H" if b == 0xDC else "I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, code: int, n: int):
        payload = self._take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(payload).read()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def load_flax_tree(path: str) -> dict:
    """A flax msgpack checkpoint -> nested dict of numpy arrays."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree
