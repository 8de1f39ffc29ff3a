"""Dependency-free TensorBoard scalar writer: a copy of the JAX package's
``tpu_pillars/utils/tensorboard.py`` (pure stdlib), so that ``train.loop
--tensorboard`` writes the same event files. The JSONL logger
(``utils/logging.py``) is the primary sink; this module adds the optional
TensorBoard event file so standard dashboards can watch training runs,
with neither ``tensorboard`` nor ``tensorflow`` as a dependency.

The on-disk format is TFRecord framing around serialized `tensorflow.Event`
protos:

    record  := len:uint64le  masked_crc32c(len_bytes):uint32le
               payload[len]  masked_crc32c(payload):uint32le
    masked(c) := ((c >> 15 | c << 17) & 0xFFFFFFFF) + 0xA282EAD8  (mod 2^32)

CRC32C is the Castagnoli polynomial (reflected 0x82F63B78), table-driven in
pure Python — a few microseconds per scalar event, irrelevant next to a
training step. Only the three proto fields TensorBoard's scalar dashboard
reads are emitted (Event.wall_time/step/summary, Summary.Value.tag/
simple_value, plus the leading file_version event), hand-encoded with the
standard protobuf wire rules. `tests/test_torch_elastic.py` pins the CRC
against the published CRC-32C check value and the bytes against the JAX
package's writer.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Iterator, List, Optional, Tuple

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           scalars: Tuple[Tuple[str, float], ...] = ()) -> bytes:
    ev = bytearray(b"\x09" + struct.pack("<d", wall_time))
    if step is not None:
        ev += b"\x10" + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        ev += _field_bytes(3, file_version.encode())
    if scalars:
        summary = bytearray()
        for tag, value in scalars:
            val = (_field_bytes(1, tag.encode())
                   + b"\x15" + struct.pack("<f", value))
            summary += _field_bytes(1, val)
        ev += _field_bytes(5, bytes(summary))
    return bytes(ev)


def _frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TensorBoardWriter:
    """Same `.log(event, step=..., **fields)` shape as JsonlLogger: every
    numeric field becomes a scalar tagged `{event}/{field}` at `step`
    (events without a step count their own occurrences). Thread-safe,
    line-buffered to one `events.out.tfevents.*` file under `logdir`."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{time.time():.6f}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(logdir, fname)
        self._fh = open(self.path, "ab")
        self._lock = threading.Lock()
        self._auto_step: dict = {}
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        with self._lock:
            self._fh.write(_frame(payload))
            self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step=int(step),
                           scalars=((tag, float(value)),)))

    def log(self, event: str, **fields) -> None:
        step = fields.pop("step", None)
        if step is None:
            step = self._auto_step[event] = self._auto_step.get(event, -1) + 1
        scalars = tuple(
            (f"{event}/{k}", float(v)) for k, v in fields.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        )
        if scalars:
            self._write(_event(time.time(), step=int(step), scalars=scalars))

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TeeLogger:
    """Fan a JsonlLogger-shaped `.log()` out to several sinks (e.g. JSONL +
    TensorBoard) so `fit()` keeps a single `logger` argument."""

    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def log(self, event: str, **fields) -> None:
        for s in self.sinks:
            s.log(event, **fields)

    def close(self) -> None:
        for s in self.sinks:
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str) -> Iterator[dict]:
    """Independent TFRecord/Event parser (test oracle + offline inspection):
    yields {'wall_time', 'step', 'file_version', 'scalars': {tag: value}}
    per event, verifying both record CRCs."""
    with open(path, "rb") as fh:
        while True:
            header = fh.read(8)
            if not header:
                return
            if len(header) != 8:
                raise ValueError("truncated record header")
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", fh.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError("header CRC mismatch")
            payload = fh.read(length)
            (pcrc,) = struct.unpack("<I", fh.read(4))
            if pcrc != _masked_crc(payload):
                raise ValueError("payload CRC mismatch")
            yield _parse_event(payload)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_event(buf: bytes) -> dict:
    out = {"wall_time": None, "step": 0, "file_version": None, "scalars": {}}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
            if num == 1:
                out["wall_time"] = struct.unpack("<d", val)[0]
        elif wire == 0:
            val, pos = _read_varint(buf, pos)
            if num == 2:
                out["step"] = val
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
            if num == 3:
                out["file_version"] = val.decode()
            elif num == 5:
                out["scalars"].update(_parse_summary(val))
        elif wire == 5:
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return out


def _parse_summary(buf: bytes) -> dict:
    scalars = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire != 2:
            raise ValueError("unexpected Summary wire type")
        ln, pos = _read_varint(buf, pos)
        val = buf[pos:pos + ln]
        pos += ln
        if num == 1:
            tag, simple = None, None
            vpos = 0
            while vpos < len(val):
                vkey, vpos = _read_varint(val, vpos)
                vnum, vwire = vkey >> 3, vkey & 7
                if vwire == 2:
                    vln, vpos = _read_varint(val, vpos)
                    if vnum == 1:
                        tag = val[vpos:vpos + vln].decode()
                    vpos += vln
                elif vwire == 5:
                    if vnum == 2:
                        simple = struct.unpack("<f",
                                               val[vpos:vpos + 4])[0]
                    vpos += 4
                elif vwire == 0:
                    _, vpos = _read_varint(val, vpos)
                elif vwire == 1:
                    vpos += 8
            if tag is not None and simple is not None:
                scalars[tag] = simple
    return scalars
