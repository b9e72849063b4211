"""TensorBoard scalar event files, written and read with the stdlib.

The reference writes its scalars as TensorBoard events in the run's
logdir (``eksml_tpu/utils/metrics.py``, through ``flax.metrics``), and
the training chart's TensorBoard subchart serves that directory.  Here
the same files come from this module alone, so every run writes them
whatever is installed: no ``tensorboard``, ``tensorflow`` or protobuf
package is needed.

The format, as TensorBoard reads it:

- a file ``events.out.tfevents.<time>.<host>`` (TensorBoard picks up any
  file whose name holds ``tfevents``) of TFRecords: the payload's length
  as a little-endian uint64, the masked CRC32C of those 8 bytes, the
  payload, and the masked CRC32C of the payload;
- each payload a ``tensorflow.Event`` protobuf, encoded here by hand:
  ``wall_time`` (field 1, double), ``step`` (2, int64), and either
  ``file_version`` (3, the first record: ``"brain.Event:2"``) or
  ``summary`` (5) holding ``Summary.Value`` entries (1) of ``tag`` (1,
  string) and ``simple_value`` (2, float32).

:func:`read_events` checks both CRCs of every record and raises
:class:`CorruptRecordError` on a mismatch.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional

FILE_VERSION = "brain.Event:2"


def _crc32c_table() -> List[int]:
    poly = 0x82F63B78          # CRC-32C (Castagnoli), reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's mask: rotate right by 15 and add a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire format, the few fields an Event needs -----------------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1          # int64 fields encode negatives in 10 bytes
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def encode_event(wall_time: float, step: int,
                 file_version: Optional[str] = None,
                 scalars: Optional[Dict[str, float]] = None) -> bytes:
    """One ``Event``: a file-version record, or a summary of scalars."""
    out = _key(1, 1) + struct.pack("<d", float(wall_time))
    out += _key(2, 0) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode())
                         + _key(2, 5) + struct.pack("<f", float(v)))
            for tag, v in scalars.items())
        out += _bytes_field(5, summary)
    return out


def _read_varint(buf: bytes, pos: int):
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[tuple]:
    """(field, wire type, value) of a message; value is an int (varint),
    ``bytes`` (length-delimited, 64- and 32-bit)."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def decode_event(payload: bytes) -> Dict:
    """``{"wall_time", "step", "file_version"?, "scalars": {tag:
    float32 value}}`` of one ``Event``; fields other than these are
    skipped."""
    ev: Dict = {"wall_time": 0.0, "step": 0, "scalars": {}}
    for field, wire, value in _fields(payload):
        if field == 1 and wire == 1:
            ev["wall_time"] = struct.unpack("<d", value)[0]
        elif field == 2 and wire == 0:
            ev["step"] = value - (1 << 64) if value >> 63 else value
        elif field == 3 and wire == 2:
            ev["file_version"] = value.decode()
        elif field == 5 and wire == 2:
            for f, w, val in _fields(value):
                if f != 1 or w != 2:
                    continue
                tag, simple = None, None
                for vf, vw, vv in _fields(val):
                    if vf == 1 and vw == 2:
                        tag = vv.decode()
                    elif vf == 2 and vw == 5:
                        simple = struct.unpack("<f", vv)[0]
                if tag is not None and simple is not None:
                    ev["scalars"][tag] = simple
    return ev


# -- TFRecord framing ------------------------------------------------------

class CorruptRecordError(ValueError):
    """A record whose length or payload does not match its CRC, or a
    file that ends inside a record."""


def frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


def read_records(path: str) -> Iterator[bytes]:
    """The payloads of a TFRecord file, each CRC checked."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise CorruptRecordError(f"{path}: truncated header at {pos}")
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if crc != masked_crc32c(header):
            raise CorruptRecordError(f"{path}: length CRC mismatch at {pos}")
        start, end = pos + 12, pos + 12 + length
        if end + 4 > len(data):
            raise CorruptRecordError(f"{path}: truncated record at {pos}")
        payload = data[start:end]
        (crc,) = struct.unpack("<I", data[end:end + 4])
        if crc != masked_crc32c(payload):
            raise CorruptRecordError(f"{path}: payload CRC mismatch at {pos}")
        yield payload
        pos = end + 4


def read_events(path: str) -> List[Dict]:
    """Every event of one event file (:func:`decode_event`), in order."""
    return [decode_event(p) for p in read_records(path)]


def read_scalars(logdir: str) -> Dict[str, Dict[int, float]]:
    """``{tag: {step: value}}`` over every event file directly under
    ``logdir`` (files in name order, so a relaunch's later value of a
    step wins)."""
    out: Dict[str, Dict[int, float]] = {}
    for name in sorted(os.listdir(logdir)):
        if "tfevents" not in name:
            continue
        for ev in read_events(os.path.join(logdir, name)):
            for tag, v in ev["scalars"].items():
                out.setdefault(tag, {})[ev["step"]] = v
    return out


class EventFileWriter:
    """Appends scalar events to a new ``events.out.tfevents.<time>.<host>``
    file in ``logdir`` (``.<pid>`` is added when that name is taken);
    the first record is the file version."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        name = f"events.out.tfevents.{int(now):010d}.{socket.gethostname()}"
        path = os.path.join(logdir, name)
        if os.path.exists(path):
            path += f".{os.getpid()}"
        self.path = path
        self._f = open(path, "ab")
        self._f.write(frame(encode_event(now, 0,
                                         file_version=FILE_VERSION)))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float],
                    wall_time: Optional[float] = None) -> None:
        """One event holding every scalar of ``step``."""
        if not scalars:
            return
        self._f.write(frame(encode_event(
            time.time() if wall_time is None else wall_time, step,
            scalars=scalars)))
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
