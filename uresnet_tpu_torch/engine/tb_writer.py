"""Minimal TensorBoard event-file writer (no TensorFlow dependency).

The port's own copy of ``uresnet_tpu/engine/tb_writer.py`` (imports rewritten to
this package); tests/test_torch_data.py holds the two equal.

Capability parity (SURVEY.md §5 observability): the reference writes
`tf.summary` scalars to TensorBoard event files; this module emits the same
wire format — TFRecord framing (length + masked CRC32C) around hand-encoded
`tensorflow.Event` protos carrying classic `simple_value` scalar summaries —
so `tensorboard --logdir` reads our training curves directly.

Format notes:
  record  = u64le(len) . u32le(maskedcrc(len_bytes)) . data . u32le(maskedcrc(data))
  crc     = CRC32C (Castagnoli), masked per TFRecord: ((c >> 15 | c << 17) +
            0xa282ead8) & 0xffffffff
  Event   = 1: wall_time (double), 2: step (int64), 3: file_version (string,
            first record only), 5: Summary
  Summary = repeated 1: Value;  Value = 1: tag (string), 2: simple_value
            (float)
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

# -- CRC32C (Castagnoli), table-driven ---------------------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return ((c >> 15) | (c << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# -- protobuf primitives ------------------------------------------------------


def _varint(n: int) -> bytes:
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


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _bytes(1, tag.encode()) + _float(2, float(value))
    return _bytes(1, val)  # Summary.value (repeated field 1)


def _event(step: int, scalars: Dict[str, float] | None = None,
           file_version: str | None = None) -> bytes:
    msg = _double(1, time.time()) + _int64(2, step)
    if file_version is not None:
        msg += _bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(_scalar_summary(t, v) for t, v in scalars.items())
        msg += _bytes(5, summary)
    return msg


class TBWriter:
    """Append-only scalar event writer, one events file per instance."""

    def __init__(self, log_dir: str, *, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.{name}")
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._write_record(_event(0, file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        hdr = struct.pack("<Q", len(data))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def scalars(self, step: int, values: Dict[str, float]):
        self._write_record(_event(step, {k: float(v) for k, v in values.items()}))

    def close(self):
        self._f.close()
