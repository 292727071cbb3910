"""Torch-free TensorBoard scalar writer.

The trainer logs scalars through a SummaryWriter-shaped object, without
depending on TensorBoard's own package:

1. ``tensorboardX`` when installed (drop-in SummaryWriter, no torch), else
2. :class:`RawEventWriter` — a dependency-free writer that emits valid
   TFRecord-framed ``tf.Event`` protos (hand-encoded: the scalar-summary
   subset of the schema is three nested messages) with masked CRC32C
   framing, readable by TensorBoard and ``tensorboard.summary_iterator``.

Both expose the ``add_scalar(tag, value, step)`` / ``flush()`` / ``close()``
subset the trainer needs.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven pure Python — required by the TFRecord
# framing. Masking per TensorFlow: ((crc >> 15 | crc << 17) + 0xa282ead8).
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoding for the scalar-event subset:
#   Event   { 1: double wall_time; 2: int64 step; 5: Summary summary;
#             3: string file_version }
#   Summary { 1: repeated Value value }
#   Value   { 1: string tag; 2: float simple_value }
# ---------------------------------------------------------------------------


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


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    value_msg = _len_delim(1, tag.encode("utf-8")) + _tag(2, 5) + struct.pack(
        "<f", float(value)
    )
    summary = _len_delim(1, value_msg)
    return (
        _tag(1, 1)
        + struct.pack("<d", wall_time)
        + _tag(2, 0)
        + _varint(int(step) & 0xFFFFFFFFFFFFFFFF)
        + _len_delim(5, summary)
    )


def _encode_version_event(wall_time: float) -> bytes:
    return (
        _tag(1, 1)
        + struct.pack("<d", wall_time)
        + _len_delim(3, b"brain.Event:2")
    )


class RawEventWriter:
    """Dependency-free TensorBoard scalar event writer."""

    def __init__(self, log_dir: str):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.0"
        )
        self.path = self.log_dir / fname
        self._f = open(self.path, "wb")
        self._write_record(_encode_version_event(time.time()))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_encode_scalar_event(tag, value, step, time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def create_summary_writer(log_dir):
    """Best available torch-free SummaryWriter for ``log_dir``."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(log_dir=str(log_dir))
    except Exception:
        return RawEventWriter(str(log_dir))
