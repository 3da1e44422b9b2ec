"""Structured JSONL metrics logging: one JSON record a line, each with a
wall-clock timestamp, and optionally a TensorBoard mirror of the numeric
fields (the JAX package's `MetricsLogger`).

The mirror writes a TensorBoard event file with the standard library
alone: `torch.utils.tensorboard` and tensorflow would each bring in
tensorflow, and with it JAX. An event file is a sequence of TFRecords
(a u64 length, the masked CRC32C of the length, the data, the masked
CRC32C of the data), each holding one `Event` protobuf: first
`Event{wall_time, file_version: "brain.Event:2"}`, then per logged record
`Event{wall_time, step, summary{value{tag, simple_value}}}`. `read_events`
reads such a file back, checking every CRC.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
import warnings


def _crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of TFRecord framing; zlib.crc32
    is the other polynomial."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                 # int64 fields: two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _bytes_field(num: int, data: bytes) -> bytes:
    return _field(num, 2) + _varint(len(data)) + data


def encode_event(wall_time: float, step: int | None = None,
                 file_version: str | None = None,
                 scalars: dict[str, float] | None = None) -> bytes:
    """The Event protobuf: wall_time (1, double), step (2, int64),
    file_version (3, string), summary (5) of Summary.Value{tag (1),
    simple_value (2, float)}."""
    out = _field(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _field(2, 0) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode())
                         + _field(2, 5) + struct.pack("<f", value))
            for tag, value in scalars.items())
        out += _bytes_field(5, summary)
    return out


def _record(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", _masked_crc(length)) + data
            + struct.pack("<I", _masked_crc(data)))


def _parse(data: bytes) -> list[tuple[int, int, object]]:
    """(field number, wire type, value) of one protobuf message."""
    out, i = [], 0

    def varint():
        nonlocal i
        n = shift = 0
        while True:
            b = data[i]
            i += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n

    while i < len(data):
        key = varint()
        num, wire = key >> 3, key & 7
        if wire == 0:
            v = varint()
        elif wire == 1:
            v, i = data[i:i + 8], i + 8
        elif wire == 2:
            n = varint()
            v, i = data[i:i + n], i + n
        elif wire == 5:
            v, i = data[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.append((num, wire, v))
    return out


def decode_event(data: bytes) -> dict:
    """{"wall_time", "step", "file_version", "scalars": {tag: value}} of
    an Event written by encode_event (absent fields left out)."""
    ev: dict = {}
    for num, _, v in _parse(data):
        if num == 1:
            ev["wall_time"] = struct.unpack("<d", v)[0]
        elif num == 2:
            ev["step"] = v - (1 << 64) if v >= 1 << 63 else v
        elif num == 3:
            ev["file_version"] = v.decode()
        elif num == 5:
            scalars = ev.setdefault("scalars", {})
            for _, _, value in _parse(v):
                fields = {n: x for n, _, x in _parse(value)}
                scalars[fields[1].decode()] = struct.unpack("<f",
                                                            fields[2])[0]
    return ev


def read_events(path: str) -> list[dict]:
    """The events of a TFRecord event file, each CRC checked
    (ValueError on a mismatch or a cut record)."""
    with open(path, "rb") as f:
        blob = f.read()
    events, i = [], 0
    while i < len(blob):
        if i + 12 > len(blob):
            raise ValueError(f"{path}: record header cut at byte {i}")
        length_b = blob[i:i + 8]
        (n,) = struct.unpack("<Q", length_b)
        (crc,) = struct.unpack("<I", blob[i + 8:i + 12])
        if crc != _masked_crc(length_b):
            raise ValueError(f"{path}: length CRC mismatch at byte {i}")
        data = blob[i + 12:i + 12 + n]
        tail = blob[i + 12 + n:i + 16 + n]
        if len(data) != n or len(tail) != 4:
            raise ValueError(f"{path}: record cut at byte {i}")
        if struct.unpack("<I", tail)[0] != _masked_crc(data):
            raise ValueError(f"{path}: data CRC mismatch at byte {i}")
        events.append(decode_event(data))
        i += 16 + n
    return events


class MetricsLogger:
    def __init__(self, out_dir: str, name: str = "metrics.jsonl",
                 tensorboard_dir: str = ""):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, name)
        self.tb_path = None
        if tensorboard_dir:
            path = os.path.join(
                tensorboard_dir,
                f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
            try:
                os.makedirs(tensorboard_dir, exist_ok=True)
                with open(path, "ab") as f:
                    f.write(_record(encode_event(
                        time.time(), file_version="brain.Event:2")))
                self.tb_path = path
            except OSError as e:
                warnings.warn(f"tensorboard logging disabled: {e}")

    def log(self, record: dict) -> None:
        record = dict(record)
        record.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
        if self.tb_path is not None:
            scalars = {}
            for k, v in record.items():
                if k in ("ts", "step"):
                    continue
                try:
                    scalars[k] = float(v)
                except (TypeError, ValueError):
                    continue  # non-numeric fields stay in the JSONL only
            with open(self.tb_path, "ab") as f:   # flushed as it closes
                f.write(_record(encode_event(
                    time.time(), int(record.get("step", 0)),
                    scalars=scalars)))

    def read(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]
