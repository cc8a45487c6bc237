"""TensorBoard event files, written and read without tensorboardX.

The trainer's counterpart of ``tensorboardX.SummaryWriter``, with the two
calls the JAX trainer makes of it: ``add_scalar`` (a ``simple_value``) and
``add_image`` (a PNG ``Image`` summary, encoded by ``data/png.py``). An
event file is a sequence of TFRecords, each

    uint64 length | uint32 masked CRC-32C of length | data | uint32 masked
    CRC-32C of data

(little-endian), whose data is an ``Event`` protobuf, encoded here by hand:

    Event   { double wall_time = 1; int64 step = 2;
              string file_version = 3; Summary summary = 5; }
    Summary { repeated Value value = 1; }
    Value   { string tag = 1; float simple_value = 2; Image image = 4; }
    Image   { int32 height = 1; int32 width = 2; int32 colorspace = 3;
              bytes encoded_image_string = 4; }

The first record carries ``file_version`` "brain.Event:2", as TensorBoard
expects. :func:`read_events` parses such a file back, checking every CRC.
"""
from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from ..data.native import image_lib
from ..data.png import decode_png, encode_png

FILE_VERSION = "brain.Event:2"
_MASK_DELTA = 0xA282EAD8


def crc32c(data: bytes) -> int:
    return image_lib().crc32c(data, len(data))


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# -- protobuf wire format ----------------------------------------------------

def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1            # negative int64s as ten bytes
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _event(step: int, wall_time: float, *, summary: bytes | None = None,
           file_version: str | None = None) -> bytes:
    out = _key(1, 1) + struct.pack("<d", wall_time) + _key(2, 0) + \
        _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    return _bytes_field(1, tag.encode()) + _key(2, 5) + \
        struct.pack("<f", value)


def _image_value(tag: str, png: bytes, height: int, width: int,
                 channels: int) -> bytes:
    image = (_key(1, 0) + _varint(height) + _key(2, 0) + _varint(width)
             + _key(3, 0) + _varint(channels) + _bytes_field(4, png))
    return _bytes_field(1, tag.encode()) + _bytes_field(4, image)


def _fields(data: bytes):
    """(field number, value) of a message: an int for varints, bytes for
    the rest."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value, pos = data[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = data[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, value


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, pos


# -- the writer --------------------------------------------------------------

class SummaryWriter:
    """Append scalar and image summaries to a new event file in
    ``log_dir`` (``events.out.tfevents.<time>.<host>``). Each record is
    written and flushed at once."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}."
                     f"{socket.gethostname()}")
        self._file = open(self.path, "ab")
        self._write(_event(0, time.time(), file_version=FILE_VERSION))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._file.write(header + struct.pack("<I", masked_crc32c(header))
                         + event + struct.pack("<I", masked_crc32c(event)))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(int(step), time.time(), summary=_bytes_field(
            1, _scalar_value(tag, float(value)))))

    def add_image(self, tag: str, img: np.ndarray, step: int) -> None:
        """``img`` (3, H, W), channels first as tensorboardX's default;
        floats in [0, 1] are scaled by 255 and clipped, as tensorboardX
        does; uint8 is taken as it is."""
        img = np.asarray(img)
        if img.ndim != 3 or img.shape[0] != 3:
            raise ValueError(f"add_image takes (3, H, W), got {img.shape}")
        hwc = img.transpose(1, 2, 0)
        if hwc.dtype != np.uint8:
            hwc = (hwc.astype(np.float32) * 255.0).clip(0, 255).astype(
                np.uint8)
        height, width = hwc.shape[:2]
        self._write(_event(int(step), time.time(), summary=_bytes_field(
            1, _image_value(tag, encode_png(hwc), height, width, 3))))

    def close(self) -> None:
        self._file.close()


# -- the reader --------------------------------------------------------------

def read_records(path: str):
    """The data of every record of a TFRecord file; raises ValueError on a
    CRC that does not match or a truncated record."""
    with open(path, "rb") as f:
        blob = f.read()
    pos = 0
    while pos < len(blob):
        if pos + 12 > len(blob):
            raise ValueError(f"{path}: truncated record header at {pos}")
        header = blob[pos:pos + 8]
        n, = struct.unpack("<Q", header)
        crc, = struct.unpack("<I", blob[pos + 8:pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: length CRC mismatch at {pos}")
        data = blob[pos + 12:pos + 12 + n]
        if len(data) != n or pos + 16 + n > len(blob):
            raise ValueError(f"{path}: truncated record at {pos}")
        crc, = struct.unpack("<I", blob[pos + 12 + n:pos + 16 + n])
        if crc != masked_crc32c(data):
            raise ValueError(f"{path}: data CRC mismatch at {pos}")
        yield data
        pos += 16 + n


def read_events(path: str) -> list[dict]:
    """Every event of an event file as a dict: ``wall_time``, ``step``,
    and ``file_version`` or ``values``, a list of {"tag", and
    "simple_value" or "image": {"height", "width", "colorspace",
    "encoded_image_string"}}."""
    events = []
    for data in read_records(path):
        event = {"wall_time": 0.0, "step": 0}
        for field, value in _fields(data):
            if field == 1:
                event["wall_time"], = struct.unpack("<d", value)
            elif field == 2:
                event["step"] = value - (1 << 64) if value >> 63 else value
            elif field == 3:
                event["file_version"] = value.decode()
            elif field == 5:
                event["values"] = [_read_value(v) for f, v in
                                   _fields(value) if f == 1]
        events.append(event)
    return events


def _read_value(data: bytes) -> dict:
    out: dict = {}
    for field, value in _fields(data):
        if field == 1:
            out["tag"] = value.decode()
        elif field == 2:
            out["simple_value"], = struct.unpack("<f", value)
        elif field == 4:
            names = {1: "height", 2: "width", 3: "colorspace",
                     4: "encoded_image_string"}
            out["image"] = {names[f]: v for f, v in _fields(value)
                            if f in names}
    return out


def scalars(events: list[dict]) -> dict[str, list[tuple[int, float]]]:
    """{tag: [(step, value), ...]} of the scalar summaries in ``events``."""
    out: dict[str, list] = {}
    for event in events:
        for v in event.get("values", ()):
            if "simple_value" in v:
                out.setdefault(v["tag"], []).append(
                    (event["step"], v["simple_value"]))
    return out


def images(events: list[dict]) -> dict[str, list[tuple[int, np.ndarray]]]:
    """{tag: [(step, (H, W, 3) uint8), ...]} of the image summaries, their
    PNGs decoded."""
    out: dict[str, list] = {}
    for event in events:
        for v in event.get("values", ()):
            if "image" in v:
                out.setdefault(v["tag"], []).append(
                    (event["step"],
                     decode_png(v["image"]["encoded_image_string"])))
    return out
