"""TensorBoard event files without the ``tensorboard`` package: a writer
and a reader of the format ``SummaryWriter`` writes, over the stdlib.

A file ``events.out.tfevents.<time>.<host>`` is a sequence of TFRecords:
the data's length (uint64, little-endian), the masked CRC-32C of those 8
bytes, the data, the masked CRC-32C of the data. Each record is an
``Event`` protobuf message, encoded here by hand:

- ``Event``: ``wall_time`` (1, double), ``step`` (2, varint),
  ``file_version`` (3, "brain.Event:2", the first record's) or
  ``summary`` (5);
- ``Summary``: repeated ``Value`` (1);
- ``Summary.Value``: ``tag`` (1), and ``simple_value`` (2, float) for a
  scalar or ``image`` (4) for an image;
- ``Summary.Image``: ``height`` (1), ``width`` (2), ``colorspace`` (3,
  the channel count), ``encoded_image_string`` (4, PNG bytes from
  ``utils/images.py:encode_png``).

``read_events`` reads such a file back, checking every CRC, and decodes
the fields above (others are skipped).
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .images import encode_png

FILE_VERSION = 'brain.Event:2'


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _bytes_field(number: int, data: bytes) -> bytes:
    return _field(number, 2) + _varint(len(data)) + data


def _int_field(number: int, value: int) -> bytes:
    return _field(number, 0) + _varint(int(value))


def encode_event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
                 values: Optional[List[bytes]] = None) -> bytes:
    """An ``Event`` message: ``values`` are encoded ``Summary.Value``s."""
    out = _field(1, 1) + struct.pack('<d', wall_time) + _int_field(2, step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if values is not None:
        out += _bytes_field(5, b''.join(_bytes_field(1, v) for v in values))
    return out


def scalar_value(tag: str, value: float) -> bytes:
    return _bytes_field(1, tag.encode()) + _field(2, 5) + struct.pack('<f', float(value))


def image_value(tag: str, image: np.ndarray) -> bytes:
    """A uint8 [H, W, C] image (C 1, 3 or 4) as a PNG ``Summary.Image``."""
    h, w, c = image.shape
    img = (_int_field(1, h) + _int_field(2, w) + _int_field(3, c)
           + _bytes_field(4, encode_png(image)))
    return _bytes_field(1, tag.encode()) + _bytes_field(4, img)


def frame(data: bytes) -> bytes:
    """One TFRecord."""
    length = struct.pack('<Q', len(data))
    return (length + struct.pack('<I', masked_crc(length)) + data
            + struct.pack('<I', masked_crc(data)))


class EventFileWriter:
    """Appends events to a new ``events.out.tfevents.<time>.<host>`` under
    ``log_dir``; every write is flushed."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        base = os.path.join(log_dir, f'events.out.tfevents.{int(time.time()):010d}.'
                                     f'{socket.gethostname()}')
        path, n = base, 0
        while os.path.exists(path):
            n += 1
            path = f'{base}.{n}'
        self.path = path
        self._f = open(path, 'wb')
        self._write(encode_event(time.time(), 0, file_version=FILE_VERSION))

    def _write(self, event: bytes) -> None:
        self._f.write(frame(event))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(encode_event(time.time(), step, values=[scalar_value(tag, value)]))

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        self._write(encode_event(time.time(), step, values=[image_value(tag, image)]))

    def close(self) -> None:
        self._f.close()


def records(data: bytes) -> Iterator[bytes]:
    """The TFRecords of a file's bytes; a bad CRC or a cut record raises."""
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f'event file cut at byte {pos}')
        length = data[pos:pos + 8]
        (n,) = struct.unpack('<Q', length)
        (crc,) = struct.unpack('<I', data[pos + 8:pos + 12])
        if crc != masked_crc(length):
            raise ValueError(f'bad length CRC at byte {pos}')
        body = data[pos + 12:pos + 12 + n]
        if len(body) != n or pos + 16 + n > len(data):
            raise ValueError(f'event file cut at byte {pos}')
        (crc,) = struct.unpack('<I', data[pos + 12 + n:pos + 16 + n])
        if crc != masked_crc(body):
            raise ValueError(f'bad data CRC at byte {pos}')
        yield body
        pos += 16 + n


def _read_varint(data: bytes, pos: int):
    shift = value = 0
    while True:
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def _fields(data: bytes) -> Iterator[tuple]:
    """(field number, wire type, value) of a message: varints as ints,
    fixed widths and length-delimited fields as bytes."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value, pos = data[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = data[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + n], pos + n
        else:
            raise ValueError(f'unsupported protobuf wire type {wire}')
        yield number, wire, value


def _decode_value(data: bytes) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for number, _, value in _fields(data):
        if number == 1:
            out['tag'] = value.decode()
        elif number == 2:
            out['simple_value'] = struct.unpack('<f', value)[0]
        elif number == 4:
            img = {1: 'height', 2: 'width', 3: 'colorspace', 4: 'png'}
            out['image'] = {img[n]: v for n, _, v in _fields(value) if n in img}
    return out


def decode_event(data: bytes) -> Dict[str, Any]:
    out: Dict[str, Any] = {'step': 0, 'values': []}
    for number, _, value in _fields(data):
        if number == 1:
            out['wall_time'] = struct.unpack('<d', value)[0]
        elif number == 2:
            out['step'] = value
        elif number == 3:
            out['file_version'] = value.decode()
        elif number == 5:
            out['values'] = [_decode_value(v) for n, _, v in _fields(value) if n == 1]
    return out


def read_events(path: str) -> List[Dict[str, Any]]:
    """Every event of a file, its CRCs checked: {'wall_time', 'step',
    'file_version' (the first), 'values': [{'tag', 'simple_value' |
    'image': {'height', 'width', 'colorspace', 'png'}}]}."""
    with open(path, 'rb') as f:
        return [decode_event(r) for r in records(f.read())]
