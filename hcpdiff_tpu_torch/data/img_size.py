"""Header-only image dimension probing (no pixel decode); a copy of
``hcpdiff_tpu/data/img_size.py``.

Bucket building must size thousands of images quickly; decoding them is
wasteful (reference hcpdiff/utils/img_size_tool.py:32-247 exists for the
same reason). This is an independent implementation of the standard header
layouts: PNG, JPEG, GIF, BMP, WEBP (VP8/VP8L/VP8X), ICO, TIFF.
A file no probe recognises raises: the port reads no other format (and
decodes PNG, JPEG, GIF and BMP, ``utils/images.py:decode_image``).
"""
from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

types_support = ('png', 'jpg', 'jpeg', 'gif', 'bmp', 'webp', 'ico', 'tif', 'tiff')


def _png(f) -> Optional[Tuple[int, int]]:
    head = f.read(24)
    if len(head) < 24 or head[:8] != b'\x89PNG\r\n\x1a\n':
        return None
    if head[12:16] == b'IHDR':
        w, h = struct.unpack('>II', head[16:24])
        return w, h
    return None


def _gif(f) -> Optional[Tuple[int, int]]:
    head = f.read(10)
    if head[:6] not in (b'GIF87a', b'GIF89a'):
        return None
    w, h = struct.unpack('<HH', head[6:10])
    return w, h


def _bmp(f) -> Optional[Tuple[int, int]]:
    head = f.read(26)
    if head[:2] != b'BM':
        return None
    hsize = struct.unpack('<I', head[14:18])[0]
    if hsize == 12:
        w, h = struct.unpack('<HH', head[18:22])
    else:
        w, h = struct.unpack('<ii', head[18:26])
    return w, abs(h)


def _jpeg(f) -> Optional[Tuple[int, int]]:
    if f.read(2) != b'\xff\xd8':
        return None
    while True:
        b = f.read(1)
        if not b:
            return None
        if b != b'\xff':
            continue
        marker = f.read(1)
        while marker == b'\xff':
            marker = f.read(1)
        m = marker[0]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):  # SOFn
            f.read(3)  # length + precision
            h, w = struct.unpack('>HH', f.read(4))
            return w, h
        if m in (0xD8, 0xD9) or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        ln = struct.unpack('>H', f.read(2))[0]
        f.seek(ln - 2, os.SEEK_CUR)


def _webp(f) -> Optional[Tuple[int, int]]:
    head = f.read(30)
    if head[:4] != b'RIFF' or head[8:12] != b'WEBP':
        return None
    fmt = head[12:16]
    if fmt == b'VP8 ':
        w, h = struct.unpack('<HH', head[26:30])
        return w & 0x3FFF, h & 0x3FFF
    if fmt == b'VP8L':
        bits = struct.unpack('<I', head[21:25])[0]
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if fmt == b'VP8X':
        w = int.from_bytes(head[24:27], 'little') + 1
        h = int.from_bytes(head[27:30], 'little') + 1
        return w, h
    return None


def _ico(f) -> Optional[Tuple[int, int]]:
    head = f.read(8)
    if head[:4] != b'\x00\x00\x01\x00':
        return None
    w, h = head[6], head[7]
    return (w or 256), (h or 256)


def _tiff(f) -> Optional[Tuple[int, int]]:
    head = f.read(8)
    if head[:2] not in (b'II', b'MM'):
        return None
    end = '<' if head[:2] == b'II' else '>'
    ifd_off = struct.unpack(end + 'I', head[4:8])[0]
    f.seek(ifd_off)
    n = struct.unpack(end + 'H', f.read(2))[0]
    w = h = None
    for _ in range(n):
        entry = f.read(12)
        tag, typ = struct.unpack(end + 'HH', entry[:4])
        if typ == 3:
            val = struct.unpack(end + 'H', entry[8:10])[0]
        elif typ == 4:
            val = struct.unpack(end + 'I', entry[8:12])[0]
        else:
            continue
        if tag == 256:
            w = val
        elif tag == 257:
            h = val
        if w and h:
            return w, h
    return None


_PROBES = (_png, _jpeg, _webp, _gif, _bmp, _ico, _tiff)


def get_image_size(path: str) -> Tuple[int, int]:
    """Return (width, height) by header parsing."""
    for probe in _PROBES:
        try:
            with open(path, 'rb') as f:
                res = probe(f)
            if res and res[0] > 0 and res[1] > 0:
                return int(res[0]), int(res[1])
        except Exception:
            continue
    raise ValueError(f'{path}: not an image whose size the port can read (it reads PNG, '
                     f'JPEG, GIF and BMP files; the header probes know {", ".join(types_support)})')
