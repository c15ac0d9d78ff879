"""WebP reading as Pillow's ``Image.open`` gives it (``WebPImagePlugin``
over libwebp's ``WebPAnimDecoder``), without Pillow: the RIFF container and
the frame layout here, the three codings in C++ (``csrc/webp_decode.cpp``
through ``utils/native.py``).

- The simple layouts: one 'VP8 ' chunk (lossy, 'RGB') or one 'VP8L' chunk
  (lossless, 'RGBA' where its header's alpha bit is set, else 'RGB').
- VP8X: 'ALPH' (raw or VP8L-coded, any filter; its pre-processing bits
  ignored, as libwebp's decoder ignores them) beside a 'VP8 ' chunk;
  'ICCP', 'EXIF', 'XMP ' and unknown chunks skipped. The mode is 'RGBA'
  where the VP8X flags carry the alpha bit, else 'RGB'.
- Animation ('ANIM' + 'ANMF'): the first frame as ``WebPAnimDecoder``
  composes it, a key frame: the canvas cleared to transparent black, the
  frame's pixels written at its offset.

``decode_webp`` returns ``(pixels, mode)``: uint8 [H, W, 3] or [H, W, 4].
Corrupt or cut data raises a ``ValueError`` naming the file.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from . import native

ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02


def riff_chunks(data: bytes, where: str) -> List[Tuple[bytes, bytes]]:
    """(fourcc, payload) of each chunk of ``data``, odd sizes padded."""
    out, pos = [], 0
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f'{where}: a truncated chunk header at {pos}')
        kind, size = data[pos:pos + 4], struct.unpack('<I', data[pos + 4:pos + 8])[0]
        if pos + 8 + size > len(data):
            raise ValueError(f'{where}: chunk {kind!r} runs past the end')
        out.append((kind, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + size % 2
    return out


def _u24(b: bytes) -> int:
    return int.from_bytes(b, 'little')


def vp8_size(payload: bytes, path: str) -> Tuple[int, int]:
    if len(payload) < 10 or payload[3:6] != b'\x9d\x01\x2a':
        raise ValueError(f'{path}: a VP8 chunk without a key frame header')
    w, h = struct.unpack('<HH', payload[6:10])
    return w & 0x3FFF, h & 0x3FFF


def vp8l_header(payload: bytes, path: str) -> Tuple[int, int, bool]:
    """(width, height, the alpha hint) of a VP8L bitstream."""
    if len(payload) < 5 or payload[0] != 0x2F:
        raise ValueError(f'{path}: a VP8L chunk without its signature')
    bits = int.from_bytes(payload[1:5], 'little')
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


def frame_rgba(chunks, path: str, size=None) -> np.ndarray:
    """RGBA [h, w, 4] of a frame's chunks: an optional ALPH, then 'VP8 ' or
    'VP8L' (others skipped)."""
    alph = None
    for kind, payload in chunks:
        if kind == b'ALPH' and alph is None:
            alph = payload
        elif kind in (b'VP8 ', b'VP8L'):
            break
    else:
        raise ValueError(f'{path}: a WebP frame without a VP8 or VP8L chunk')
    try:
        if kind == b'VP8L':
            w, h, _ = vp8l_header(payload, path)
            rgba = native.vp8l_decode(payload, w, h)
        else:
            w, h = vp8_size(payload, path)
            rgba = native.vp8_decode(payload, w, h)
            if alph is not None:
                rgba[:, :, 3] = native.alpha_decode(alph, w, h)
    except ValueError as e:
        raise ValueError(f'{path}: {e}') from e
    if size is not None and (w, h) != size:
        raise ValueError(f'{path}: a {w}x{h} WebP frame in a {size[0]}x{size[1]} slot')
    return rgba


def decode_webp(data: bytes, path: str = 'WebP data') -> Tuple[np.ndarray, str]:
    """Any WebP Pillow opens -> (pixels, mode) as it opens it."""
    if data[:4] != b'RIFF' or data[8:12] != b'WEBP':
        raise ValueError(f'{path}: not a RIFF WEBP file')
    riff_size = struct.unpack('<I', data[4:8])[0]
    if riff_size < 12 or riff_size + 8 > len(data):
        raise ValueError(f'{path}: the RIFF size {riff_size} runs past the file '
                         f'({len(data)} bytes)')
    chunks = riff_chunks(data[12:8 + riff_size], path)
    if not chunks:
        raise ValueError(f'{path}: a WebP file without chunks')
    kind, payload = chunks[0]
    if kind == b'VP8 ':
        return frame_rgba(chunks[:1], path)[:, :, :3].copy(), 'RGB'
    if kind == b'VP8L':
        rgba = frame_rgba(chunks[:1], path)
        return (rgba, 'RGBA') if vp8l_header(payload, path)[2] else (rgba[:, :, :3].copy(), 'RGB')
    if kind != b'VP8X' or len(payload) < 10:
        raise ValueError(f'{path}: a WebP file whose first chunk is {kind!r}')
    flags = payload[0]
    canvas = (_u24(payload[4:7]) + 1, _u24(payload[7:10]) + 1)
    mode = 'RGBA' if flags & ALPHA_FLAG else 'RGB'
    if flags & ANIMATION_FLAG:
        frames = [p for k, p in chunks if k == b'ANMF']
        if not frames or len(frames[0]) < 16:
            raise ValueError(f'{path}: an animated WebP without a frame')
        head = frames[0]
        x0, y0 = 2 * _u24(head[0:3]), 2 * _u24(head[3:6])
        fw, fh = _u24(head[6:9]) + 1, _u24(head[9:12]) + 1
        if x0 + fw > canvas[0] or y0 + fh > canvas[1]:
            raise ValueError(f'{path}: a WebP frame past its canvas')
        rgba = np.zeros((canvas[1], canvas[0], 4), np.uint8)
        rgba[y0:y0 + fh, x0:x0 + fw] = frame_rgba(riff_chunks(head[16:], path), path, (fw, fh))
    else:
        rgba = frame_rgba(chunks[1:], path, canvas)
    return (rgba, mode) if mode == 'RGBA' else (rgba[:, :, :3].copy(), mode)
