"""GIF and BMP decoding as Pillow's ``Image.open`` gives them (its
``GifImagePlugin`` and ``BmpImagePlugin``), in Python over the C++ loops of
``csrc/image_decode.cpp`` (GIF's LZW, BMP's RLE8/RLE4) through
``utils/native.py``. Each returns ``(pixels, mode, palette)``: pixels as
``np.asarray(Image.open(f))`` gives them, Pillow's mode, and for mode 'P' the
palette as uint8 [256, 4] RGBA (entries the file does not define black,
the transparency in the alpha).

- GIF: the first frame, on a canvas of the logical screen (grown to the
  frame where the frame reaches past it), filled with the transparent index
  (or 0) outside the frame; interlaced rows reordered. Mode 'P' with the
  frame's palette (local, else global), or 'L' where that palette is the
  identity grey ramp or there is none, as Pillow decides.
- BMP: the 12-byte core header and the 40/52/56/64/108/124-byte info
  headers; 1/4/8-bit palettes ('P', or '1'/'L' where the palette is
  Pillow's black-white or grey ramp), 16-bit 555 and bitfields 565/555,
  24 and 32 bits (BI_RGB 32-bit is RGB, the alpha byte ignored; a
  BI_BITFIELDS layout Pillow names with an alpha is RGBA), top-down and
  bottom-up rows, RLE8 and RLE4.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from . import native

Image = Tuple[np.ndarray, str, Optional[np.ndarray]]   # pixels, mode, palette


def palette_rgba(rgb: bytes, step: int = 3, order: str = 'RGB') -> np.ndarray:
    """uint8 [256, 4]: the entries of ``rgb`` (``step`` bytes each, channels
    in ``order``), the rest black, alpha 255."""
    out = np.zeros((256, 4), np.uint8)
    out[:, 3] = 255
    n = min(len(rgb) // step, 256)
    raw = np.frombuffer(rgb[:n * step], np.uint8).reshape(n, step)
    for k, ch in enumerate(order):
        out[:n, 'RGB'.index(ch)] = raw[:, k]
    return out


# ------------------------------------------------------------------- GIF

def _sub_blocks(data: bytes, pos: int, path: str) -> Tuple[bytes, int]:
    """The data of the sub-blocks from ``pos`` joined, and the position
    after their terminator."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError(f'{path}: GIF data ends inside a block')
        n = data[pos]
        pos += 1
        if n == 0:
            return b''.join(parts), pos
        parts.append(data[pos:pos + n])
        pos += n


def _grey_ramp(p: bytes) -> bool:
    """GifImagePlugin._is_palette_needed, negated."""
    return all(p[i] == p[i + 1] == p[i + 2] == i // 3 for i in range(0, len(p) - 2, 3))


def decode_gif(data: bytes, path: str) -> Image:
    if data[:6] not in (b'GIF87a', b'GIF89a') or len(data) < 13:
        raise ValueError(f'{path} is not a GIF file')
    width, height = struct.unpack('<HH', data[6:10])
    flags = data[10]
    pos = 13
    palette = None                      # None: no palette; b'': the grey ramp
    if flags & 128:
        p = data[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(p)
        palette = b'' if _grey_ramp(p) else p
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError(f'{path}: no image in the GIF file')
        kind = data[pos]
        pos += 1
        if kind == 0x21:                # extension
            label = data[pos]
            block, pos = _sub_blocks(data, pos + 1, path)
            if label == 0xF9 and block and block[0] & 1 and len(block) >= 4:
                transparency = block[3]
        elif kind == 0x2C:              # image descriptor
            x0, y0, w, h, iflags = struct.unpack('<HHHHB', data[pos:pos + 9])
            pos += 9
            if iflags & 128:
                p = data[pos:pos + (3 << ((iflags & 7) + 1))]
                pos += len(p)
                palette = b'' if _grey_ramp(p) else p
            min_code = data[pos]
            lzw, _ = _sub_blocks(data, pos + 1, path)
            break
        else:
            raise ValueError(f'{path}: unknown GIF block 0x{kind:02x}')
    width, height = max(width, x0 + w), max(height, y0 + h)
    frame = native.gif_lzw(lzw, min_code, w * h).reshape(h, w)
    if iflags & 64:                     # interlaced: passes of rows 8k, 8k+4, 4k+2, 2k+1
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
        rows = np.empty_like(frame)
        rows[order] = frame
        frame = rows
    canvas = np.full((height, width), transparency or 0, np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = frame
    if not palette:
        return canvas, 'L', None
    pal = palette_rgba(palette)
    if transparency is not None:
        pal[transparency, 3] = 0
    return canvas, 'P', pal


# ------------------------------------------------------------------- BMP

# BmpImagePlugin's BI_BITFIELDS layouts: (bits, masks) -> Pillow's raw mode
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): 'BGRX',
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): 'XBGR',
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): 'BGXR',
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): 'ABGR',
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): 'RGBA',
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): 'BGRA',
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): 'BGAR',
    (32, (0x0, 0x0, 0x0, 0x0)): 'BGRA',
    (24, (0xFF0000, 0xFF00, 0xFF)): 'BGR',
    (16, (0xF800, 0x7E0, 0x1F)): 'BGR;16',
    (16, (0x7C00, 0x3E0, 0x1F)): 'BGR;15',
}
_BIT_MODES = {1: 'P;1', 4: 'P;4', 8: 'P', 16: 'BGR;15', 24: 'BGR', 32: 'BGRX'}


def _unpack(rows: np.ndarray, raw_mode: str, width: int) -> np.ndarray:
    """Rows of raw bytes [H, stride] in one of Pillow's BMP raw modes ->
    pixels [H, W(, C)]."""
    if raw_mode in ('P;1', 'P;4', '1'):
        bits = 1 if raw_mode != 'P;4' else 4
        per = 8 // bits
        b = rows[:, :(width + per - 1) // per]
        vals = np.stack([(b >> (8 - bits * (k + 1))) & ((1 << bits) - 1) for k in range(per)],
                        axis=-1).reshape(rows.shape[0], -1)[:, :width]
        return vals.astype(bool) if raw_mode == '1' else vals.astype(np.uint8)
    if raw_mode in ('P', 'L'):
        return rows[:, :width].copy()
    if raw_mode in ('BGR;15', 'BGR;16'):
        px = rows[:, :2 * width].astype(np.uint32)
        px = px[:, 0::2] | (px[:, 1::2] << 8)
        g_bits = 6 if raw_mode == 'BGR;16' else 5
        r = (px >> (5 + g_bits)) & 31
        g = (px >> 5) & ((1 << g_bits) - 1)
        b = px & 31
        return np.stack([r * 255 // 31, g * 255 // ((1 << g_bits) - 1), b * 255 // 31],
                        axis=-1).astype(np.uint8)
    n = 3 if raw_mode == 'BGR' else 4
    px = rows[:, :n * width].reshape(rows.shape[0], width, n)
    take = [raw_mode.index(ch) for ch in ('RGBA' if 'A' in raw_mode else 'RGB')]
    return px[:, :, take].copy()


def decode_bmp(data: bytes, path: str) -> Image:
    if data[:2] != b'BM' or len(data) < 26:
        raise ValueError(f'{path} is not a BMP file')

    def u32(p):
        return struct.unpack('<I', data[p:p + 4])[0]

    def u16(p):
        return struct.unpack('<H', data[p:p + 2])[0]

    offset, hsize = u32(10), u32(14)
    h0 = 18
    direction = -1                              # bottom-up
    compression, colors = 0, 0
    if hsize == 12:
        width, height, bits, pal_step = u16(h0), u16(h0 + 2), u16(h0 + 6), 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        width, bits, compression, colors = u32(h0), u16(h0 + 10), u32(h0 + 12), u32(h0 + 28)
        if data[h0 + 7] == 0xFF:                # a negative height: rows top-down
            direction, height = 1, 2 ** 32 - u32(h0 + 4)
        else:
            height = u32(h0 + 4)
        pal_step = 4
    else:
        raise ValueError(f'{path}: unsupported BMP header size {hsize}')
    if width <= 0 or height <= 0:
        raise ValueError(f'{path}: a BMP of {width}x{height} pixels')
    colors = colors or (1 << bits if bits < 32 else 0)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT_MODES:
        raise ValueError(f'{path}: unsupported BMP pixel depth {bits}')
    raw_mode = _BIT_MODES[bits]
    mode = {1: 'P', 4: 'P', 8: 'P', 16: 'RGB', 24: 'RGB', 32: 'RGB'}[bits]
    rle = None
    if compression == 3:                        # BI_BITFIELDS
        if hsize - 4 >= 48:
            masks = [u32(h0 + 36 + 4 * k) for k in range(3)]
            masks.append(u32(h0 + 48) if hsize - 4 >= 52 else 0)
        else:                                   # three masks after a 40-byte header
            masks = [u32(14 + hsize + 4 * k) for k in range(3)] + [0]
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        if key not in _MASK_MODES:
            raise ValueError(f'{path}: unsupported BMP bitfields layout {bits}-bit {masks}')
        raw_mode = _MASK_MODES[key]
        if bits == 32 and 'A' in raw_mode:
            mode = 'RGBA'
    elif compression in (1, 2):                 # RLE8, RLE4
        rle = compression == 2
    elif compression != 0:
        raise ValueError(f'{path}: unsupported BMP compression {compression}')
    palette = None
    if mode == 'P':
        if not 0 < colors <= 65536:
            raise ValueError(f'{path}: unsupported BMP palette size {colors}')
        start = 14 + hsize
        pal = data[start:start + pal_step * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(pal[i * pal_step:i * pal_step + 3] == bytes([v]) * 3 for i, v in enumerate(ramp)):
            mode = raw_mode = '1' if colors == 2 else 'L'
            if bits == 4 and rle is None:
                raise ValueError(f'{path}: a 4-bit grey-ramp BMP, which Pillow reads as 8-bit '
                                 'L rows; not decoded')
        else:
            palette = palette_rgba(pal, pal_step, 'BGR')
    if rle is not None:
        if mode == '1':
            raise ValueError(f'{path}: an RLE BMP with a black-white palette; not decoded')
        pixels = native.bmp_rle(data, offset, width, height, rle)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        need = stride * height
        body = np.frombuffer(data[offset:offset + need], np.uint8)
        if body.size < need:
            raise ValueError(f'{path}: BMP data ends early ({body.size} of {need} bytes)')
        pixels = _unpack(body.reshape(height, stride), raw_mode, width)
    if direction == -1:
        pixels = pixels[::-1]
    return np.ascontiguousarray(pixels), mode, palette
