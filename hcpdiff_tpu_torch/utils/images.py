"""Image I/O without Pillow (the port depends on no imaging package): an
8-bit PNG writer and reader over zlib and ``struct``, a copy of Pillow's
bicubic resampling for 8-bit images, and ``to_model_input`` (counterpart of
``hcpdiff_tpu/data/utils.py:to_model_input``).

- ``write_png``/``encode_png`` (to a file, to bytes): 8-bit L, RGB or
  RGBA, filter 0 on every row;
- ``read_png``/``decode_png`` (from a file, from bytes): 8-bit L, RGB or
  RGBA, not interlaced, filters 0-4 (what Pillow and other writers choose
  row by row);
- ``resize_bicubic``: ``PIL.Image.resize(size, Image.BICUBIC)`` on an
  8-bit L or RGB array, bit for bit: Pillow's separable filter (Keys
  cubic, a = -0.5, its support widened by the scale when shrinking), its
  22-bit fixed-point weights and rounding, horizontal pass first;
- ``write_webp_anim``/``encode_webp_anim``: an animated WebP of 8-bit RGB
  frames, each a lossless VP8L image of literals only (no transforms, no
  colour cache, every channel a complete code of 256 length-8 literals,
  the distance code one symbol); ``read_webp_anim`` reads back what it
  writes (the RIFF chunks, and each frame's pixels);
- ``decode_jpeg``/``read_jpeg``: baseline JPEG, as Pillow decodes it
  (``utils/jpeg.py``);
- ``load_image``/``load_mask``: what the Visualizer reads for img2img and
  inpaint. An 8-bit L/RGB/RGBA PNG or a baseline JPEG needs no Pillow;
  another PNG or format is decoded by Pillow, imported there, and raises
  an error naming Pillow where it is missing.
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

from .jpeg import UnsupportedJPEG, decode_jpeg, is_jpeg, read_jpeg  # noqa: F401

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}          # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """A uint8 array [H, W] (L), [H, W, 1], [H, W, 3] (RGB) or [H, W, 4]
    (RGBA) as the bytes of a PNG file."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f'write_png takes uint8 images, not {arr.dtype}')
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOR_TYPES:
        raise ValueError(f'write_png takes [H, W] or [H, W, 1/3/4] images, not {arr.shape}')
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    ihdr = struct.pack('>IIBBBBB', w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b'IHDR', ihdr)
            + _chunk(b'IDAT', zlib.compress(rows.tobytes(), 6)) + _chunk(b'IEND', b''))


def write_png(path: str, image: np.ndarray) -> None:
    """Write ``encode_png(image)`` to ``path``."""
    with open(path, 'wb') as f:
        f.write(encode_png(image))


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return row
    if kind == 2:
        return row + prev                  # uint8 arithmetic wraps mod 256
    if kind == 1:
        out = row.astype(np.int64).reshape(-1, bpp).cumsum(axis=0)
        return (out & 0xFF).astype(np.uint8).reshape(-1)
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    n = len(out)
    if kind == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    elif kind == 4:
        for i in range(n):
            a = out[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    else:
        raise ValueError(f'PNG filter type {kind} does not exist')
    return np.frombuffer(bytes(out), np.uint8)


class UnsupportedPNG(ValueError):
    """A valid PNG that ``read_png`` does not decode (its bit depth, colour
    type or interlacing)."""


def read_png(path: str) -> np.ndarray:
    """A PNG file as uint8 [H, W] (L) or [H, W, 3/4] (RGB/RGBA)."""
    with open(path, 'rb') as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = 'PNG data') -> np.ndarray:
    """The bytes of a PNG file as ``read_png`` returns it; ``path`` names
    the data in errors."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f'{path} is not a PNG file')
    pos, idat, header = len(PNG_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack('>I', data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack('>I', data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f'{path}: bad CRC in a {kind!r} chunk')
        pos += 12 + n
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None:
        raise ValueError(f'{path}: no IHDR chunk')
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise UnsupportedPNG(f'{path}: only 8-bit, non-interlaced L/RGB/RGBA PNGs are read '
                             f'(bit depth {depth}, colour type {color}, interlace {interlace})')
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError(f'{path}: {raw.size} bytes of pixel data for a {w}x{h}x{c} image')
    raw = raw.reshape(h, w * c + 1)
    out = np.empty((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, c)
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


# ------------------------------------------------------- Pillow's bicubic

# ------------------------------------------------------------------ WebP

# VP8L's order of the code-length code's lengths
_CL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_N_GREEN = 256 + 24                         # literals and length prefixes, no cache


def _lsb(value: int, n: int) -> list:
    """``value``'s ``n`` low bits, least significant first (VP8L's order)."""
    return [(value >> k) & 1 for k in range(n)]


def _literal_code(n_symbols: int) -> list:
    """A normal prefix code over ``n_symbols`` whose first 256 symbols have
    length 8 and the rest 0 (a complete code: symbol s's code is s, read
    most significant bit first). Its lengths are coded with a code-length
    code of two symbols, 0 and 8, of length 1 (codes 0 and 1)."""
    n = _CL_ORDER.index(8) + 1
    bits = [0] + _lsb(n - 4, 4)
    for sym in _CL_ORDER[:n]:
        bits += _lsb(1 if sym in (0, 8) else 0, 3)
    return bits + [0] + [1] * 256 + [0] * (n_symbols - 256)


# the header of every frame's VP8L stream after its size fields: no
# transform, no colour cache, no meta codes, the green, red, blue and alpha
# codes, and a one-symbol simple distance code
_VP8L_CODES = ([0, 0, 0] + _literal_code(_N_GREEN) + _literal_code(256) * 3
               + [1, 0, 0, 0])


def _vp8l_header_bits(width: int, height: int) -> list:
    return (_lsb(0x2f, 8) + _lsb(width - 1, 14) + _lsb(height - 1, 14) + [0] + _lsb(0, 3)
            + _VP8L_CODES)


def encode_vp8l(image: np.ndarray) -> bytes:
    """An 8-bit RGB image [H, W, 3] as a lossless VP8L bitstream of
    literals (alpha 255)."""
    h, w = image.shape[:2]
    if not (1 <= w <= 1 << 14 and 1 <= h <= 1 << 14):
        raise ValueError(f'VP8L takes sides 1..16384, not {w}x{h}')
    px = np.empty((h * w, 4), np.uint8)
    px[:, 0] = image[..., 1].reshape(-1)          # green, red, blue, alpha
    px[:, 1] = image[..., 0].reshape(-1)
    px[:, 2] = image[..., 2].reshape(-1)
    px[:, 3] = 255
    bits = np.concatenate([np.asarray(_vp8l_header_bits(w, h), np.uint8),
                           np.unpackbits(px.reshape(-1), bitorder='big')])
    return np.packbits(bits, bitorder='little').tobytes()


def _riff_chunk(kind: bytes, data: bytes) -> bytes:
    return kind + struct.pack('<I', len(data)) + data + (b'\0' if len(data) % 2 else b'')


def _u24(v: int) -> bytes:
    return struct.pack('<I', v)[:3]


def encode_webp_anim(frames, frame_ms: int) -> bytes:
    """Frames (8-bit RGB [H, W, 3], one size) as an animated WebP: VP8X
    with the animation flag, ANIM (white background, looping forever), then
    one ANMF a frame at (0, 0), ``frame_ms`` long, not blended."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w = frames[0].shape[:2]
    if any(f.shape != (h, w, 3) for f in frames):
        raise ValueError('encode_webp_anim: every frame must be RGB of one size')
    body = _riff_chunk(b'VP8X', bytes([0x02, 0, 0, 0]) + _u24(w - 1) + _u24(h - 1))
    body += _riff_chunk(b'ANIM', b'\xff\xff\xff\xff' + struct.pack('<H', 0))
    for f in frames:
        head = _u24(0) + _u24(0) + _u24(w - 1) + _u24(h - 1) + _u24(int(frame_ms)) + b'\x02'
        body += _riff_chunk(b'ANMF', head + _riff_chunk(b'VP8L', encode_vp8l(f)))
    return b'RIFF' + struct.pack('<I', 4 + len(body)) + b'WEBP' + body


def write_webp_anim(path: str, frames, frame_ms: int) -> None:
    with open(path, 'wb') as f:
        f.write(encode_webp_anim(frames, frame_ms))


def _riff_chunks(data: bytes, where: str):
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


def _decode_vp8l_literals(data: bytes, w: int, h: int) -> np.ndarray:
    """The pixels of a VP8L stream ``encode_vp8l`` wrote; raises on any
    other stream."""
    head = np.asarray(_vp8l_header_bits(w, h), np.uint8)
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder='little')
    if len(bits) < len(head) + 32 * w * h or not np.array_equal(bits[:len(head)], head):
        raise ValueError('not a literal-only VP8L stream of this size')
    px = np.packbits(bits[len(head):len(head) + 32 * w * h], bitorder='big').reshape(h, w, 4)
    return np.stack([px[..., 1], px[..., 0], px[..., 2]], axis=-1)


def read_webp_anim(path: str) -> dict:
    """What ``write_webp_anim`` wrote: {'canvas': (w, h), 'flags': the VP8X
    flags, 'loop', 'frames': [{'offset': (x, y), 'size': (w, h),
    'duration', 'flags', 'image': uint8 [h, w, 3]}]}; raises on a file of
    another layout."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:4] != b'RIFF' or data[8:12] != b'WEBP':
        raise ValueError(f'{path}: not a RIFF WEBP file')
    if struct.unpack('<I', data[4:8])[0] != len(data) - 8:
        raise ValueError(f'{path}: the RIFF size is not the file\'s')
    chunks = _riff_chunks(data[12:], path)
    kinds = [k for k, _ in chunks]
    if kinds[:2] != [b'VP8X', b'ANIM'] or set(kinds[2:]) != {b'ANMF'}:
        raise ValueError(f'{path}: chunks {kinds}')
    vp8x, anim = chunks[0][1], chunks[1][1]
    u24 = lambda b: int.from_bytes(b, 'little')        # noqa: E731
    out = {'flags': vp8x[0], 'canvas': (u24(vp8x[4:7]) + 1, u24(vp8x[7:10]) + 1),
           'loop': struct.unpack('<H', anim[4:6])[0], 'frames': []}
    for _, p in chunks[2:]:
        (kind, bitstream), = _riff_chunks(p[16:], path)
        w, h = u24(p[6:9]) + 1, u24(p[9:12]) + 1
        if kind != b'VP8L':
            raise ValueError(f'{path}: a frame of {kind!r}')
        out['frames'].append({'offset': (2 * u24(p[0:3]), 2 * u24(p[3:6])), 'size': (w, h),
                              'duration': u24(p[12:15]), 'flags': p[15],
                              'image': _decode_vp8l_literals(bitstream, w, h)})
    return out


_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's fixed-point weights as taps: for each output index, the
    input indices its window reads and their int64 weights, [out, K] each
    (a window shorter than K is padded with weight 0)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    rows = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        ws = [_bicubic((x + xmin - center + 0.5) / filterscale) for x in range(xmax - xmin)]
        total = sum(ws)
        rows.append((xmin, [int((-0.5 if wv < 0 else 0.5) + wv * (1 << _PRECISION_BITS))
                            for wv in ((w / total if total != 0.0 else w) for w in ws)]))
    K = max(len(ws) for _, ws in rows)
    idx = np.zeros((out_size, K), np.int64)
    wts = np.zeros((out_size, K), np.int64)
    for xx, (xmin, ws) in enumerate(rows):
        idx[xx, :len(ws)] = np.arange(xmin, xmin + len(ws))
        wts[xx, :len(ws)] = ws
    return idx, wts


def _apply(idx: np.ndarray, wts: np.ndarray, arr: np.ndarray, axis: int) -> np.ndarray:
    a = np.moveaxis(arr, axis, 0)
    shape = (-1,) + (1,) * (a.ndim - 1)
    acc = np.full((idx.shape[0],) + a.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for k in range(idx.shape[1]):
        acc += wts[:, k].reshape(shape) * a[idx[:, k]]
    return np.moveaxis(np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def resize_bicubic(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(image).resize(size, Image.BICUBIC)`` for a uint8
    [H, W] or [H, W, C] array; ``size`` is (width, height)."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f'resize_bicubic takes uint8 images, not {arr.dtype}')
    w_out, h_out = size
    h_in, w_in = arr.shape[:2]
    if (w_out, h_out) == (w_in, h_in):
        return arr.copy()
    if w_out != w_in:                      # the horizontal pass first, as Pillow
        arr = _apply(*_taps(w_in, w_out), arr, 1)
    if h_out != h_in:
        arr = _apply(*_taps(h_in, h_out), arr, 0)
    return arr


def to_model_input(image: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] (or L / RGBA, taken as RGB) -> float32 [H, W, 3]
    in [-1, 1]."""
    arr = _rgb(np.asarray(image))
    return arr.astype(np.float32) / 127.5 - 1.0


def _rgb(arr: np.ndarray) -> np.ndarray:
    """What Pillow's ``convert('RGB')`` gives for L and RGBA (alpha dropped)."""
    if arr.ndim == 2:
        return np.repeat(arr[:, :, None], 3, axis=2)
    return arr[:, :, :3]


def _luma(arr: np.ndarray) -> np.ndarray:
    """Pillow's ``convert('L')``: L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    if arr.ndim == 2:
        return arr
    rgb = arr[:, :, :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def read_image(path: str, mode: str) -> np.ndarray:
    """uint8 [H, W, 3] (``mode`` 'RGB') or [H, W] ('L'), as Pillow's
    ``convert(mode)`` gives them: 8-bit L/RGB/RGBA PNGs by ``read_png``,
    baseline JPEGs by ``read_jpeg``, other PNGs (palette, grey + alpha,
    16-bit, interlaced) and other formats by Pillow."""
    with open(path, 'rb') as f:
        head = f.read(len(PNG_SIGNATURE))
    is_png = head == PNG_SIGNATURE
    if is_jpeg(head):
        try:
            arr = read_jpeg(path)
        except UnsupportedJPEG:
            pass
        else:
            return _rgb(arr) if mode == 'RGB' else _luma(arr)
    if is_png:
        try:
            arr = read_png(path)
        except UnsupportedPNG:
            pass
        else:
            return _rgb(arr) if mode == 'RGB' else _luma(arr)
    try:
        from PIL import Image
    except ImportError as e:
        what = 'a PNG read_png does not take' if is_png else 'not a PNG'
        raise ImportError(f'{path} is {what}: reading it needs Pillow, which is not '
                          'installed') from e
    with Image.open(path) as im:
        return np.asarray(im.convert(mode))


def load_image(path: str, width: int, height: int) -> np.ndarray:
    """An init image as float32 [1, height, width, 3] in [-1, 1]: RGB,
    resized by Pillow's bicubic where its size differs."""
    rgb = resize_bicubic(read_image(path, 'RGB'), (width, height))
    return to_model_input(rgb)[None]


def load_mask(path: str, width: int, height: int) -> np.ndarray:
    """A mask as float32 [1, height, width, 1] in [0, 1] (1 = the region to
    paint): luminance, resized by Pillow's bicubic."""
    m = resize_bicubic(read_image(path, 'L'), (width, height))
    return (m.astype(np.float32) / 255.0)[None, :, :, None]
