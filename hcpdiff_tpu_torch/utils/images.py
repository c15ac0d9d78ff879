"""Image I/O without Pillow (the port depends on no imaging package): a
reader of the formats the JAX package opens through Pillow, a PNG and WebP
writer, a copy of Pillow's bicubic resampling for 8-bit images, and
``to_model_input`` (counterpart of ``hcpdiff_tpu/data/utils.py:to_model_input``).

- ``decode_image``/``read_image``: one dispatcher for every reader of the
  port (``data/utils.py:load_rgb``/``load_gray``, ``load_image``/
  ``load_mask``, ``data/processor.py``). It sniffs the format and returns
  a ``Decoded``: the pixels as ``np.asarray(Image.open(f))`` gives them,
  Pillow's mode, and a 'P' image's palette with its transparency.
  ``to_rgb``, ``to_rgba`` and ``to_l`` are Pillow's ``convert`` to
  'RGB', 'RGBA' and 'L' from each mode. It reads:

  - PNG (``decode_png``): bit depths 1/2/4/8/16, grey, RGB, palette (with
    ``tRNS``), grey + alpha and RGBA, Adam7 interlacing, in Pillow's
    modes ('1', 'L' with 2/4-bit grey scaled up, 'I;16', 'RGB', 'P', 'LA',
    'RGBA', 16-bit grey + alpha as 'RGBA'); the row filters are undone in
    C++;
  - JPEG: sequential, progressive (smoothed where it stops early) and
    lossless, Huffman or arithmetic coded, 1/3/4 components, any
    sampling, as Pillow decodes it (``utils/jpeg.py``, C++);
  - GIF (first frame) and BMP (``utils/gif_bmp.py``, LZW and RLE in C++);
  - WebP: lossy, lossless, with alpha, and an animation's first frame
    (``utils/webp.py``, C++);
  - TIFF and BigTIFF: the first page, every compression and sample
    layout Pillow's libtiff reads (``utils/tiff.py``; LZW, PackBits, CCITT
    fax, ThunderScan and ZSTD in C++), CIELab converted to RGB as Pillow's
    LittleCMS transform converts it (``utils/cielab.py``);
  - ICO (``decode_ico``): the entry Pillow opens, a PNG or a bitmap.

  What Pillow does not read either raises a ``ValueError`` naming the
  file and the kind (``utils/jpeg.py`` and ``utils/tiff.py`` list them).
- ``write_png``/``encode_png``: 8-bit L, RGB or RGBA, filter 0 on every
  row;
- ``resize_bicubic``: ``PIL.Image.resize(size, Image.BICUBIC)`` on an
  8-bit L or RGB array, bit for bit: Pillow's separable filter (Keys
  cubic, a = -0.5, its support widened by the scale when shrinking), its
  22-bit fixed-point weights and rounding, horizontal pass first;
- ``write_webp_anim``/``encode_webp_anim``: an animated WebP of 8-bit RGB
  frames, each a lossless VP8L image of literals only (no transforms, no
  colour cache, every channel a complete code of 256 length-8 literals,
  the distance code one symbol); ``read_webp_anim`` reads back what it
  writes (the RIFF chunks, and each frame's pixels); ``write_webp``/
  ``encode_webp``: one such frame as a still image (the simple format:
  RIFF, WEBP, one VP8L chunk), and ``read_webp`` any still WebP's pixels;
- ``load_image``/``load_mask``: what the Visualizer reads for img2img and
  inpaint.
"""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np

from . import cielab, native, webp
from .gif_bmp import decode_bmp, decode_dib, decode_gif, palette_rgba
from .jpeg import (UnsupportedJPEG, decode_jpeg, decode_jpeg_mode, is_jpeg,  # noqa: F401
                   read_jpeg)
from .tiff import decode_tiff
from .webp import decode_webp

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}          # channels -> PNG colour type


class Decoded(NamedTuple):
    """An image as Pillow's ``Image.open`` gives it: ``pixels`` as
    ``np.asarray`` of it, Pillow's ``mode``, and for mode 'P' the
    ``palette`` as uint8 [256, 4] RGBA (the transparency in its alpha)."""
    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None


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


# PngImagePlugin._MODES: (bit depth, colour type) -> Pillow's mode
_PNG_MODES = {(1, 0): '1', (2, 0): 'L', (4, 0): 'L', (8, 0): 'L', (16, 0): 'I;16',
              (8, 2): 'RGB', (16, 2): 'RGB', (1, 3): 'P', (2, 3): 'P', (4, 3): 'P', (8, 3): 'P',
              (8, 4): 'LA', (16, 4): 'RGBA', (8, 6): 'RGBA', (16, 6): 'RGBA'}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, rowbytes] -> samples [h, width, channels]
    (uint16 at depth 16)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        return rows[:, :2 * width * channels].copy().view('>u2').astype(np.uint16).reshape(
            h, width, channels)
    per = 8 // depth
    vals = np.stack([(rows >> (8 - depth * (k + 1))) & ((1 << depth) - 1) for k in range(per)],
                    axis=-1).reshape(h, -1)
    return vals[:, :width, None]


def png_image(data: bytes, path: str = 'PNG data') -> Decoded:
    """Any PNG Pillow opens, as it opens it."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f'{path} is not a PNG file')
    pos, idat, header, plte, trns = len(PNG_SIGNATURE), [], None, None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack('>I', data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack('>I', crc)[0]:
            raise ValueError(f'{path}: bad CRC in a {kind!r} chunk')
        pos += 12 + n
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            plte = body
        elif kind == b'tRNS':
            trns = body
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None:
        raise ValueError(f'{path}: no IHDR chunk')
    w, h, depth, color, _, _, interlace = header
    mode = _PNG_MODES.get((depth, color))
    if mode is None:
        raise ValueError(f'{path}: PNG bit depth {depth} with colour type {color} is not '
                         'a PNG Pillow reads')
    if mode == 'P' and plte is None:
        raise ValueError(f'{path}: a palette PNG without a PLTE chunk')
    ch = _PNG_CHANNELS[color]
    try:
        raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f'{path}: corrupt PNG pixel data ({e})') from e
    samples = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = (pw * ch * depth + 7) // 8
        try:
            rows = native.png_unfilter(raw[off:off + ph * (rowbytes + 1)], ph, rowbytes,
                                       ch * depth // 8)
        except ValueError as e:
            raise ValueError(f'{path}: {e}') from e
        off += ph * (rowbytes + 1)
        samples[y0::dy, x0::dx] = _png_samples(rows, pw, ch, depth)
    palette = None
    if mode == '1':
        pixels = samples[:, :, 0] != 0
    elif mode == 'P':
        pixels = samples[:, :, 0]
        palette = palette_rgba(plte)
        if trns is not None:
            palette[:min(len(trns), 256), 3] = np.frombuffer(trns[:256], np.uint8)
    elif mode == 'I;16':
        pixels = samples[:, :, 0]
    elif depth == 16:                  # Pillow keeps the high byte ('RGB;16B', 'LA;16B', ...)
        hi = (samples >> 8).astype(np.uint8)
        pixels = np.concatenate([np.repeat(hi[:, :, :1], 3, axis=2), hi[:, :, 1:]], axis=2) \
            if ch == 2 else hi
    elif ch == 1:
        pixels = samples[:, :, 0] * np.uint8(255 // ((1 << depth) - 1))   # 'L;2', 'L;4'
    else:
        pixels = samples
    return Decoded(np.ascontiguousarray(pixels), mode, palette)


def decode_png(data: bytes, path: str = 'PNG data') -> np.ndarray:
    """The pixels of any PNG Pillow opens, as ``np.asarray(Image.open(f))``
    gives them (``png_image`` also gives the mode and palette); ``path``
    names the data in errors."""
    return png_image(data, path).pixels


def read_png(path: str) -> np.ndarray:
    """A PNG file's pixels, as ``decode_png`` gives them."""
    with open(path, 'rb') as f:
        return decode_png(f.read(), path)


def decode_ico(data: bytes, path: str = 'ICO data') -> Decoded:
    """The entry Pillow's ``IcoImagePlugin`` opens: the largest (width x
    height in its directory), the lowest colour depth among equals. A PNG
    entry is that PNG, at whatever size it holds; a bitmap entry (its
    height doubled in its header) is read as 'RGBA', the alpha its own
    (32 bits a pixel) or its AND mask's (a set bit transparent)."""
    if len(data) < 6 or data[:4] != b'\0\0\1\0':
        raise ValueError(f'{path} is not an ICO file')
    entries = []
    for k in range(struct.unpack('<H', data[4:6])[0]):
        e = data[6 + 16 * k:22 + 16 * k]
        if len(e) < 16:
            raise ValueError(f'{path}: the ICO directory runs past the file')
        w, h, ncolor = e[0] or 256, e[1] or 256, e[2]
        bpp, size, offset = struct.unpack('<HII', e[6:16])
        depth = bpp or (ncolor and int(np.ceil(np.log2(ncolor)))) or 256
        entries.append((w * h, depth, bpp, size, offset))
    if not entries:
        raise ValueError(f'{path}: an ICO file without images')
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, bpp, size, at = entries[0]
    if data[at:at + 8] == PNG_SIGNATURE:
        return png_image(data[at:], path)
    pixels, mode, palette, start = decode_dib(data, at, path, halve=True)
    h, w = pixels.shape[:2]
    if bpp == 32:                        # its fourth bytes, bottom-up
        raw = np.frombuffer(data[start:start + 4 * w * h], np.uint8)
        if raw.size < 4 * w * h:
            raise ValueError(f'{path}: ICO data ends inside an image')
        alpha = raw[3::4].reshape(h, w)[::-1]
    else:                                # the AND mask: rows of 32-bit words, bottom-up
        wpad = -(-w // 32) * 32
        total = wpad * h // 8
        raw = np.frombuffer(data[at + size - total:at + size], np.uint8)
        if at + size - total < 0 or raw.size < total:
            raise ValueError(f'{path}: ICO data ends inside a mask')
        bits = np.unpackbits(raw.reshape(h, wpad // 8), axis=1)[::-1, :w]
        alpha = np.where(bits == 0, 255, 0).astype(np.uint8)
    img = Decoded(pixels, mode, palette)
    rgba = to_rgba(img) if mode in ('P', 'RGBA') else np.concatenate(
        [to_rgb(img), np.full((h, w, 1), 255, np.uint8)], axis=2)
    rgba = rgba.copy()
    rgba[:, :, 3] = alpha
    return Decoded(rgba, 'RGBA')


def decode_image(data: bytes, path: str = 'image data') -> Decoded:
    """An image file's bytes, of any format the port reads, as Pillow's
    ``Image.open`` gives it; ``path`` names the data in errors."""
    if is_jpeg(data):
        return Decoded(*decode_jpeg_mode(data, path))
    gif = lambda d, p: Decoded(*decode_gif(d, p))       # noqa: E731
    tiff = lambda d, p: Decoded(*decode_tiff(d, p))     # noqa: E731
    readers = ((PNG_SIGNATURE, png_image), (b'GIF87a', gif), (b'GIF89a', gif),
               (b'BM', lambda d, p: Decoded(*decode_bmp(d, p))),
               (b'RIFF', lambda d, p: Decoded(*decode_webp(d, p))), (b'II*\0', tiff),
               (b'MM\0*', tiff), (b'II+\0', tiff), (b'MM\0+', tiff), (b'\0\0\1\0', decode_ico))
    for magic, reader in readers:
        if data.startswith(magic) and (magic != b'RIFF' or data[8:12] == b'WEBP'):
            try:
                return reader(data, path)
            except (IndexError, struct.error) as e:
                raise ValueError(f'{path}: corrupt or cut image data ({e})') from e
    raise ValueError(f'{path}: not an image format the PyTorch port reads (PNG, JPEG, GIF, '
                     'BMP, WebP, TIFF, ICO)')


def read_decoded(path: str) -> Decoded:
    with open(path, 'rb') as f:
        return decode_image(f.read(), path)


def _luma(arr: np.ndarray) -> np.ndarray:
    """Pillow's ``convert('L')`` of RGB(A): (R*19595 + G*38470 + B*7471 +
    0x8000) >> 16 (the alpha dropped); L comes back as it is."""
    if arr.ndim == 2:
        return arr
    rgb = arr[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _cmyk_rgb(px: np.ndarray) -> np.ndarray:
    """Pillow's ``cmyk2rgb``: each channel nk - nk * c / 255 (rounded as
    MULDIV255), nk = 255 - K."""
    nk = 255 - px[..., 3:4].astype(np.int32)
    t = px[..., :3].astype(np.int32) * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _grey(img: Decoded) -> np.ndarray:
    """The grey channel of a '1', 'L', 'LA', 'I;16', 'I' or 'F' image as 8
    bits, as Pillow converts each to 'L' or 'RGB'."""
    px = img.pixels
    if img.mode == '1':
        return np.where(px, 255, 0).astype(np.uint8)
    if img.mode in ('I;16', 'I;16B'):          # I16_RGB / I16_L: saturated at 255
        return np.minimum(px, 255).astype(np.uint8)
    if img.mode == 'I':                        # i2l / i2rgb: clipped to 0..255
        return np.clip(px, 0, 255).astype(np.uint8)
    if img.mode == 'F':                        # f2l (RGB through L): truncated, NaN as 0
        with np.errstate(invalid='ignore'):
            return np.where(px >= 255, 255, np.where(px > 0, px, 0)).astype(np.uint8)
    return px[..., 0] if img.mode == 'LA' else px


def to_rgb(img: Decoded) -> np.ndarray:
    """Pillow's ``convert('RGB')``: uint8 [H, W, 3]."""
    if img.mode == 'P':
        return img.palette[img.pixels, :3]
    if img.mode == 'LAB':                      # through LittleCMS in Pillow
        return cielab.lab_to_rgb(img.pixels)
    if img.mode == 'CMYK':
        return _cmyk_rgb(img.pixels)
    if img.mode in ('RGB', 'RGBA'):
        return img.pixels[..., :3]
    return np.repeat(_grey(img)[:, :, None], 3, axis=2)


def to_rgba(img: Decoded) -> np.ndarray:
    """Pillow's ``convert('RGBA')`` of an 'RGBA', 'LA' or 'P' image (the
    modes the JAX package composites over a background)."""
    if img.mode == 'P':
        return img.palette[img.pixels]
    if img.mode == 'LA':
        return img.pixels[..., [0, 0, 0, 1]]
    if img.mode == 'RGBA':
        return img.pixels
    raise ValueError(f'to_rgba takes RGBA, LA and P images, not {img.mode}')


def to_l(img: Decoded, path: str = 'image data') -> np.ndarray:
    """Pillow's ``convert('L')``: uint8 [H, W]. Pillow has none from 'LAB',
    and this raises a ValueError naming ``path`` there."""
    if img.mode == 'LAB':
        raise ValueError(f'{path}: a CIELab image, which Pillow converts to RGB but not to L '
                         '(its convert(\'L\') fails), and so does the PyTorch port')
    if img.mode == 'P':
        return _luma(img.palette[None])[0][img.pixels]
    if img.mode == 'CMYK':                     # through RGB, as Pillow converts it
        return _luma(_cmyk_rgb(img.pixels))
    if img.mode in ('RGB', 'RGBA'):
        return _luma(img.pixels)
    return _grey(img)


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


def encode_webp(image: np.ndarray) -> bytes:
    """An 8-bit RGB image [H, W, 3] as a lossless still WebP (one VP8L
    chunk)."""
    body = _riff_chunk(b'VP8L', encode_vp8l(np.asarray(image, np.uint8)))
    return b'RIFF' + struct.pack('<I', 4 + len(body)) + b'WEBP' + body


def write_webp(path: str, image: np.ndarray) -> None:
    with open(path, 'wb') as f:
        f.write(encode_webp(image))


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
    chunks = webp.riff_chunks(data[12:], path)
    kinds = [k for k, _ in chunks]
    if kinds[:2] != [b'VP8X', b'ANIM'] or set(kinds[2:]) != {b'ANMF'}:
        raise ValueError(f'{path}: chunks {kinds}')
    vp8x, anim = chunks[0][1], chunks[1][1]
    u24 = lambda b: int.from_bytes(b, 'little')        # noqa: E731
    out = {'flags': vp8x[0], 'canvas': (u24(vp8x[4:7]) + 1, u24(vp8x[7:10]) + 1),
           'loop': struct.unpack('<H', anim[4:6])[0], 'frames': []}
    for _, p in chunks[2:]:
        w, h = u24(p[6:9]) + 1, u24(p[9:12]) + 1
        image = webp.frame_rgba(webp.riff_chunks(p[16:], path), path, (w, h))
        out['frames'].append({'offset': (2 * u24(p[0:3]), 2 * u24(p[3:6])), 'size': (w, h),
                              'duration': u24(p[12:15]), 'flags': p[15],
                              'image': image[:, :, :3].copy()})
    return out


def read_webp(path: str) -> np.ndarray:
    """A WebP file's pixels as ``np.asarray(Image.open(path))`` gives them
    (``utils/webp.py:decode_webp``)."""
    with open(path, 'rb') as f:
        return decode_webp(f.read(), path)[0]


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


def read_image(path: str, mode: str) -> np.ndarray:
    """uint8 [H, W, 3] (``mode`` 'RGB') or [H, W] ('L'): any image the port
    reads (``decode_image``), as Pillow's ``Image.open(path).convert(mode)``
    gives it."""
    if mode not in ('RGB', 'L'):
        raise ValueError(f'read_image reads RGB or L, not {mode}')
    img = read_decoded(path)
    return to_rgb(img) if mode == 'RGB' else to_l(img, path)


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
