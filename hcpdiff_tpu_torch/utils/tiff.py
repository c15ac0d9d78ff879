"""TIFF reading as Pillow's ``Image.open`` gives it (``TiffImagePlugin``:
its own raw decoder for uncompressed data, libtiff for the rest), without
Pillow: the first page's IFD here, LZW and PackBits in C++
(``csrc/image_decode.cpp`` through ``utils/native.py``), Deflate through
``zlib``.

- Byte orders II and MM; strips and tiles; PlanarConfiguration 1 and 2;
  FillOrder 2 (each byte's bits reversed before decoding, as libtiff does;
  uncompressed MinIsWhite 8-bit and palette below 8 bits raise, as Pillow
  has no raw mode for them); the Orientation tag applied as Pillow applies
  it on load.
- Compression: none, PackBits, LZW (new style; the old LSB-first kind is
  refused), Deflate (8 and 32946); the horizontal predictor (2) at 8 and 16
  bits after LZW and Deflate, as libtiff applies it.
- Samples, with the mode Pillow's ``OPEN_INFO`` gives them: MinIsWhite and
  MinIsBlack at 1, 2, 4 and 8 bits ('1' or 'L', MinIsWhite inverted) and
  16 ('I;16', or 'I;16B' from MM; MinIsWhite 16-bit is not inverted, as
  Pillow reads it), grey + alpha ('LA'), RGB at 8 and 16 bits with
  ExtraSamples (unspecified: 'RGB', associated alpha: 'RGBA' unpremultiplied
  as Pillow's 'RGBa' unpacker does, unassociated: 'RGBA'; 16-bit samples
  keep their high byte), palette at 1, 2, 4 and 8 bits ('P', the colormap's
  high bytes), and CMYK at 8 and 16 bits.

Every other kind Pillow opens raises a ``ValueError`` naming the file, the
kind and ROADMAP.md queue 1 item 6: JPEG (6, 7), CCITT (2, 3, 4), LZMA,
ZSTD and WebP compression, float or signed samples beyond 8 bits,
YCbCr, CIELab, 12-bit and 32-bit samples, BigTIFF.
Corrupt or cut data raises a ``ValueError`` naming the file.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from . import native

ROADMAP = 'ROADMAP.md queue 1 item 6: image formats'

_TYPES = {1: 'B', 2: 'B', 3: 'H', 4: 'I', 5: 'II', 6: 'b', 7: 'B', 8: 'h', 9: 'i', 10: 'ii',
          11: 'f', 12: 'd', 13: 'I'}
_COMPRESSIONS = (1, 5, 8, 32773, 32946)   # none, LZW, Deflate, PackBits, Deflate
_REFUSED_COMPRESSIONS = {2: 'CCITT modified Huffman', 3: 'CCITT group 3 fax',
                         4: 'CCITT group 4 fax', 6: 'old-style JPEG-in-TIFF',
                         7: 'JPEG-in-TIFF', 34925: 'LZMA-compressed', 50000: 'ZSTD-compressed',
                         50001: 'WebP-compressed'}
_PHOTOMETRIC = {0: 'MinIsWhite', 1: 'MinIsBlack', 2: 'RGB', 3: 'palette', 5: 'CMYK',
                6: 'YCbCr', 8: 'CIELab'}


def refused(path: str, what: str) -> ValueError:
    return ValueError(f'{path}: {what} TIFF images are not decoded by the PyTorch port '
                      f'({ROADMAP}); convert it to a PNG or a JPEG')


def _tags(data: bytes, path: str) -> Tuple[str, Dict[int, tuple], bool]:
    """The byte order ('<' or '>'), the first IFD's tags (each a tuple of
    values), and whether any entry was lost. As Pillow's
    ``ImageFileDirectory_v2.load``: an IFD cut short keeps the entries read
    whole, and a tag whose values lie past the file is skipped."""
    if data[:4] in (b'II+\0', b'MM\0+'):
        raise refused(path, 'BigTIFF')
    order = '<' if data[:2] == b'II' else '>'
    (ifd,) = struct.unpack(order + 'I', data[4:8])
    if ifd + 2 > len(data):
        raise ValueError(f'{path}: the TIFF IFD offset {ifd} is past the file')
    (count,) = struct.unpack(order + 'H', data[ifd:ifd + 2])
    tags, lost = {}, False
    for k in range(count):
        at = ifd + 2 + 12 * k
        if at + 12 > len(data):
            lost = True
            break
        tag, typ, n, raw = struct.unpack(order + 'HHI4s', data[at:at + 12])
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(order + fmt) * n
        if size > 4:
            (off,) = struct.unpack(order + 'I', raw)
            if off + size > len(data):
                lost = True
                continue
            raw = data[off:off + size]
        tags[tag] = struct.unpack(order + fmt * n, raw[:size])
    return order, tags, lost


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None else v[0]


# OPEN_INFO's entries for the kinds read here, the byte order and fill
# order apart: (photometric, sample format, bits, extra samples) -> (mode,
# raw mode); a raw mode ending in 'I' is inverted (MinIsWhite), 'RGBa'
# unpremultiplied
_OPEN = {
    (0, (1,), (1,), ()): ('1', '1;I'), (1, (1,), (1,), ()): ('1', '1'),
    (0, (1,), (2,), ()): ('L', 'L;2I'), (1, (1,), (2,), ()): ('L', 'L;2'),
    (0, (1,), (4,), ()): ('L', 'L;4I'), (1, (1,), (4,), ()): ('L', 'L;4'),
    (0, (1,), (8,), ()): ('L', 'L;I'), (1, (1,), (8,), ()): ('L', 'L'),
    (1, (2,), (8,), ()): ('L', 'L'),
    (0, (1,), (16,), ()): ('I;16', 'I;16'), (1, (1,), (16,), ()): ('I;16', 'I;16'),
    (1, (1,), (8, 8), (2,)): ('LA', 'LA'),
    (2, (1,), (8,) * 4, (999,)): ('RGBA', 'RGBA'),
    (5, (1,), (8,) * 5, (0,)): ('CMYK', 'CMYK'),
    (5, (1,), (8,) * 6, (0, 0)): ('CMYK', 'CMYK'),
}
for _b in (8, 16):
    _OPEN.update({
        (2, (1,), (_b,) * 3, ()): ('RGB', 'RGB'),
        (2, (1,), (_b,) * 4, ()): ('RGBA', 'RGBA'),        # ExtraSamples missing
        (2, (1,), (_b,) * 4, (0,)): ('RGB', 'RGBX'),
        (2, (1,), (_b,) * 4, (1,)): ('RGBA', 'RGBa'),
        (2, (1,), (_b,) * 4, (2,)): ('RGBA', 'RGBA'),
        (5, (1,), (_b,) * 4, ()): ('CMYK', 'CMYK')})
for _e, _m in (((0, 0), ('RGB', 'RGBX')), ((1, 0), ('RGBA', 'RGBa')), ((2, 0), ('RGBA', 'RGBA'))):
    _OPEN[(2, (1,), (8,) * 5, _e)] = _m
    _OPEN[(2, (1,), (8,) * 6, _e + (0,))] = _m
for _b in (1, 2, 4, 8):
    _OPEN[(3, (1,), (_b,), ())] = ('P', 'P')


def _reverse_bits(buf: bytes) -> bytes:
    table = bytes(int(f'{i:08b}'[::-1], 2) for i in range(256))
    return buf.translate(table)


def _chunk(data: bytes, off: int, count: Optional[int], size: int, compression: int,
           fillorder: int, path: str) -> np.ndarray:
    """One strip or tile's ``size`` decoded bytes."""
    if off >= len(data) or (count is not None and off + count > len(data)):
        raise ValueError(f'{path}: TIFF data ends inside a strip or tile')
    raw = data[off:off + count] if count is not None else data[off:off + size]
    if fillorder == 2:
        raw = _reverse_bits(raw)
    if compression == 1:
        if len(raw) < size:
            raise ValueError(f'{path}: TIFF data ends inside a strip or tile')
        return np.frombuffer(raw[:size], np.uint8)
    if compression in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise ValueError(f'{path}: corrupt Deflate TIFF data ({e})') from e
        got = np.frombuffer(out, np.uint8)
    elif compression == 5:
        try:
            got = native.tiff_lzw(raw, size)
        except ValueError as e:
            msg = str(e)
            if msg.startswith('old-style'):
                raise refused(path, 'old-style LZW') from None
            raise ValueError(f'{path}: {msg}') from e
        return got
    else:
        got = native.packbits(raw, size)
        return got
    if got.size < size:
        raise ValueError(f'{path}: TIFF data ends inside a strip or tile ({got.size} of '
                         f'{size} bytes)')
    return got


def _unpredict(block: np.ndarray, rows: int, width: int, spp: int, bits: int,
               order: str) -> np.ndarray:
    """The horizontal predictor undone on a strip's or tile's rows."""
    if bits == 8:
        s = block[:rows * width * spp].reshape(rows, width, spp).astype(np.uint32)
        return np.cumsum(s, axis=1).astype(np.uint8).reshape(-1)
    s = block[:rows * width * spp * 2].view(order + 'u2').reshape(rows, width, spp).astype(np.uint32)
    return np.cumsum(s, axis=1).astype(order + 'u2').view(np.uint8).reshape(-1)


def _unpack_bits(rows: np.ndarray, bits: int, n: int) -> np.ndarray:
    """[H, rowbytes] -> [H, n] samples of ``bits`` bits, MSB first."""
    if bits == 8:
        return rows[:, :n]
    per = 8 // bits
    vals = np.stack([(rows >> (8 - bits * (k + 1))) & ((1 << bits) - 1) for k in range(per)],
                    axis=-1).reshape(rows.shape[0], -1)
    return vals[:, :n]


def decode_tiff(data: bytes, path: str = 'TIFF data'):
    """The first page of a TIFF -> (pixels, mode, palette) as Pillow's
    ``Image.open`` gives it."""
    order, tags, lost = _tags(data, path)
    compression = _one(tags, 259, 1)
    if compression not in _COMPRESSIONS:
        raise refused(path, _REFUSED_COMPRESSIONS.get(compression, f'compression {compression}'))
    if lost and compression != 1:        # libtiff reads the whole directory or fails
        raise ValueError(f'{path}: the TIFF directory runs past the file')
    photo = _one(tags, 262, 0)
    if photo in (6, 8):
        raise refused(path, _PHOTOMETRIC[photo])
    if _one(tags, 274, 1) not in _ORIENT:
        raise ValueError(f'{path}: TIFF Orientation {_one(tags, 274)} does not exist')
    width, height = _one(tags, 256), _one(tags, 257)
    if not width or not height:
        raise ValueError(f'{path}: a TIFF without its dimensions')
    fillorder = _one(tags, 266, 1)
    planar = _one(tags, 284, 1)
    sample_format = tags.get(339, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps = tags.get(258, (1,))
    extra = tags.get(338, ())
    spp = _one(tags, 277, 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if 3 in sample_format:
        raise refused(path, 'float-sample')
    key = (photo, sample_format, bps, extra)
    if key not in _OPEN or (photo == 0 and bps == (16,) and order == '>'):
        raise refused(path, f'{_PHOTOMETRIC.get(photo, f"photometric {photo}")} '
                      f'{"/".join(map(str, bps))}-bit (sample format {sample_format}, extra '
                      f'samples {extra})')
    mode, raw_mode = _OPEN[key]
    bits = bps[0]
    if fillorder == 2 and compression == 1 and (raw_mode == 'L;I' or (mode == 'P' and bits < 8)):
        raise ValueError(f'{path}: an uncompressed {raw_mode} TIFF at {bits} bits with FillOrder '
                         '2, which Pillow does not read either (it has no such raw mode)')
    predictor = _one(tags, 317, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2) or (predictor == 2 and bits not in (8, 16)):
        raise refused(path, f'predictor {predictor} at {bits} bits')
    # the sample rows of each plane, assembled from its strips or tiles
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp
    rowbytes = (width * per * bits + 7) // 8
    image = np.zeros((planes, height, rowbytes), np.uint8)
    counts = tags.get(279) or tags.get(325)
    if 324 in tags:
        tw, th = _one(tags, 322), _one(tags, 323)
        offsets = tags[324]
        across, down = -(-width // tw), -(-height // th)
        trow = (tw * per * bits + 7) // 8
        if len(offsets) < planes * across * down:
            raise ValueError(f'{path}: {len(offsets)} TIFF tiles for {planes * across * down}')
        for k in range(planes * across * down):
            p, rest = divmod(k, across * down)
            ty, tx = divmod(rest, across)
            block = _chunk(data, offsets[k], counts[k] if counts and compression != 1 else None,
                           th * trow, compression, fillorder, path)
            if predictor == 2:
                block = _unpredict(block, th, tw, per, bits, order)
            block = block.reshape(th, trow)
            y0, x0 = ty * th, tx * tw * per * bits // 8
            rows, cols = min(th, height - y0), min(trow, rowbytes - x0)
            image[p, y0:y0 + rows, x0:x0 + cols] = block[:rows, :cols]
    else:
        if 273 not in tags:
            raise ValueError(f'{path}: a TIFF without strips or tiles')
        offsets = tags[273]
        rps = min(_one(tags, 278, height), height)
        strips = -(-height // rps)
        if len(offsets) < planes * strips:
            raise ValueError(f'{path}: {len(offsets)} TIFF strips for {planes * strips}')
        for k in range(planes * strips):
            p, s = divmod(k, strips)
            rows = min(rps, height - s * rps)
            block = _chunk(data, offsets[k], counts[k] if counts and compression != 1 else None,
                           rows * rowbytes, compression, fillorder, path)
            if predictor == 2:
                block = _unpredict(block, rows, width, per, bits, order)
            image[p, s * rps:s * rps + rows] = block[:rows * rowbytes].reshape(rows, rowbytes)
    # samples [H, W, spp]
    if bits == 16:
        samples = np.stack([image[p].view(order + 'u2').reshape(height, -1)
                            for p in range(planes)], -1).reshape(height, width, spp)
    else:
        samples = np.stack([_unpack_bits(image[p], bits, width * per) for p in range(planes)],
                           -1).reshape(height, width, spp)
    pixels, mode, palette = _to_mode(samples, mode, raw_mode, bits, order, tags, path)
    return np.ascontiguousarray(_ORIENT[_one(tags, 274, 1)](pixels)), mode, palette


# Orientation as Pillow applies it when it loads a TIFF (exif_transpose)
_ORIENT = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
           6: lambda a: np.rot90(a, -1), 7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
           8: lambda a: np.rot90(a, 1)}


def _to_mode(samples: np.ndarray, mode: str, raw_mode: str, bits: int, order: str, tags,
             path: str):
    palette = None
    if mode == '1':
        px = samples[:, :, 0] != 0
        return (~px if raw_mode.endswith('I') else px), mode, None
    if mode == 'I;16':
        px = samples[:, :, 0]
        return (px.astype('>u2'), 'I;16B', None) if order == '>' else (px.astype(np.uint16),
                                                                       mode, None)
    if bits == 16:                     # Pillow keeps the high byte of 16-bit colour samples
        samples = (samples >> 8).astype(np.uint8)
    if mode == 'L':
        scale = {2: 0x55, 4: 0x11}.get(bits, 1)
        px = samples[:, :, 0].astype(np.uint8) * np.uint8(scale)
        return (255 - px if raw_mode.endswith('I') else px), mode, None
    if mode == 'P':
        cmap = tags.get(320)
        n = 1 << bits
        if cmap is None or len(cmap) < 3 * n:
            raise ValueError(f'{path}: a palette TIFF without its colormap')
        hi = (np.asarray(cmap[:3 * n], np.uint32) // 256).astype(np.uint8).reshape(3, n)
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        palette[:n, :3] = hi.T
        return samples[:, :, 0].astype(np.uint8), mode, palette
    px = samples.astype(np.uint8)
    if mode == 'LA':
        return px[:, :, :2].copy(), mode, None
    if mode == 'CMYK':
        return px[:, :, :4].copy(), mode, None
    if mode == 'RGB':
        return px[:, :, :3].copy(), mode, None
    rgba = px[:, :, :4].copy()
    if raw_mode == 'RGBa':             # Unpack.c's unpackRGBa: unpremultiplied
        a = rgba[:, :, 3:4].astype(np.int32)
        rgb = rgba[:, :, :3].astype(np.int32)
        un = np.clip(rgb * 255 // np.maximum(a, 1), 0, 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, un))
        rgba[:, :, :3] = rgb.astype(np.uint8)
        rgba[:, :, 3] = np.where(a[:, :, 0] == 0, 0, rgba[:, :, 3])
    return rgba, mode, None
