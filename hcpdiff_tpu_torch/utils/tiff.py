"""TIFF reading as Pillow's ``Image.open`` gives it (``TiffImagePlugin``:
its own raw decoder for uncompressed data, libtiff for the rest), without
Pillow: the first page's IFD here; LZW, PackBits, CCITT fax, ThunderScan
and ZSTD in C++ and JPEG through the port's JPEG decoder
(``csrc/image_decode.cpp`` through ``utils/native.py``); Deflate through
``zlib`` and LZMA through ``lzma``.

- Classic TIFF and BigTIFF (version 43: 8-byte offsets and counts, the
  types LONG8, SLONG8 and IFD8); byte orders II and MM; strips and tiles;
  PlanarConfiguration 1 and 2; FillOrder 2 (each byte's bits reversed
  before decoding, as libtiff does; uncompressed MinIsWhite 8-bit and
  palette below 8 bits raise, as Pillow has no raw mode for them); the
  Orientation tag applied as Pillow applies it on load.
- Compression: none, PackBits, LZW (new style, and the old LSB-first kind
  libtiff still reads), Deflate (8 and 32946), LZMA (34925), ZSTD (50000), CCITT
  modified Huffman (2), RLEW (32771), group 3 (3: 1-D or 2-D by
  T4Options, EOL fill bits) and group 4 (4), ThunderScan (32809); JPEG
  (7): each strip or tile its own stream with JPEGTables in front, YCbCr
  converted to RGB by libjpeg (libtiff's JPEGCOLORMODE_RGB, which Pillow
  asks for), other photometrics left as stored; old-style JPEG (6) whose
  JPEGInterchangeFormat tag points to a whole stream, its raw YCbCr
  converted by libtiff's tables. The horizontal predictor (2) at 8, 16 and
  32 bits and the floating-point predictor (3) after LZW, Deflate, LZMA
  and ZSTD, as libtiff applies them.
- Samples, with the mode Pillow's ``OPEN_INFO`` gives them: MinIsWhite and
  MinIsBlack at 1, 2, 4 and 8 bits ('1' or 'L', MinIsWhite inverted),
  12 ('I;16', II only) and 16 ('I;16', or 'I;16B' from MM; MinIsWhite
  16-bit is not inverted, as Pillow reads it), signed 16 and 32 bits and
  unsigned 32 bits (II only) as 'I', 32-bit float as 'F' (libtiff hands
  Pillow native-order samples, which it reads as MM's big-endian raw
  modes: a compressed MM file of signed or float samples reads with its
  bytes swapped, as Pillow reads it), grey + alpha ('LA'), RGB at 8 and 16
  bits with ExtraSamples (unspecified: 'RGB', associated alpha: 'RGBA'
  unpremultiplied as Pillow's 'RGBa' unpacker does, unassociated:
  'RGBA'; 16-bit samples keep their high byte), palette at 1, 2, 4 and 8
  bits ('P', the colormap's high bytes), CMYK at 8 and 16 bits, and YCbCr
  (compressed: 'RGB' through libtiff's TIFFRGBAImage, each subsampled
  chroma sample replicated over its block, in one plane or in three
  without subsampling, and ``TIFFYCbCrToRGB``'s integer tables built from
  YCbCrCoefficients and ReferenceBlackWhite; one sample: 'L').

  CIELab at 8 bits reads as 'LAB', the file's bytes (``utils/cielab.py``
  converts it to RGB as Pillow's LittleCMS transform does).
- Uncompressed YCbCr as Pillow reads it: its own raw decoder with the raw
  mode 'RGBX', 4 bytes a pixel from each strip's offset (into what follows
  the strip), truncated where the file ends first; in separate planes,
  each plane's bytes as R, G and B.

What Pillow does not read either raises a ``ValueError`` naming the file
and the kind: WebP-compressed TIFF and compressions Pillow does not name,
compressed YCbCr subsampled in separate planes,
big-endian BigTIFF (Pillow takes the version from byte 2 alone), old-style
JPEG with neither its JPEGInterchangeFormat tag nor a stream in its strips,
sample layouts ``OPEN_INFO`` has no entry for. An RLEW strip that libtiff
misreads (a bad code word after it aligns a row on an odd byte, where
Pillow returns a damaged image) raises. Corrupt or cut data raises a
``ValueError`` naming the file.
"""
from __future__ import annotations

import functools
import lzma
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from . import native

_TYPES = {1: 'B', 2: 'B', 3: 'H', 4: 'I', 5: 'II', 6: 'b', 7: 'B', 8: 'h', 9: 'i', 10: 'ii',
          11: 'f', 12: 'd', 13: 'I', 16: 'Q', 17: 'q', 18: 'Q'}
_COMPRESSIONS = {1: 'uncompressed', 2: 'CCITT modified Huffman', 3: 'CCITT group 3',
                 4: 'CCITT group 4', 5: 'LZW', 6: 'old-style JPEG', 7: 'JPEG', 8: 'Deflate',
                 32771: 'CCITT RLEW', 32773: 'PackBits', 32809: 'ThunderScan',
                 32946: 'Deflate', 34925: 'LZMA', 50000: 'ZSTD'}
_FAX = (2, 3, 4, 32771)
# a codec Pillow names but its libtiff lacks, so that Pillow fails too
_PILLOW_LACKS = {50001: 'WebP-compressed'}
_PHOTOMETRIC = {0: 'MinIsWhite', 1: 'MinIsBlack', 2: 'RGB', 3: 'palette', 5: 'CMYK',
                6: 'YCbCr', 8: 'CIELab'}


def unread(path: str, what: str) -> ValueError:
    """The error of a TIFF kind Pillow does not read either."""
    return ValueError(f'{path}: {what} TIFF images are read neither by Pillow nor by the PyTorch '
                      'port; convert it to a PNG or a JPEG')


def _tags(data: bytes, path: str) -> Tuple[str, Dict[int, tuple], object]:
    """The byte order ('<' or '>'), the first IFD's tags (each a tuple of
    values), and what was lost: True where the IFD is cut short, else the
    set of tags whose values lie past the file. As Pillow's
    ``ImageFileDirectory_v2.load``: an IFD cut short keeps the entries read
    whole, and a tag whose values lie past the file is skipped."""
    order = '<' if data[:2] == b'II' else '>'
    big = data[2:4] in (b'+\0', b'\0+')
    if big and order == '>':             # Pillow takes byte 2 for the version
        raise unread(path, 'big-endian BigTIFF')
    if big:
        size, _, ifd = struct.unpack(order + 'HHQ', data[4:16])
        if size != 8:
            raise ValueError(f'{path}: a BigTIFF with {size}-byte offsets')
        count_fmt, entry_fmt, entry_size, inline, off_fmt = 'Q', 'HHQ8s', 20, 8, 'Q'
    else:
        (ifd,) = struct.unpack(order + 'I', data[4:8])
        count_fmt, entry_fmt, entry_size, inline, off_fmt = 'H', 'HHI4s', 12, 4, 'I'
    head = struct.calcsize(count_fmt)
    if ifd + head > len(data):
        raise ValueError(f'{path}: the TIFF IFD offset {ifd} is past the file')
    (count,) = struct.unpack(order + count_fmt, data[ifd:ifd + head])
    tags, lost = {}, set()
    for k in range(count):
        at = ifd + head + entry_size * k
        if at + entry_size > len(data):
            lost = True
            break
        tag, typ, n, raw = struct.unpack(order + entry_fmt, data[at:at + entry_size])
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(order + fmt) * n
        if size > inline:
            (off,) = struct.unpack(order + off_fmt, raw)
            if off + size > len(data):
                lost.add(tag)
                continue
            raw = data[off:off + size]
        tags[tag] = struct.unpack(order + fmt * n, raw[:size])
    return order, tags, lost


def dimensions(data: bytes, path: str = 'TIFF data') -> Tuple[int, int]:
    """(width, height) of a TIFF's first page as Pillow's ``size`` gives it
    (swapped by Orientation 5-8), from its IFD alone."""
    _, tags, _ = _tags(data, path)
    width, height = _one(tags, 256), _one(tags, 257)
    if not width or not height:
        raise ValueError(f'{path}: a TIFF without its dimensions')
    return (height, width) if _one(tags, 274, 1) in (5, 6, 7, 8) else (width, height)


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None else v[0]


def _floats(tags, tag, default):
    """A RATIONAL tag's values as libtiff keeps them (float of the double
    quotient)."""
    v = tags.get(tag)
    if v is None:
        return np.asarray(default, np.float32)
    return np.asarray([float(np.float64(v[i]) / v[i + 1]) if v[i + 1] else 0.0
                       for i in range(0, len(v), 2)], np.float32)


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
    (1, (1,), (12,), ()): ('I;16', 'I;12'),
    (1, (2,), (16,), ()): ('I', 'I;16S'), (1, (2,), (32,), ()): ('I', 'I;32S'),
    (1, (1,), (32,), ()): ('I', 'I;32N'),
    (0, (3,), (32,), ()): ('F', 'F;32F'), (1, (3,), (32,), ()): ('F', 'F;32F'),
    (1, (1,), (8, 8), (2,)): ('LA', 'LA'),
    (2, (1,), (8,) * 4, (999,)): ('RGBA', 'RGBA'),
    (5, (1,), (8,) * 5, (0,)): ('CMYK', 'CMYK'),
    (5, (1,), (8,) * 6, (0, 0)): ('CMYK', 'CMYK'),
    (6, (1,), (8, 8, 8), ()): ('RGB', 'RGBX'), (6, (1,), (8,), ()): ('L', 'L'),
    (8, (1,), (8, 8, 8), ()): ('LAB', 'LAB'),
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
# entries OPEN_INFO has for II only
_II_ONLY = {(1, (1,), (12,), ()), (1, (1,), (32,), ())}


def _reverse_bits(buf: bytes) -> bytes:
    table = bytes(int(f'{i:08b}'[::-1], 2) for i in range(256))
    return buf.translate(table)


class _Layout:
    """What decoding a strip or tile needs to know of the image."""

    def __init__(self, tags, compression, fillorder, path):
        self.compression, self.fillorder, self.path = compression, fillorder, path
        tables = tags.get(347)
        self.jpeg_tables = bytes(tables) if tables else b''
        self.t4 = _one(tags, 292, 0)
        self.t6 = _one(tags, 293, 0)


def _cut(path):
    return ValueError(f'{path}: TIFF data ends inside a strip or tile')


def _chunk(data: bytes, off: int, count: Optional[int], size: int, lay: _Layout, width: int,
           rows: int) -> np.ndarray:
    """One strip or tile's ``size`` decoded bytes (``width`` pixels by
    ``rows`` for the codecs that need them)."""
    path, compression = lay.path, lay.compression
    if off >= len(data) or (count is not None and off + count > len(data)):
        raise _cut(path)
    raw = data[off:off + count] if count is not None else data[off:off + size]
    if lay.fillorder == 2:
        raw = _reverse_bits(raw)
    if compression == 1:
        if len(raw) < size:
            raise _cut(path)
        return np.frombuffer(raw[:size], np.uint8)
    try:
        if compression in (8, 32946):
            got = np.frombuffer(zlib.decompressobj().decompress(raw, size), np.uint8)
        elif compression == 34925:
            got = np.frombuffer(lzma.LZMADecompressor().decompress(raw, size), np.uint8)
        elif compression == 5:
            return native.tiff_lzw(raw, size)
        elif compression == 32773:
            return native.packbits(raw, size)
        elif compression == 50000:
            got = native.zstd(raw, size)
        elif compression in _FAX:
            return native.fax(raw, compression, width, rows, lay.t4 if compression == 3 else lay.t6)
        else:
            return native.thunderscan(raw, width, rows)
    except (zlib.error, lzma.LZMAError) as e:
        raise ValueError(f'{path}: corrupt {_COMPRESSIONS[compression]} TIFF data ({e})') from e
    except ValueError as e:
        raise ValueError(f'{path}: {e}') from e
    if got.size < size:
        raise ValueError(f'{path}: TIFF data ends inside a strip or tile ({got.size} of '
                         f'{size} bytes)')
    return got


def _jpeg_chunk(data: bytes, off: int, count: int, lay: _Layout, colour: str) -> np.ndarray:
    """A JPEG-in-TIFF strip or tile decoded with JPEGTables in front ->
    uint8 [h, w, c]."""
    if count is None or off + count > len(data):
        raise _cut(lay.path)
    stream = data[off:off + count]
    tables = lay.jpeg_tables
    if tables:
        stream = (tables[:-2] if tables.endswith(b'\xff\xd9') else tables) + (
            stream[2:] if stream.startswith(b'\xff\xd8') else stream)
    try:
        return native.jpeg_decode(_eoi(stream), colour)
    except native.JPEGError as e:
        raise ValueError(f'{lay.path}: corrupt JPEG data in a TIFF strip or tile ({e})') from None


def _eoi(stream: bytes) -> bytes:
    """libtiff's JPEG source managers insert an EOI where the data ends
    (libjpeg then reads zeros for what is missing)."""
    return stream if stream.endswith(b'\xff\xd9') else stream + b'\xff\xd9'


def _unpredict(block: np.ndarray, rows: int, width: int, spp: int, bits: int, order: str,
               predictor: int) -> np.ndarray:
    """The horizontal (2) or floating-point (3) predictor undone on a strip's
    or tile's rows, as libtiff's horAcc8/16/32 and fpAcc do; fpAcc leaves
    the samples in the host's (little-endian) order."""
    n = rows * width * spp
    if predictor == 3:
        bps = bits // 8
        b = block[:n * bps].reshape(rows, width * spp * bps).astype(np.uint32)
        acc = np.zeros_like(b)
        for s in range(spp):                    # a running sum over each sample's bytes
            acc[:, s::spp] = np.cumsum(b[:, s::spp], axis=1)
        planes = (acc & 0xFF).astype(np.uint8).reshape(rows, bps, width * spp)
        return planes[:, ::-1].transpose(0, 2, 1).reshape(-1).copy()
    if bits == 8:
        s = block[:n].reshape(rows, width, spp).astype(np.uint32)
        return np.cumsum(s, axis=1).astype(np.uint8).reshape(-1)
    kind = {16: 'u2', 32: 'u4'}[bits]
    s = block[:n * bits // 8].view(order + kind).reshape(rows, width, spp).astype(np.uint64)
    return np.cumsum(s, axis=1).astype(order + kind).view(np.uint8).reshape(-1)


def _unpack_bits(rows: np.ndarray, bits: int, n: int) -> np.ndarray:
    """[H, rowbytes] -> [H, n] samples of ``bits`` bits, MSB first."""
    if bits == 8:
        return rows[:, :n]
    if bits == 12:                             # two samples in three bytes
        r = rows[:, :3 * ((n + 1) // 2)].astype(np.uint16)
        if r.shape[1] < 3 * ((n + 1) // 2):
            r = np.pad(r, ((0, 0), (0, 3 * ((n + 1) // 2) - r.shape[1])))
        t = r.reshape(r.shape[0], -1, 3)
        out = np.stack([(t[..., 0] << 4) | (t[..., 1] >> 4), ((t[..., 1] & 15) << 8) | t[..., 2]],
                       -1).reshape(r.shape[0], -1)
        return out[:, :n]
    per = 8 // bits
    vals = np.stack([(rows >> (8 - bits * (k + 1))) & ((1 << bits) - 1) for k in range(per)],
                    axis=-1).reshape(rows.shape[0], -1)
    return vals[:, :n]


def decode_tiff(data: bytes, path: str = 'TIFF data'):
    """The first page of a TIFF -> (pixels, mode, palette) as Pillow's
    ``Image.open`` gives it."""
    order, tags, lost = _tags(data, path)
    compression = _one(tags, 259, 1)
    if compression in _PILLOW_LACKS:
        raise unread(path, _PILLOW_LACKS[compression])
    if compression not in _COMPRESSIONS:
        raise unread(path, f'compression {compression}')
    # libtiff reads the whole directory, and strip or tile offsets and
    # counts, or fails; another tag's values past the file it ignores
    if compression != 1 and (lost is True or lost & {273, 279, 324, 325}):
        raise ValueError(f'{path}: the TIFF directory runs past the file')
    photo = _one(tags, 262, 0)
    if compression == 6:                 # Pillow: old-style JPEG is YCbCr
        photo = 6
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
    spp = _one(tags, 277, 3 if compression == 6 and photo in (2, 6) else 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    key = (photo, sample_format, bps, extra)
    if key not in _OPEN or (photo == 0 and bps == (16,) and order == '>') or (
            order == '>' and key in _II_ONLY):
        raise unread(path, f'{_PHOTOMETRIC.get(photo, f"photometric {photo}")} '
                     f'{"/".join(map(str, bps))}-bit (sample format {sample_format}, extra '
                     f'samples {extra})')
    mode, raw_mode = _OPEN[key]
    bits = bps[0]
    if fillorder == 2 and compression == 1 and (raw_mode == 'L;I' or (mode == 'P' and bits < 8)):
        raise ValueError(f'{path}: an uncompressed {raw_mode} TIFF at {bits} bits with FillOrder '
                         '2, which Pillow does not read either (it has no such raw mode)')
    # YCbCr in separate planes: TIFFRGBAImage converts them where the chroma
    # is not subsampled (putseparate8bitYCbCr11tile); Pillow's raw decoder
    # reads uncompressed planes as R, G and B as they are
    planar_ycbcr = photo == 6 and spp == 3 and planar == 2 and compression != 1
    if planar_ycbcr and tuple(tags.get(530, (2, 2))) != (1, 1):
        raise unread(path, 'subsampled YCbCr in separate planes')
    if photo == 6 and spp == 3 and compression == 1 and planar == 1:
        pixels = _ycbcr_raw(data, tags, width, height, path)
        return np.ascontiguousarray(_ORIENT[_one(tags, 274, 1)](pixels)), 'RGB', None
    lay = _Layout(tags, compression, fillorder, path)
    if compression == 6:
        pixels = _ojpeg(data, tags, width, height, path)
        return np.ascontiguousarray(_ORIENT[_one(tags, 274, 1)](pixels)), 'RGB', None
    predictor = _one(tags, 317, 1) if compression in (5, 8, 32946, 34925, 50000) else 1
    if predictor not in (1, 2, 3) or (predictor == 2 and bits not in (8, 16, 32)) or (
            predictor == 3 and sample_format != (3,)):
        raise ValueError(f'{path}: TIFF predictor {predictor} at {bits} bits, which libtiff '
                         'refuses')
    ycbcr = photo == 6 and spp == 3 and compression != 7 and planar == 1
    sub = tags.get(530, (2, 2)) if ycbcr else (1, 1)
    # the sample rows of each plane, assembled from its strips or tiles
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp
    rowbytes = (width * per * bits + 7) // 8
    if ycbcr:                            # units of sub_h x sub_v Y samples, Cb, Cr
        unit = sub[0] * sub[1] + 2
        rowbytes = -(-width // sub[0]) * unit
    image = np.zeros((planes, height if not ycbcr else -(-height // sub[1]), rowbytes), np.uint8)
    counts = tags.get(279) or tags.get(325)
    jpeg = compression == 7
    colour = 'rgb' if jpeg and photo == 6 and planar == 1 else 'none'

    def chunk(k, size, w, rows):
        count = counts[k] if counts and compression != 1 else None
        if jpeg:
            px = _jpeg_chunk(data, offsets[k], count, lay, colour)
            got = np.zeros((rows, w, per), np.uint8)
            hh, ww = min(rows, px.shape[0]), min(w, px.shape[1])
            got[:hh, :ww] = px[:hh, :ww, :per]
            return got.reshape(-1)
        block = _chunk(data, offsets[k], count, size, lay, w, rows)
        if predictor != 1:
            block = _unpredict(block, rows, w, per, bits, order, predictor)
        return block

    if 324 in tags:
        tw, th = _one(tags, 322), _one(tags, 323)
        offsets = tags[324]
        across, down = -(-width // tw), -(-height // th)
        trow = (tw * per * bits + 7) // 8
        if ycbcr:
            trow, tunits = -(-tw // sub[0]) * unit, th // sub[1]
        if len(offsets) < planes * across * down:
            raise ValueError(f'{path}: {len(offsets)} TIFF tiles for {planes * across * down}')
        for k in range(planes * across * down):
            p, rest = divmod(k, across * down)
            ty, tx = divmod(rest, across)
            trows = tunits if ycbcr else th
            block = chunk(k, trows * trow, tw, th).reshape(trows, trow)
            if ycbcr and tuple(sub) == (4, 4) and (tx + 1) * tw > width:
                block = _skew44(block, tw, width - tx * tw)
            y0, x0 = ty * trows, tx * (trow if ycbcr else tw * per * bits // 8)
            rows, cols = min(trows, image.shape[1] - y0), min(trow, rowbytes - x0)
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
            if ycbcr:
                units = -(-rows // sub[1])
                block = chunk(k, units * rowbytes, width, rows)
                at = s * rps // sub[1]
                image[p, at:at + units] = block[:units * rowbytes].reshape(units, rowbytes)
                continue
            block = chunk(k, rows * rowbytes, width, rows)
            image[p, s * rps:s * rps + rows] = block[:rows * rowbytes].reshape(rows, rowbytes)
    if ycbcr:
        pixels = _ycbcr_units(image[0], sub, width, height, tags)
        return np.ascontiguousarray(_ORIENT[_one(tags, 274, 1)](pixels)), 'RGB', None
    if planar_ycbcr:
        pixels = ycbcr_to_rgb(image[0], image[1], image[2], tags)
        return np.ascontiguousarray(_ORIENT[_one(tags, 274, 1)](pixels)), 'RGB', None
    # samples [H, W, spp]
    if bits in (16, 32):
        kind = order + ('u2' if bits == 16 else 'u4')
        if predictor == 3:               # fpAcc leaves host-order samples
            kind = '<' + kind[1:]
        samples = np.stack([image[p].view(kind).reshape(height, -1)
                            for p in range(planes)], -1).reshape(height, width, spp)
    else:
        samples = np.stack([_unpack_bits(image[p], bits, width * per) for p in range(planes)],
                           -1).reshape(height, width, spp)
    # libtiff hands Pillow host-order samples, which MM's raw modes read as big-endian
    swapped = order == '>' and compression != 1 and raw_mode in ('I;16S', 'I;32S', 'F;32F')
    pixels, mode, palette = _to_mode(samples, mode, raw_mode, bits, order, tags, path, swapped)
    return np.ascontiguousarray(_ORIENT[_one(tags, 274, 1)](pixels)), mode, palette


# Orientation as Pillow applies it when it loads a TIFF (exif_transpose)
_ORIENT = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
           6: lambda a: np.rot90(a, -1), 7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
           8: lambda a: np.rot90(a, 1)}


def ycbcr_tables(tags):
    """tif_color.c's TIFFYCbCrToRGBInit: the integer tables (Cr_r, Cb_b,
    Cr_g, Cb_g, Y) from YCbCrCoefficients and ReferenceBlackWhite, in
    single precision as libtiff computes them."""
    luma = _floats(tags, 529, [0.299, 0.587, 0.114])
    ref = _floats(tags, 532, [0, 255, 128, 255, 128, 255])
    return _ycbcr_tables(tuple(luma.tolist()), tuple(ref.tolist()))


@functools.lru_cache(maxsize=16)
def _ycbcr_tables(luma, ref):
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    ref = [f32(v) for v in ref]

    def fix(x):
        return int(np.float64(np.float32(x) * f32(65536)) + 0.5)

    def clamp(f, lo, hi):
        return lo if not f >= lo else hi if f > hi else f

    f1 = f32(2) - f32(2) * lr
    f2 = lr * f1 / lg
    f3 = f32(2) - f32(2) * lb
    f4 = lb * f3 / lg
    d1, d2 = fix(clamp(f1, f32(0), f32(2))), -fix(clamp(f2, f32(0), f32(2)))
    d3, d4 = fix(clamp(f3, f32(0), f32(2))), -fix(clamp(f4, f32(0), f32(2)))

    def code2v(c, rb, rw, cr):
        den = rw - rb
        return f32(f32(c - int(rb)) * f32(cr)) / (den if den != 0 else f32(1))

    tabs = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = int(clamp(code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127), f32(-4096),
                       f32(4096)))
        cb = int(clamp(code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127), f32(-4096),
                       f32(4096)))
        tabs[0, i] = (d1 * cr + 32768) >> 16
        tabs[1, i] = (d3 * cb + 32768) >> 16
        tabs[2, i] = d2 * cr
        tabs[3, i] = d4 * cb + 32768
        tabs[4, i] = int(clamp(code2v(i, ref[0], ref[1], 255), f32(-4096), f32(4096)))
    return tabs


def ycbcr_to_rgb(y, cb, cr, tags) -> np.ndarray:
    """TIFFYCbCrtoRGB over uint8 planes of one shape -> uint8 [..., 3]."""
    cr_r, cb_b, cr_g, cb_g, y_tab = ycbcr_tables(tags)
    yy = y_tab[y]
    rgb = np.stack([yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _ycbcr_units(units: np.ndarray, sub, width: int, height: int, tags) -> np.ndarray:
    """TIFFRGBAImage's putcontig8bitYCbCr*tile: rows of units (sub_h x
    sub_v Y samples, then Cb and Cr) -> RGB [height, width, 3], each
    unit's chroma over its block."""
    sh, sv = sub
    ux = -(-width // sh)
    u = units[:, :ux * (sh * sv + 2)].reshape(units.shape[0], ux, sh * sv + 2)
    y = u[:, :, :sh * sv].reshape(-1, ux, sv, sh).transpose(0, 2, 1, 3).reshape(-1, ux * sh)
    cb = np.repeat(np.repeat(u[:, :, -2], sv, 0), sh, 1)
    cr = np.repeat(np.repeat(u[:, :, -1], sv, 0), sh, 1)
    return ycbcr_to_rgb(y[:height, :width], cb[:height, :width], cr[:height, :width], tags)


def _skew44(block: np.ndarray, tw: int, npix: int) -> np.ndarray:
    """A 4x4-subsampled tile clipped at the image's right edge as
    TIFFRGBAImage walks it: putcontig8bitYCbCr44tile skips the clipped
    units of each row with 4x2's unit size (10 bytes, not 18), so its later
    unit rows start early."""
    used = -(-npix // 4)
    stride = used * 18 + ((tw - npix) // 4) * 10
    flat = np.concatenate([block.reshape(-1), np.zeros(stride * block.shape[0], np.uint8)])
    out = np.zeros_like(block)
    for r in range(block.shape[0]):
        out[r, :used * 18] = flat[r * stride:r * stride + used * 18]
    return out


def _ycbcr_raw(data: bytes, tags, width: int, height: int, path: str) -> np.ndarray:
    """Uncompressed YCbCr as Pillow reads it: its own raw decoder with the
    raw mode 'RGBX' (4 bytes a pixel, the fourth dropped) over each strip's
    rows from the strip's offset, into whatever follows it; a file that
    ends first is truncated."""
    if 273 not in tags:
        raise unread(path, 'uncompressed tiled YCbCr')
    offsets = tags[273]
    rps = min(_one(tags, 278, height), height)
    if rps == height:                    # one strip: Pillow takes the last offset
        offsets = offsets[-1:]
    out = np.zeros((height, width, 3), np.uint8)
    for k, off in enumerate(offsets[:-(-height // rps)]):
        y = k * rps
        rows = min(rps, height - y)
        if off + rows * width * 4 > len(data):
            raise ValueError(f'{path}: image file is truncated (uncompressed YCbCr, which '
                             'Pillow reads as 4 bytes a pixel)')
        px = np.frombuffer(data, np.uint8, rows * width * 4, off).reshape(rows, width, 4)
        out[y:y + rows] = px[:, :, :3]
    return out


def _ojpeg(data: bytes, tags, width: int, height: int, path: str) -> np.ndarray:
    """Old-style JPEG whose JPEGInterchangeFormat (513) points to a whole
    stream: libtiff's OJPEG codec reads its raw YCbCr (no upsampling, no
    colour conversion) and TIFFRGBAImage converts it with its own tables,
    each chroma sample over its block."""
    at = _one(tags, 513)
    if at is not None:
        stream = data[at:at + _one(tags, 514, len(data) - at)]
    else:                                # the strips themselves, where they hold a stream
        offsets, counts = tags.get(273, ()), tags.get(279, ())
        stream = b''.join(data[o:o + c] for o, c in zip(offsets, counts))
        if not stream.startswith(b'\xff\xd8'):
            raise unread(path, 'old-style JPEG without JPEGInterchangeFormat or a stream in its '
                         'strips')
    if not stream:
        raise _cut(path)
    try:
        planes = native.jpeg_decode(_eoi(stream), 'raw')
    except native.JPEGError as e:
        raise ValueError(f'{path}: corrupt old-style JPEG data ({e})') from None
    if len(planes) == 1:
        return np.repeat(planes[0][:height, :width, None], 3, axis=2)
    if len(planes) != 3:
        raise unread(path, f'{len(planes)}-component old-style JPEG')
    y = planes[0][:height, :width]
    fy, fx = -(-y.shape[0] // planes[1].shape[0]), -(-y.shape[1] // planes[1].shape[1])
    cb = np.repeat(np.repeat(planes[1], fy, 0), fx, 1)[:y.shape[0], :y.shape[1]]
    cr = np.repeat(np.repeat(planes[2], fy, 0), fx, 1)[:y.shape[0], :y.shape[1]]
    return ycbcr_to_rgb(y, cb, cr, tags)


def _to_mode(samples: np.ndarray, mode: str, raw_mode: str, bits: int, order: str, tags,
             path: str, swapped: bool = False):
    palette = None
    if mode == '1':
        px = samples[:, :, 0] != 0
        return (~px if raw_mode.endswith('I') else px), mode, None
    if mode == 'I;16':
        px = samples[:, :, 0]
        if raw_mode == 'I;12':
            return px.astype(np.uint16), mode, None
        return (px.astype('>u2'), 'I;16B', None) if order == '>' else (px.astype(np.uint16),
                                                                       mode, None)
    if mode in ('I', 'F'):
        px = np.ascontiguousarray(samples[:, :, 0])
        if swapped:
            px = px.byteswap()
        if mode == 'F':
            return px.astype(np.uint32).view(np.float32), mode, None
        if raw_mode == 'I;16S':
            return px.astype(np.uint16).view(np.int16).astype(np.int32), mode, None
        return px.astype(np.uint32).view(np.int32), mode, None
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
    if mode in ('RGB', 'LAB'):
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
