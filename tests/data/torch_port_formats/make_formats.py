"""Writes this folder's images from seeded arrays, committed so that a host
without Pillow can read and train on them, and ``expected.json``: for every
file here and in ``../torch_port_jpeg``, the sha256 and shape of what the
JAX package's Pillow calls give, ``composite_rgba(Image.open(f))`` ('rgb')
and ``Image.open(f).convert('L')`` ('l').

Pillow writes what it can (progressive, greyscale-progressive and CMYK
JPEG, the 8-bit palette PNG with ``tRNS``, LA, 16-bit grey, the GIF, the
8-bit and 24-bit BMPs). What it cannot write comes from the small writers
below, with Pillow still the oracle that reads them: JPEGs at 4:4:0, 4:1:1
and YCCK (baseline, annex K's tables), PNGs at 2/4/16 bits and with Adam7
interlacing (every row filter), a 32-bit BI_BITFIELDS BMP with an alpha
mask, 16-bit 565 and RLE8/RLE4 BMPs.

    python tests/data/torch_port_formats/make_formats.py
"""
import hashlib
import json
import os
import struct
import sys
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(DATA)))

from hcpdiff_tpu_torch.utils import jpeg  # noqa: E402

SIZE = (131, 203)                        # (h, w) of most files
SMALL = (45, 67)                         # uncompressed and 16-bit files


def photo(h, w, channels=3, seed=0, cell=24, noise=3.0):
    """Bicubic-enlarged random cells with a little noise: uint8 [h, w, c]."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (h // cell + 2, w // cell + 2, channels), dtype=np.uint8)
    out = []
    for c in range(channels):
        out.append(np.asarray(Image.fromarray(cells[:, :, c]).resize((w, h), Image.BICUBIC),
                              np.float32))
    img = np.stack(out, -1) + rng.normal(0, noise, (h, w, channels))
    return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ JPEG

def _segment(marker, payload):
    return struct.pack('>BBH', 0xFF, marker, len(payload) + 2) + payload


def _downsample(plane, fy, fx, rows, cols):
    """Means of fy x fx cells of the edge-padded plane -> [rows, cols]."""
    p = np.pad(plane, ((0, rows * fy - plane.shape[0]), (0, cols * fx - plane.shape[1])),
               mode='edge')
    return (p.reshape(rows, fy, cols, fx).mean(axis=(1, 3)) + 0.5).astype(np.int64)


def jpeg_sampled(planes, factors, quality=90, adobe=None):
    """A baseline JPEG of 8-bit planes ([C, H, W]) with sampling factors
    [(h, v)] a component, one interleaved scan, annex K's tables (table 0
    for the first and fourth component, 1 for the others); JFIF, or an
    Adobe APP14 segment with transform ``adobe``."""
    nc, height, width = planes.shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    qt = jpeg.quality_tables(quality)
    tables = [0, 1, 1, 0][:nc]
    coefs = []
    for k, (h, v) in enumerate(factors):
        dw, dh = -(-width * h // hmax), -(-height * v // vmax)
        plane = _downsample(planes[k].astype(np.int64), vmax // v, hmax // h, dh, dw)
        coefs.append(jpeg._component_coefs(plane, mcuy * v, mcux * h, qt[tables[k]]))
    blocks, comp = [], []
    for my in range(mcuy):
        for mx in range(mcux):
            for k, (h, v) in enumerate(factors):
                for y in range(v):
                    for x in range(h):
                        blocks.append(coefs[k][my * v + y, mx * h + x])
                        comp.append(k)
    out = [b'\xff\xd8']
    if adobe is None:
        out.append(_segment(0xE0, b'JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00'))
    else:
        out.append(_segment(0xEE, b'Adobe' + struct.pack('>HHHB', 100, 0, 0, adobe)))
    for t in sorted(set(tables)):
        out.append(_segment(0xDB, bytes([t]) + qt[t][jpeg.ZIGZAG].astype(np.uint8).tobytes()))
    out.append(_segment(0xC0, struct.pack('>BHHB', 8, height, width, nc) + b''.join(
        bytes([k + 1, (h << 4) | v, tables[k]]) for k, (h, v) in enumerate(factors))))
    for t in sorted(set(tables)):
        out.append(_segment(0xC4, bytes([t]) + jpeg._STD_HUFFMAN[2 * t]))
        out.append(_segment(0xC4, bytes([0x10 | t]) + jpeg._STD_HUFFMAN[2 * t + 1]))
    out.append(_segment(0xDA, bytes([nc]) + b''.join(
        bytes([k + 1, (t << 4) | t]) for k, t in enumerate(tables)) + b'\x00\x3f\x00'))
    out.append(jpeg.entropy_code(np.stack(blocks), np.asarray(comp), tables))
    out.append(b'\xff\xd9')
    return b''.join(out)


def ycc_planes(rgb):
    return jpeg.rgb_to_ycc(rgb).astype(np.uint8)


# ------------------------------------------------------------------- PNG

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunk(kind, data):
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack_rows(samples, depth):
    """[h, w, c] samples -> [h, rowbytes] bytes of one image or pass."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype('>u2').view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    per = 8 // depth
    flat = samples.reshape(h, w * c).astype(np.uint8)
    flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
    flat = flat.reshape(h, -1, per)
    out = np.zeros(flat.shape[:2], np.uint8)
    for k in range(per):
        out |= flat[:, :, k] << (8 - depth * (k + 1))
    return out


def _filter_rows(rows, bpp, kinds):
    """PNG-filter each row, the filter types taken from ``kinds`` in turn."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = kinds[y % len(kinds)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b''.join(out)


def png_bytes(samples, depth, color, plte=None, trns=None, interlace=False,
              kinds=(0, 1, 2, 3, 4)):
    """A PNG of samples [h, w, c] (palette indices for colour type 3) at
    ``depth`` bits, each row filtered by the next type of ``kinds``."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    data = b''
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(_pack_rows(sub, depth), bpp, kinds)
    out = b'\x89PNG\r\n\x1a\n' + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, color, 0,
                                                            0, int(interlace)))
    if plte is not None:
        out += _chunk(b'PLTE', plte)
    if trns is not None:
        out += _chunk(b'tRNS', trns)
    return out + _chunk(b'IDAT', zlib.compress(data, 9)) + _chunk(b'IEND', b'')


# ------------------------------------------------------------------- BMP

def bmp_bytes(rows, bits, width, height, compression=0, palette=b'', masks=None, v4=False,
              top_down=False):
    """A BMP of raw pixel rows (``rows``: the pixel data as stored),
    a 40-byte info header (masks after it) or a 108-byte V4 header (masks
    in it)."""
    hsize = 108 if v4 else 40
    extra = b''
    head = struct.pack('<IiiHHIIiiII', hsize, width, -height if top_down else height, 1, bits,
                       compression, len(rows), 2835, 2835, len(palette) // 4, 0)
    if v4:
        head += struct.pack('<IIII', *masks) + b'BGRs' + bytes(36) + bytes(12)
    elif masks is not None:
        extra = struct.pack('<III', *masks[:3])
    offset = 14 + hsize + len(extra) + len(palette)
    body = head + extra + palette + rows
    return b'BM' + struct.pack('<IHHI', 14 + len(body), 0, 0, offset) + body


def _stride(width, bits):
    return ((width * bits + 31) >> 3) & ~3


def bmp_rows(pixels, bits):
    """Bottom-up rows, each padded to 4 bytes, of indices or packed pixels
    ([h, w] for 8/16 bits as bytes already, [h, w * bytes])."""
    h = pixels.shape[0]
    rows = pixels.reshape(h, -1)[::-1]
    pad = _stride(rows.shape[1] * 8 // bits, bits) - rows.shape[1] if bits >= 8 else 0
    return np.pad(rows, ((0, 0), (0, pad))).astype(np.uint8).tobytes()


def rle_encode(indices, rle4):
    """RLE8 (or RLE4) of bottom-up rows: runs of equal pixels as encoded
    runs, the rest as absolute runs (even lengths for RLE4), word-aligned."""
    out = bytearray()
    for row in indices[::-1]:
        row = row.tolist()
        x = 0
        while x < len(row):
            run = 1
            limit = 255
            while x + run < len(row) and run < limit and row[x + run] == row[x]:
                run += 1
            if run >= 3 or len(row) - x < 4:
                n = min(run, len(row) - x)
                out += bytes([n, (row[x] << 4 | row[x]) if rle4 else row[x]])
                x += n
                continue
            n = 3
            while x + n < len(row) and n < 254 and row[x + n] != row[x + n - 1]:
                n += 1
            if rle4:
                n -= n % 2
                if n < 4:                       # absolute runs of 1 or 2 are escapes
                    out += bytes([1, row[x] << 4])
                    x += 1
                    continue
                vals = row[x:x + n]
                data = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, n, 2))
            else:
                data = bytes(row[x:x + n])
            out += bytes([0, n]) + data
            if len(data) % 2:
                out += b'\0'
            x += n
        out += b'\x00\x00'
    return bytes(out + b'\x00\x01')


# ------------------------------------------------------------------ TIFF

def lzw_encode(data):
    """TIFF LZW (MSB first from 9 bits, the width growing a code early, a
    clear code when the table fills), as libtiff writes it."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, nbits):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, nbits = reset()
    put(256, nbits)
    w = b''
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], nbits)
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            put(256, nbits)
            table, nxt, nbits = reset()
        elif nxt > (1 << nbits) - 1:
            nbits += 1
        w = bytes([c])
    if w:
        put(table[w], nbits)
        nxt += 1
        if nxt > (1 << nbits) - 1:
            nbits += 1
    put(257, nbits)
    if nacc:
        put(0, 8 - nacc)
    return bytes(out)


def packbits_encode(data):
    """PackBits: runs of 3-128 equal bytes as repeats, the rest literals."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + bytes(data[i:j])
        i = j
    return bytes(out)


def _reverse_bits(buf):
    return bytes(int(f'{b:08b}'[::-1], 2) for b in buf)


def _pack_samples(samples, bits):
    """[h, w, c] samples -> [h, rowbytes] bytes, MSB first (16 bits as
    native uint16 values, swapped by the caller)."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if bits == 16:
        return flat.astype(np.uint16)
    if bits == 8:
        return flat.astype(np.uint8)
    return _pack_rows(samples, bits)


def tiff_bytes(samples, bits, photometric, order='<', compression=1, predictor=1, planar=1,
               rows_per_strip=None, tile=None, extra=(), colormap=None, fillorder=1,
               sample_format=None, orientation=None):
    """A one-page TIFF of samples [h, w, spp] (values below 2**bits) with
    the given layout; every chunk compressed as ``compression`` says (1
    none, 5 LZW, 8 Deflate, 32773 PackBits), after the horizontal
    ``predictor`` (2) where set."""
    h, w, spp = samples.shape
    planes = [samples[:, :, k:k + 1] for k in range(spp)] if planar == 2 else [samples]
    chunks = []

    def encode(block, per):
        if predictor == 2:                # each sample less the one a pixel to its left
            block = block.astype(np.int64)
            block[:, per:] = block[:, per:] - block[:, :-per]
            block = block & ((1 << bits) - 1)
        if bits == 16:
            raw = block.astype(order + 'u2').tobytes()
        else:
            raw = _pack_samples(block.reshape(block.shape[0], -1, 1), bits).tobytes() \
                if bits < 8 else block.astype(np.uint8).tobytes()
        if compression == 5:
            raw = lzw_encode(raw)
        elif compression in (8, 32946):
            raw = zlib.compress(raw, 9)
        elif compression == 32773:
            raw = packbits_encode(raw)
        return _reverse_bits(raw) if fillorder == 2 else raw

    for plane in planes:
        per = plane.shape[2]
        if tile is None:
            rps = rows_per_strip or h
            for y in range(0, h, rps):
                rows = plane[y:y + rps]
                chunks.append(encode(rows.reshape(-1, w * per) if bits >= 8 else rows, per))
        else:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, per), samples.dtype)
                    part = plane[ty:ty + th, tx:tx + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(t.reshape(th, tw * per) if bits >= 8 else t, per))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if fillorder != 1:
        entries[266] = (3, [fillorder])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(colormap))
    if sample_format is not None:
        entries[339] = (3, [sample_format] * spp)
    if orientation is not None:
        entries[274] = (3, [orientation])
    body = bytearray()
    offsets = []
    for c in chunks:
        offsets.append(8 + len(body))
        body += c + (b'\0' if len(c) % 2 else b'')
    if tile is None:
        entries[273] = (4, offsets)
        entries[278] = (4, [rows_per_strip or h])
        entries[279] = (4, [len(c) for c in chunks])
    else:
        entries[322], entries[323] = (3, [tile[0]]), (3, [tile[1]])
        entries[324] = (4, offsets)
        entries[325] = (4, [len(c) for c in chunks])
    ifd_at = 8 + len(body)
    n = len(entries)
    extra_at = ifd_at + 2 + 12 * n + 4
    ifd, tail = struct.pack(order + 'H', n), bytearray()
    for tag in sorted(entries):
        typ, vals = entries[tag]
        fmt = order + ('H' if typ == 3 else 'I') * len(vals)
        packed = struct.pack(fmt, *vals)
        if len(packed) <= 4:
            ifd += struct.pack(order + 'HHI', tag, typ, len(vals)) + packed.ljust(4, b'\0')
        else:
            ifd += struct.pack(order + 'HHII', tag, typ, len(vals), extra_at + len(tail))
            tail += packed
    head = (b'II*\0' if order == '<' else b'MM\0*') + struct.pack(order + 'I', ifd_at)
    return head + bytes(body) + ifd + b'\0\0\0\0' + bytes(tail)


# ------------------------------------------------------------ WebP, ICO

def riff(chunks):
    """A RIFF WEBP file of (fourcc, payload) chunks, odd sizes padded."""
    body = b''.join(k + struct.pack('<I', len(p)) + p + (b'\0' if len(p) % 2 else b'')
                    for k, p in chunks)
    return b'RIFF' + struct.pack('<I', 4 + len(body)) + b'WEBP' + body


def webp_chunks(data):
    out, pos = [], 12
    while pos + 8 <= len(data):
        kind, n = data[pos:pos + 4], struct.unpack('<I', data[pos + 4:pos + 8])[0]
        out.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + n % 2
    return out


def pillow_webp(arr, **kw):
    import io
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, 'WEBP', **kw)
    return buf.getvalue()


def _u24(v):
    return struct.pack('<I', v)[:3]


def vp8x(flags, width, height):
    return (b'VP8X', bytes([flags, 0, 0, 0]) + _u24(width - 1) + _u24(height - 1))


def filter_alpha(alpha, kind):
    """WebP's alpha filters forward: 0 none, 1 horizontal, 2 vertical,
    3 gradient (each first row horizontal, from 0)."""
    a = alpha.astype(np.int64)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if kind == 1:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = a[1:, :-1]
    elif kind == 2:
        pred[1:] = a[:-1]
    elif kind == 3:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    if kind == 0:
        pred[:] = 0
    return ((a - pred) & 0xFF).astype(np.uint8)


def alph_chunk(alpha, method, kind, pre=0):
    """An ALPH payload: the filtered plane raw (method 0) or as the green
    channel of a VP8L image stream (method 1; Pillow's lossless encoder,
    the 5-byte VP8L header cut)."""
    plane = filter_alpha(alpha, kind)
    if method == 0:
        body = plane.tobytes()
    else:
        (_, vp8l), = [c for c in webp_chunks(pillow_webp(np.repeat(plane[:, :, None], 3, 2),
                                                          lossless=True)) if c[0] == b'VP8L']
        body = vp8l[5:]
    return (b'ALPH', bytes([method | kind << 2 | pre << 4]) + body)


def webp_with_alpha(rgb, alpha, method, kind, quality=80):
    """VP8X + ALPH + a lossy VP8 frame of ``rgb``."""
    (_, vp8), = webp_chunks(pillow_webp(rgb, quality=quality))
    h, w = alpha.shape
    return riff([vp8x(0x10, w, h), alph_chunk(alpha, method, kind), (b'VP8 ', vp8)])


def webp_anim_offset(canvas, frame_chunks, offset, size):
    """An animated WebP whose first frame (``frame_chunks``, ``size``)
    sits at ``offset`` (even) of a larger canvas, with a second frame."""
    (cw, ch), (x, y), (fw, fh) = canvas, offset, size
    head = _u24(x // 2) + _u24(y // 2) + _u24(fw - 1) + _u24(fh - 1) + _u24(80) + b'\x00'
    frame = head + b''.join(k + struct.pack('<I', len(p)) + p + (b'\0' if len(p) % 2 else b'')
                            for k, p in frame_chunks)
    return riff([vp8x(0x12, cw, ch), (b'ANIM', b'\0\0\0\0\0\0'), (b'ANMF', frame),
                  (b'ANMF', frame)])


def libwebp_encode(arr, lossless=False, quality=75.0, **fields):
    """WebPEncode of Pillow's bundled libwebp through ctypes, with the
    WebPConfig fields Pillow's save does not take (filter type, sharpness,
    partitions, segments, alpha filtering)."""
    import ctypes
    import glob
    import PIL
    libs = os.path.join(os.path.dirname(PIL.__file__), '..', 'pillow.libs')
    ctypes.CDLL(glob.glob(os.path.join(libs, 'libsharpyuv-*.so*'))[0], mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, 'libwebp-*.so*'))[0])
    names = ['lossless', 'quality', 'method', 'image_hint', 'target_size', 'target_PSNR',
             'segments', 'sns_strength', 'filter_strength', 'filter_sharpness', 'filter_type',
             'autofilter', 'alpha_compression', 'alpha_filtering', 'alpha_quality', 'pass',
             'show_compressed', 'preprocessing', 'partitions', 'partition_limit']
    version = 0x0210                     # WEBP_ENCODER_ABI_VERSION of libwebp 1.6
    cfg = (ctypes.c_int32 * 64)()
    assert lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(quality), version)
    assert cfg[2] == 4 and cfg[6] == 4 and cfg[14] == 100, 'an unexpected WebPConfig layout'
    cfg[0] = int(lossless)
    for k, v in fields.items():
        cfg[names.index(k)] = v
    assert lib.WebPValidateConfig(cfg), fields
    pic = (ctypes.c_uint8 * 1024)()
    assert lib.WebPPictureInitInternal(pic, version)
    p32 = ctypes.cast(pic, ctypes.POINTER(ctypes.c_int32))
    p64 = ctypes.cast(pic, ctypes.POINTER(ctypes.c_uint64))
    h, w, c = arr.shape
    p32[0], p32[2], p32[3] = int(lossless), w, h     # use_argb, width, height
    arr = np.ascontiguousarray(arr, np.uint8)
    imp = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert imp(pic, arr.ctypes.data_as(ctypes.c_void_p), w * c)
    assert (p64[9] != 0 and p32[20] == w) if lossless else (p64[2] != 0 and p32[10] == w)
    writer = (ctypes.c_uint64 * 4)()
    lib.WebPMemoryWriterInit(writer)
    p64[12] = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value   # writer
    p64[13] = ctypes.addressof(writer)                                   # custom_ptr
    assert lib.WebPEncode(cfg, pic), f'WebPEncode failed ({p32[34]})'
    out = ctypes.string_at(writer[0], writer[1])
    lib.WebPPictureFree(pic)
    lib.WebPMemoryWriterClear(writer)
    return out


class BoolEncoder:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob, bit):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self):
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _encode_log(decisions):
    enc = BoolEncoder()
    for d in decisions:
        enc.put(int(d) >> 1, int(d) & 1)
    return enc.flush()


def vp8_repartition(payload, log2_parts):
    """A VP8 key frame re-encoded with 2**log2_parts token partitions: its
    decisions logged by a -DHCP_VP8_LOG build of csrc/webp_decode.cpp, the
    partition count's two bits replaced, each macroblock row's tokens
    re-encoded into partition row % count."""
    import ctypes
    import subprocess
    import tempfile
    src = os.path.join(os.path.dirname(DATA), '..', 'hcpdiff_tpu_torch', 'csrc', 'webp_decode.cpp')
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, 'libvp8log.so')
        subprocess.run(['g++', '-O2', '-fPIC', '-std=c++17', '-shared', '-DHCP_VP8_LOG', '-o', so,
                        src], check=True)
        lib = ctypes.CDLL(so)
    w, h = (v & 0x3FFF for v in struct.unpack('<HH', payload[6:10]))
    meta = np.zeros(4096, np.int64)
    log = np.zeros(1 << 24, np.uint16)
    buf = np.frombuffer(payload, np.uint8)
    rc = lib.hcp_vp8_log(buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(payload)),
                         w, h, meta.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(meta.size),
                         log.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(log.size))
    assert rc == 0, rc
    n0, at, rows = int(meta[0]), int(meta[1]), int(meta[2])
    first = log[:n0].copy()
    first[at] = (128 << 1) | (log2_parts >> 1)
    first[at + 1] = (128 << 1) | (log2_parts & 1)
    counts = meta[3:3 + rows]
    starts = n0 + np.concatenate([[0], np.cumsum(counts)])
    nparts = 1 << log2_parts
    parts = [_encode_log(np.concatenate([log[starts[r]:starts[r + 1]]
                                         for r in range(p, rows, nparts)] or [[]]))
             for p in range(nparts)]
    p0 = _encode_log(first)
    bits = (payload[0] | payload[1] << 8 | payload[2] << 16) & 0x1F
    tag = struct.pack('<I', bits | len(p0) << 5)[:3]
    sizes = b''.join(struct.pack('<I', len(p))[:3] for p in parts[:-1])
    return tag + payload[3:10] + p0 + sizes + b''.join(parts)


def dib_entry(pixels, bits, palette=b'', and_mask=None):
    """An ICO bitmap: a 40-byte info header (the height doubled), the
    palette, the XOR rows and the AND mask's rows, bottom-up."""
    h, w = pixels.shape[:2]
    if bits in (24, 32):
        xor = bmp_rows(pixels.reshape(h, -1), bits)
    elif bits == 8:
        xor = bmp_rows(pixels, 8)
    else:
        packed = _pack_rows(pixels[:, :, None], bits)
        xor = np.pad(packed, ((0, 0), (0, _stride(w, bits) - packed.shape[1])))[::-1].tobytes()
    wpad = -(-w // 32) * 32
    mask = np.zeros((h, wpad), np.uint8) if and_mask is None else np.pad(
        and_mask, ((0, 0), (0, wpad - w)))
    andb = np.packbits(mask, axis=1)[::-1].tobytes()
    head = struct.pack('<IiiHHIIiiII', 40, w, 2 * h, 1, bits, 0, len(xor) + len(andb), 0, 0,
                       len(palette) // 4 if bits <= 8 else 0, 0)
    return head + palette + xor + andb


def ico_bytes(entries):
    """An ICO of (width, height, bpp, data) entries, in order."""
    out = struct.pack('<HHH', 0, 1, len(entries))
    offset, body = 6 + 16 * len(entries), b''
    for w, h, bits, data in entries:
        out += struct.pack('<BBBBHHII', w % 256, h % 256, 0, 0, 1, bits, len(data),
                           offset + len(body))
        body += data
    return out + body


# ----------------------------------------------------------------- files

def write_all():
    h, w = SIZE
    sh, sw = SMALL
    rgb = photo(h, w, 3, seed=1)
    small = photo(sh, sw, 3, seed=2)
    files = {}

    def save(name, data):
        files[name] = data

    def pillow(name, im, fmt, **kw):
        import io
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        save(name, buf.getvalue())

    pillow('prog_420.jpg', Image.fromarray(photo(512, 512, 3, seed=3, cell=32)), 'JPEG',
           quality=90, subsampling=2, progressive=True, optimize=True)
    pillow('prog_grey.jpg', Image.fromarray(rgb[:, :, 1]), 'JPEG', quality=85, progressive=True)
    pillow('cmyk.jpg', Image.fromarray(photo(h, w, 4, seed=4), 'CMYK'), 'JPEG', quality=85)
    ycc = ycc_planes(rgb)
    save('base_440.jpg', jpeg_sampled(ycc, [(1, 2), (1, 1), (1, 1)]))
    save('base_411.jpg', jpeg_sampled(ycc, [(4, 1), (1, 1), (1, 1)]))
    save('ycck.jpg', jpeg_sampled(np.concatenate([ycc, photo(h, w, 1, seed=5).transpose(2, 0, 1)]),
                                  [(2, 2), (1, 1), (1, 1), (2, 2)], adobe=2))

    pal_im = Image.fromarray(rgb).quantize(64, dither=Image.Dither.NONE)
    idx = np.asarray(pal_im)
    plte = bytes(pal_im.getpalette()[:3 * 64])
    alpha = np.where(np.arange(64) % 5 == 0, 0, np.where(np.arange(64) % 3 == 0, 128, 255))
    save('palette_trns.png', png_bytes(idx[:, :, None], 8, 3, plte=plte,
                                       trns=alpha.astype(np.uint8).tobytes()))
    save('palette4.png', png_bytes((idx % 16)[:, :, None], 4, 3, plte=plte[:48]))
    la = np.stack([rgb[:, :, 0], photo(h, w, 1, seed=6)[:, :, 0]], -1)
    pillow('la.png', Image.fromarray(la, 'LA'), 'PNG')
    wide = np.minimum(small.astype(np.int64) * 257
                      + np.random.default_rng(7).integers(0, 257, small.shape), 65535)
    save('rgb16.png', png_bytes(wide.astype(np.uint16), 16, 2))
    pillow('grey16.png', Image.fromarray(wide[:, :, 0].astype(np.uint16) // 64), 'PNG')
    save('grey2.png', png_bytes((rgb[:, :, :1] >> 6), 2, 0))
    rgba = np.concatenate([rgb, photo(h, w, 1, seed=8)], -1)
    save('adam7_rgba.png', png_bytes(rgba, 8, 6, interlace=True))

    gif = Image.fromarray(rgb).quantize(128, dither=Image.Dither.NONE)
    pillow('trans.gif', gif, 'GIF', transparency=3)

    small_p = Image.fromarray(small).quantize(200, dither=Image.Dither.NONE)
    pillow('bmp8.bmp', small_p, 'BMP')
    pillow('bmp24.bmp', Image.fromarray(small), 'BMP')
    a = photo(sh, sw, 1, seed=9)
    bgra = np.concatenate([small[:, :, ::-1], a], -1)
    save('bmp32_alpha.bmp', bmp_bytes(bmp_rows(bgra.reshape(sh, -1), 32), 32, sw, sh, 3,
                                      masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), v4=True))
    p565 = ((small[:, :, 0].astype(np.uint16) >> 3) << 11 | (small[:, :, 1].astype(np.uint16) >> 2)
            << 5 | small[:, :, 2] >> 3)
    save('bmp16_565.bmp', bmp_bytes(bmp_rows(p565.astype('<u2').view(np.uint8).reshape(sh, -1),
                                             16), 16, sw, sh, 3, masks=(0xF800, 0x7E0, 0x1F)))
    runs = np.repeat(np.asarray(small_p)[:, ::3], 3, axis=1)[:, :sw]
    runs[::4] = np.asarray(small_p)[::4]                     # some rows of literals
    pal = bytes(np.concatenate([np.asarray(small_p.getpalette()[:600], np.uint8).reshape(-1, 3)
                                [:, ::-1], np.zeros((200, 1), np.uint8)], 1).tobytes())
    save('rle8.bmp', bmp_bytes(rle_encode(runs, False), 8, sw, sh, 1, palette=pal))
    save('rle4.bmp', bmp_bytes(rle_encode(runs % 16, True), 4, sw, sh, 2, palette=pal[:64]))

    for name, data in files.items():
        with open(os.path.join(HERE, name), 'wb') as f:
            f.write(data)
    with open(os.path.join(HERE, 'captions.json'), 'w') as f:
        json.dump({os.path.splitext(n)[0]: f'a photo of cat {n}' for n in sorted(files)}, f,
                  indent=0)


MORE = os.path.join(DATA, 'torch_port_webp_tiff_ico')


def write_more():
    """The WebP, TIFF and ICO files (and the 4-bit grey-ramp BMP) in
    ../torch_port_webp_tiff_ico: two 512 px WebPs, the rest small, at the
    aspect ratios of the files above (67:45, 1:1) so that training on them
    adds few buckets."""
    sh, sw = SMALL
    small = photo(sh, sw, 3, seed=21)
    alpha = photo(sh, sw, 1, seed=22)[:, :, 0]
    rgba = np.concatenate([small, alpha[:, :, None]], -1)
    files = {}
    big = photo(512, 512, 3, seed=23, cell=32)
    files['lossy_512.webp'] = pillow_webp(big, quality=80)
    files['lossless_512.webp'] = pillow_webp(photo(512, 512, 3, seed=24, cell=32, noise=0.0),
                                             lossless=True)
    # libwebp's encoder writes one token partition whatever its config says
    for name, log2_parts, kw in (
            ('lossy_simple_8parts.webp', 3, dict(quality=60.0, filter_type=0, filter_strength=70,
                                                  filter_sharpness=3)),
            ('lossy_sharp_2parts.webp', 1, dict(quality=40.0, filter_type=1, filter_strength=90,
                                                 filter_sharpness=5, sns_strength=100))):
        (_, vp8), = webp_chunks(libwebp_encode(small, **kw))
        files[name] = riff([(b'VP8 ', vp8_repartition(vp8, log2_parts))])
    files['alpha_lossless_gradient.webp'] = webp_with_alpha(small, alpha, 1, 3)
    files['alpha_raw_horizontal.webp'] = webp_with_alpha(small, alpha, 0, 1)
    colours = np.asarray([[255, 0, 0, 255], [0, 255, 0, 128], [0, 0, 255, 0],
                          [250, 250, 250, 255]], np.uint8)
    files['lossless_palette_rgba.webp'] = pillow_webp(      # 4 colours: 4 indices a byte
        colours[(small[:, :, 0] >> 7) * 2 + (alpha >> 7)], lossless=True, exact=True)
    (_, frame), = webp_chunks(pillow_webp(small[:30, :40], quality=70))
    files['anim_offset.webp'] = webp_anim_offset((sw, sh), [(b'VP8 ', frame)], (10, 6), (40, 30))
    files['lzw_predictor.tif'] = tiff_bytes(small, 8, 2, compression=5, predictor=2,
                                            rows_per_strip=16)
    files['deflate_tiled_planar_mm.tif'] = tiff_bytes(rgba, 8, 2, order='>', compression=8,
                                                      planar=2, tile=(32, 16), extra=(2,))
    files['packbits_bilevel_fill2.tif'] = tiff_bytes(small[:, :, :1] >> 7, 1, 0,
                                                     compression=32773, fillorder=2,
                                                     rows_per_strip=8)
    wide = (small.astype(np.uint16) * 257 + np.random.default_rng(25).integers(0, 257, small.shape))
    files['grey16_mm.tif'] = tiff_bytes(wide[:, :, :1], 16, 1, order='>')
    files['rgba16_associated.tif'] = tiff_bytes(
        np.concatenate([wide, alpha[:, :, None].astype(np.uint16) * 257], -1), 16, 2, extra=(1,),
        compression=5, predictor=2)
    cmap = list(np.random.default_rng(26).integers(0, 65536, 48))
    files['palette4_lzw.tiff'] = tiff_bytes(small[:, :, :1] >> 4, 4, 3, colormap=cmap,
                                        compression=5)
    files['cmyk_packbits.tif'] = tiff_bytes(photo(sh, sw, 4, seed=27), 8, 5, compression=32773)
    import io
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, 'ICO', sizes=[(16, 16), (48, 48)])
    files['png_entries.ico'] = buf.getvalue()
    idx = (small[:16, :24, 0] // 32).astype(np.uint8)
    pal = np.random.default_rng(28).integers(0, 256, 32, dtype=np.uint8)
    pal[3::4] = 0
    bgra = np.concatenate([small[:32, :48, ::-1], alpha[:32, :48, None]], -1)
    files['dib_entries.ico'] = ico_bytes([
        (24, 16, 4, dib_entry(idx, 4, bytes(pal) + bytes(32), alpha[:16, :24] > 128)),
        (48, 32, 32, dib_entry(bgra, 32))])
    ramp = bytes(np.repeat(np.arange(16, dtype=np.uint8), 4) * np.tile([1, 1, 1, 0], 16)
                 .astype(np.uint8))
    packed = np.asarray([[0x1F, 0x3C, 0, 0], [0xA5, 0x0E, 0, 0]], np.uint8)
    files['grey4_narrow.bmp'] = bmp_bytes(packed.tobytes(), 4, 3, 2, palette=ramp)
    os.makedirs(MORE, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(MORE, name), 'wb') as f:
            f.write(data)
    with open(os.path.join(MORE, 'captions.json'), 'w') as f:
        json.dump({os.path.splitext(n)[0]: f'a photo of cat {n}' for n in sorted(files)}, f,
                  indent=0)


def digest(arr):
    arr = np.ascontiguousarray(arr, np.uint8)
    return [hashlib.sha256(arr.tobytes()).hexdigest(), list(arr.shape)]


def image_files():
    """Paths relative to tests/data of every image here, in torch_port_jpeg
    and in torch_port_webp_tiff_ico."""
    out = []
    for folder in ('torch_port_formats', 'torch_port_jpeg', 'torch_port_webp_tiff_ico'):
        out += [f'{folder}/{n}' for n in sorted(os.listdir(os.path.join(DATA, folder)))
                if os.path.splitext(n)[1] in ('.jpg', '.png', '.gif', '.bmp', '.webp', '.tif',
                                              '.tiff', '.ico')]
    return out


def expected():
    """{path: {'rgb': [sha256, shape], 'l': [sha256, shape]}} by the JAX
    package's Pillow calls."""
    import warnings
    from hcpdiff_tpu.data.utils import composite_rgba
    warnings.filterwarnings('ignore', 'Palette images with Transparency')
    out = {}
    for rel in image_files():
        with Image.open(os.path.join(DATA, rel)) as im:
            rgb = np.asarray(composite_rgba(im))
        with Image.open(os.path.join(DATA, rel)) as im:
            grey = np.asarray(im.convert('L'))
        out[rel] = {'rgb': digest(rgb), 'l': digest(grey)}
    return out


if __name__ == '__main__':
    write_all()
    write_more()
    with open(os.path.join(HERE, 'expected.json'), 'w') as f:
        json.dump(expected(), f, indent=1, sort_keys=True)
