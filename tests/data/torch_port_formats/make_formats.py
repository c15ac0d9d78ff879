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


def digest(arr):
    arr = np.ascontiguousarray(arr, np.uint8)
    return [hashlib.sha256(arr.tobytes()).hexdigest(), list(arr.shape)]


def image_files():
    """Paths relative to tests/data of every image here and in torch_port_jpeg."""
    out = []
    for folder in ('torch_port_formats', 'torch_port_jpeg'):
        out += [f'{folder}/{n}' for n in sorted(os.listdir(os.path.join(DATA, folder)))
                if os.path.splitext(n)[1] in ('.jpg', '.png', '.gif', '.bmp')]
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
    with open(os.path.join(HERE, 'expected.json'), 'w') as f:
        json.dump(expected(), f, indent=1, sort_keys=True)
