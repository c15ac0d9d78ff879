"""The port's image readers (``utils/images.py:decode_image`` over
``csrc/image_decode.cpp``) against the JAX package's Pillow calls, bitwise,
on the CPU:

- every file committed under tests/data/torch_port_formats and
  tests/data/torch_port_jpeg: ``data/utils.py``'s ``load_rgb`` (default
  background, another, and None) and ``load_gray`` against
  ``composite_rgba(Image.open(f), bg)``, ``convert('RGB')`` and
  ``convert('L')``; ``read_image`` 'RGB'/'L'; ``load_image``/``load_mask``
  against the JAX Visualizer's resizes; the decoded mode and pixels
  against ``Image.open``;
- ``expected.json`` recomputed with Pillow (the hashes the card checks
  without Pillow), and the port's arrays against it;
- variants written in ``tmp_path``: PNG at every depth and colour type,
  interlaced or not, with ``tRNS``; GIF with and without interlacing, a
  grey-ramp palette, a frame inside the screen; BMP at 1/4/8/16/24/32 bits,
  top-down, the 12-byte core header, RLE4 with odd absolute runs; JPEG at
  samplings Pillow cannot write (3:1 replication, a chroma two samples
  wide), Adobe RGB, progressive with restart intervals;
- arithmetic-coded JPEG, TIFF, lossy WebP and ICO raise a ``ValueError``
  naming the file and the ROADMAP item.
"""
import importlib.util
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from hcpdiff_tpu.data import utils as jutils
from hcpdiff_tpu_torch.data import utils as tutils
from hcpdiff_tpu_torch.utils import images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'tests', 'data')
FORMATS = os.path.join(DATA, 'torch_port_formats')

_spec = importlib.util.spec_from_file_location('make_formats',
                                               os.path.join(FORMATS, 'make_formats.py'))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)

FILES = mk.image_files()
BG = (10, 200, 30)


def _jax(path, fn):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with Image.open(path) as im:
            return np.asarray(fn(im))


def assert_reads_as_jax(path):
    """Every port reader against the JAX package's Pillow call on ``path``."""
    rgb = _jax(path, lambda im: jutils.composite_rgba(im))
    cases = [
        ('load_rgb', tutils.load_rgb(path), rgb),
        ('load_rgb bg', tutils.load_rgb(path, BG), _jax(path, lambda im: jutils.composite_rgba(
            im, BG))),
        ('load_rgb None', tutils.load_rgb(path, None), _jax(path, lambda im: im.convert('RGB'))),
        ('load_gray', tutils.load_gray(path), _jax(path, lambda im: im.convert('L'))),
        ('read_image RGB', images.read_image(path, 'RGB'), _jax(path,
                                                                lambda im: im.convert('RGB'))),
        ('read_image L', images.read_image(path, 'L'), _jax(path, lambda im: im.convert('L'))),
    ]
    with open(path, 'rb') as f:
        dec = images.decode_image(f.read(), path)
    with Image.open(path) as im:
        assert dec.mode == im.mode, (dec.mode, im.mode)
        cases.append(('pixels', dec.pixels, np.asarray(im)))
    for what, got, want in cases:
        assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f'{os.path.basename(path)}: {what}')


@pytest.mark.parametrize('rel', FILES)
def test_committed_file_reads_as_the_jax_package_reads_it(rel):
    path = os.path.join(DATA, rel)
    assert_reads_as_jax(path)
    # the Visualizer's init image and mask (hcpdiff_tpu/infer/visualizer.py:396, :457)
    init = _jax(path, lambda im: jutils.to_model_input(im.convert('RGB').resize(
        (40, 24), Image.BICUBIC)))
    np.testing.assert_array_equal(images.load_image(path, 40, 24)[0], init)
    mask = _jax(path, lambda im: im.convert('L').resize((12, 20)))
    np.testing.assert_array_equal(images.load_mask(path, 12, 20)[0, :, :, 0],
                                  mask.astype(np.float32) / 255.0)


def test_expected_json_is_what_pillow_gives():
    """expected.json holds the JAX package's hashes for every committed
    image (recomputed here, so they cannot drift), and the port's arrays
    hash to them: the check chip_smoke.py makes on a host without Pillow."""
    with open(os.path.join(FORMATS, 'expected.json')) as f:
        committed = json.load(f)
    assert committed == mk.expected()
    assert sorted(committed) == sorted(FILES) and len(FILES) >= 24
    for rel, want in committed.items():
        path = os.path.join(DATA, rel)
        assert mk.digest(tutils.load_rgb(path)) == want['rgb'], rel
        assert mk.digest(tutils.load_gray(path)) == want['l'], rel
    sizes = sum(os.path.getsize(os.path.join(FORMATS, n)) for n in os.listdir(FORMATS))
    assert sizes < 400_000


# ---------------------------------------------------------------- variants

PNG_CASES = [(depth, color, interlace) for color, depths in
             ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16)))
             for depth in depths for interlace in (False, True)]


@pytest.mark.parametrize('depth,color,interlace', PNG_CASES,
                         ids=[f'{d}bit-type{c}{"-adam7" if i else ""}' for d, c, i in PNG_CASES])
def test_png_variants(tmp_path, depth, color, interlace):
    rng = np.random.default_rng(depth * 10 + color)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    h, w = 13, 19
    top = (1 << depth) - 1 if color != 3 else min(255, (1 << depth) - 1)
    samples = rng.integers(0, top + 1, (h, w, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    kw = {}
    if color == 3:
        n = min(1 << depth, 40)               # a short palette: higher indices read black
        kw['plte'] = rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes()
        kw['trns'] = rng.integers(0, 256, max(n // 2, 1), dtype=np.uint8).tobytes()
    elif color in (0, 2) and depth == 8:      # a tRNS colour that is not composited
        kw['trns'] = struct.pack('>' + 'H' * ch, *samples[0, 0].tolist())
    path = tmp_path / 'v.png'
    path.write_bytes(mk.png_bytes(samples, depth, color, interlace=interlace, **kw))
    assert_reads_as_jax(str(path))


def _gif(tmp_path, im, **kw):
    path = tmp_path / 'v.gif'
    im.save(path, 'GIF', **kw)
    return str(path)


@pytest.mark.parametrize('case', ['interlaced', 'plain', 'grey_ramp', 'transparent_0',
                                  'local_palette_offset'])
def test_gif_variants(tmp_path, case):
    rgb = mk.photo(37, 53, 3, seed=11)
    p = Image.fromarray(rgb).quantize(32, dither=Image.Dither.NONE)
    if case == 'interlaced':
        path = _gif(tmp_path, p, interlace=True, transparency=5)
    elif case == 'plain':
        path = _gif(tmp_path, p, interlace=False)
    elif case == 'grey_ramp':
        path = _gif(tmp_path, Image.fromarray(rgb[:, :, 0]), interlace=False)
    elif case == 'transparent_0':
        path = _gif(tmp_path, p, transparency=0)
    else:                                     # a 20x10 frame at (7, 4) of a 53x37 screen
        lzw = _gif_frame_bytes(np.asarray(p)[:10, :20] % 16)
        pal = bytes(p.getpalette()[:48])
        data = (b'GIF89a' + struct.pack('<HHBBB', 53, 37, 0x80 | 3, 0, 0) + pal
                + b'\x21\xf9\x04\x01\x00\x00\x02\x00' + b'\x2c'
                + struct.pack('<HHHHB', 7, 4, 20, 10, 0x80 | 3) + pal[::-1] + lzw + b'\x3b')
        (tmp_path / 'v.gif').write_bytes(data)
        path = str(tmp_path / 'v.gif')
    assert_reads_as_jax(path)


def _gif_frame_bytes(indices):
    """LZW image data (min code size 4) of 4-bit indices: literal codes
    only, a clear code every 8 codes, in sub-blocks."""
    codes, bits = [], 5
    flat = indices.reshape(-1).tolist()
    out_bits = []
    for k, v in enumerate(flat):
        if k % 8 == 0:
            codes.append(16)
        codes.append(v)
    codes.append(17)
    for c in codes:
        out_bits += [(c >> i) & 1 for i in range(bits)]
    out_bits += [0] * (-len(out_bits) % 8)
    data = np.packbits(np.asarray(out_bits, np.uint8), bitorder='little').tobytes()
    blocks = b''.join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return b'\x04' + blocks + b'\x00'


BMP_CASES = ['1bit', '1bit_colour', '4bit', '8bit_grey', '16bit_555', '32bit_rgb', '24bit_top_down',
             'core_header', 'rle4_odd', 'bitfields_32_xbgr']


@pytest.mark.parametrize('case', BMP_CASES)
def test_bmp_variants(tmp_path, case):
    rng = np.random.default_rng(len(case))
    h, w = 11, 21
    rgb = mk.photo(h, w, 3, seed=12)
    path = str(tmp_path / 'v.bmp')
    if case in ('1bit', '8bit_grey', '24bit_top_down'):
        im = {'1bit': Image.fromarray(rgb[:, :, 0] > 128), '8bit_grey': Image.fromarray(
            rgb[:, :, 0]), '24bit_top_down': Image.fromarray(rgb)}[case]
        im.save(path, 'BMP')
        if case == '24bit_top_down':         # flip the rows and negate the height
            data = bytearray(open(path, 'rb').read())
            off = struct.unpack('<I', data[10:14])[0]
            stride = mk._stride(w, 24)
            rows = [data[off + r * stride:off + (r + 1) * stride] for r in range(h)]
            data[off:] = b''.join(rows[::-1])
            data[22:26] = struct.pack('<i', -h)
            open(path, 'wb').write(bytes(data))
    else:
        if case == '1bit_colour':
            idx = (rgb[:, :, 0] > 128).astype(np.uint8)
            packed = np.packbits(idx, axis=1)
            rows = b''.join(np.pad(r, (0, mk._stride(w, 1) - len(r))).tobytes()
                            for r in packed[::-1])
            data = mk.bmp_bytes(rows, 1, w, h, palette=bytes([200, 10, 10, 0, 10, 220, 30, 0]))
        elif case in ('4bit', 'rle4_odd'):
            idx = rng.integers(0, 16, (h, w)).astype(np.uint8)
            if case == 'rle4_odd':
                idx[:, 5:10] = idx[:, 5:6]
                rows = b''
                for r in idx[::-1]:
                    rows += bytes([5, r[0] << 4 | r[1]]) + bytes([0, 5]) + bytes(
                        [r[5] << 4 | r[6], r[7] << 4 | r[8], r[9] << 4]) + b'\0'
                    rest = r[10:]
                    rows += bytes([len(rest), rest[0] << 4 | rest[1]]) + b'\0\0'
                rows += b'\0\1'
                pal = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
                data = mk.bmp_bytes(rows, 4, w, h, 2, palette=pal)
            else:
                packed = (np.pad(idx, ((0, 0), (0, w % 2)))[:, 0::2] << 4
                          | np.pad(idx, ((0, 0), (0, w % 2)))[:, 1::2])
                rows = b''.join(np.pad(r, (0, mk._stride(w, 4) - len(r))).tobytes()
                                for r in packed[::-1])
                data = mk.bmp_bytes(rows, 4, w, h,
                                    palette=rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
        elif case == '16bit_555':
            px = ((rgb[..., 0].astype(np.uint16) >> 3) << 10 | (rgb[..., 1].astype(np.uint16) >> 3)
                  << 5 | rgb[..., 2] >> 3)
            data = mk.bmp_bytes(mk.bmp_rows(px.astype('<u2').view(np.uint8).reshape(h, -1), 16),
                                16, w, h)
        elif case == '32bit_rgb':
            bgrx = np.concatenate([rgb[:, :, ::-1], rng.integers(0, 256, (h, w, 1),
                                                                   dtype=np.uint8)], -1)
            data = mk.bmp_bytes(mk.bmp_rows(bgrx.reshape(h, -1), 32), 32, w, h)
        elif case == 'bitfields_32_xbgr':
            xbgr = np.concatenate([rng.integers(0, 256, (h, w, 1), dtype=np.uint8),
                                   rgb[:, :, ::-1]], -1)[:, :, ::-1]     # little-endian words
            data = mk.bmp_bytes(mk.bmp_rows(xbgr.reshape(h, -1), 32), 32, w, h, 3,
                                masks=(0xFF000000, 0xFF0000, 0xFF00, 0x0), v4=True)
        else:                                 # core_header: 12 bytes, a BGR palette
            idx = rng.integers(0, 7, (h, w)).astype(np.uint8)
            pal = rng.integers(0, 256, 3 * 256, dtype=np.uint8).tobytes()
            rows = mk.bmp_rows(idx, 8)
            head = struct.pack('<IHHHH', 12, w, h, 1, 8)
            body = head + pal + rows
            data = b'BM' + struct.pack('<IHHI', 14 + len(body), 0, 0, 14 + 12 + len(pal)) + body
        open(path, 'wb').write(data)
    assert_reads_as_jax(path)


def _jpeg_bytes(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, 'JPEG', **kw)
    return buf.getvalue()


JPEG_CASES = ['h3v1', 'h1v2_narrow', 'h2v2_chroma_2_wide', 'h2v1_chroma_2_wide', 'adobe_rgb',
              'progressive_restarts', 'progressive_444', 'cmyk_progressive', 'grey_h2v2']


@pytest.mark.parametrize('case', JPEG_CASES)
def test_jpeg_variants(tmp_path, case):
    rgb = mk.photo(29, 45, 3, seed=13)
    ycc = mk.ycc_planes(rgb)
    if case == 'h3v1':
        data = mk.jpeg_sampled(ycc, [(3, 1), (1, 1), (1, 1)])
    elif case == 'h1v2_narrow':
        data = mk.jpeg_sampled(ycc[:, :, :3], [(1, 2), (1, 1), (1, 1)])
    elif case == 'h2v2_chroma_2_wide':
        data = mk.jpeg_sampled(ycc[:, :, :3], [(2, 2), (1, 1), (1, 1)])
    elif case == 'h2v1_chroma_2_wide':
        data = mk.jpeg_sampled(ycc[:, :, :4], [(2, 1), (1, 1), (1, 1)])
    elif case == 'adobe_rgb':
        data = _jpeg_bytes(rgb, quality=90, keep_rgb=True)
    elif case == 'progressive_restarts':
        data = _jpeg_bytes(rgb, quality=80, progressive=True, restart_marker_blocks=2)
    elif case == 'progressive_444':
        data = _jpeg_bytes(rgb, quality=95, progressive=True, subsampling=0, optimize=True)
    elif case == 'cmyk_progressive':
        buf = io.BytesIO()
        Image.fromarray(mk.photo(29, 45, 4, seed=14), 'CMYK').save(buf, 'JPEG', progressive=True)
        data = buf.getvalue()
    else:                                     # one component sampled 2x2: its own grid
        data = mk.jpeg_sampled(ycc[:1], [(2, 2)])
    path = tmp_path / 'v.jpg'
    path.write_bytes(data)
    assert_reads_as_jax(str(path))


# ------------------------------------------------------------------ refused

def _refused_file(tmp_path, kind):
    if kind == 'arithmetic':
        data = bytearray(_jpeg_bytes(mk.photo(16, 16, 3, seed=1)))
        data[data.index(b'\xff\xc0') + 1] = 0xC9                 # SOF9
        name = 'arith.jpg'
    elif kind == 'tiff':
        buf = io.BytesIO()
        Image.fromarray(mk.photo(16, 16, 3, seed=1)).save(buf, 'TIFF')
        data, name = buf.getvalue(), 'photo.tif'
    elif kind == 'webp':
        buf = io.BytesIO()
        Image.fromarray(mk.photo(16, 16, 3, seed=1)).save(buf, 'WEBP', quality=80)
        data, name = buf.getvalue(), 'photo.webp'
    else:
        buf = io.BytesIO()
        Image.fromarray(mk.photo(16, 16, 3, seed=1)).save(buf, 'ICO')
        data, name = buf.getvalue(), 'photo.ico'
    path = tmp_path / name
    path.write_bytes(bytes(data))
    return str(path), name


@pytest.mark.parametrize('kind,what', [('arithmetic', 'arithmetic-coded'), ('tiff', 'TIFF'),
                                       ('webp', r'lossy \(VP8\) WebP'), ('ico', 'ICO')])
def test_unread_formats_raise_naming_the_file(tmp_path, kind, what):
    path, name = _refused_file(tmp_path, kind)
    for reader in (tutils.load_rgb, tutils.load_gray, lambda p: images.read_image(p, 'RGB')):
        with pytest.raises(ValueError, match=f'{name}: {what}.*ROADMAP.md queue 1 item 6'):
            reader(path)


def test_the_port_s_own_webp_reads_back(tmp_path):
    rgb = mk.photo(9, 14, 3, seed=3)
    path = str(tmp_path / 'own.webp')
    images.write_webp(path, rgb)
    np.testing.assert_array_equal(tutils.load_rgb(path), rgb)
    with Image.open(path) as im:
        np.testing.assert_array_equal(images.read_image(path, 'L'), np.asarray(im.convert('L')))
