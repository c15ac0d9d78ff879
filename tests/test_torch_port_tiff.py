"""The port's TIFF reader (``utils/tiff.py``, LZW and PackBits in
``csrc/image_decode.cpp``) and its ICO reader (``utils/images.py:
decode_ico``) against the JAX package's Pillow calls, bitwise, on the CPU
(``test_torch_port_formats.py:assert_reads_as_jax``):

- TIFF written by ``make_formats.tiff_bytes`` and by Pillow: II and MM,
  strips and tiles, PlanarConfiguration 1 and 2, no compression, PackBits,
  LZW and Deflate (8 and 32946), the horizontal predictor at 8 and 16
  bits, FillOrder 2, MinIsWhite and MinIsBlack at 1/2/4/8/16 bits, grey +
  alpha, RGB at 8 and 16 bits with each ExtraSamples, palette at 1/2/4/8
  bits, CMYK at 8 and 16 bits, every Orientation; the kinds Pillow has no
  raw mode for raise in both;
- the kinds that stay unread (JPEG, CCITT, LZMA, ZSTD and WebP
  compression, float samples, YCbCr, signed 16-bit, old-style LZW) raise a
  ``ValueError`` naming the file, the kind and the ROADMAP item;
- ICO with PNG entries (Pillow's, whose image is smaller than its
  directory says) and bitmap entries at 1/4/8/24/32 bits with their AND
  masks or alpha, the entry Pillow picks among several;
- cut files raise naming the file.
"""
import io
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from hcpdiff_tpu_torch.utils import images
from test_torch_port_formats import DATA, assert_reads_as_jax, mk

MORE = os.path.join(DATA, 'torch_port_webp_tiff_ico')
H, W = 13, 21
RGB = mk.photo(H, W, 3, seed=3)
ALPHA = mk.photo(H, W, 1, seed=9)
WIDE = (RGB.astype(np.uint16) * 257
        + np.random.default_rng(0).integers(0, 257, RGB.shape)).astype(np.uint16)


def _write(tmp_path, data, name='v.tif'):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


COMPRESSIONS = [(1, 1), (32773, 1), (5, 1), (5, 2), (8, 1), (8, 2), (32946, 2)]
CHUNKY = [(c, p, order) for c, p in COMPRESSIONS for order in '<>']


@pytest.mark.parametrize('compression,predictor,order', CHUNKY,
                         ids=[f'c{c}-p{p}-{"II" if o == "<" else "MM"}' for c, p, o in CHUNKY])
def test_tiff_rgb_and_16_bit_variants(tmp_path, compression, predictor, order):
    kw = dict(order=order, compression=compression, predictor=predictor)
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(RGB, 8, 2, rows_per_strip=5, **kw),
                               'rgb8.tif'))
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(WIDE, 16, 2, rows_per_strip=4, **kw),
                               'rgb16.tif'))
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(WIDE[:, :, :1], 16, 1, **kw),
                               'grey16.tif'))
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(RGB, 8, 2, tile=(16, 16), **kw),
                               'tiled.tif'))
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(
        np.concatenate([RGB, ALPHA], -1), 8, 2, planar=2, rows_per_strip=6, extra=(2,), **kw),
        'planar.tif'))


GREY = [(bits, photo, fill, comp) for bits in (1, 2, 4, 8) for photo in (0, 1)
        for fill in (1, 2) for comp in (1, 32773, 5)]


@pytest.mark.parametrize('bits,photo,fill,compression', GREY,
                         ids=[f'{b}bit-photo{p}-fill{f}-c{c}' for b, p, f, c in GREY])
def test_tiff_grey_variants(tmp_path, bits, photo, fill, compression):
    data = mk.tiff_bytes(RGB[:, :, :1] >> (8 - bits), bits, photo, fillorder=fill,
                         compression=compression, rows_per_strip=4,
                         order='>' if bits == 4 else '<')
    path = _write(tmp_path, data)
    if (bits, photo, fill, compression) == (8, 0, 2, 1):       # no 'L;IR' raw mode in Pillow
        with pytest.raises(ValueError, match='unknown raw mode'):
            Image.open(path).load()
        with pytest.raises(ValueError, match='v.tif: an uncompressed L;I TIFF'):
            images.read_image(path, 'L')
        return
    assert_reads_as_jax(path)


EXTRA = [((), 8), ((0,), 8), ((1,), 8), ((2,), 8), ((), 16), ((0,), 16), ((1,), 16), ((2,), 16),
         ((1, 0), 8), ((0, 0, 0), 8)]


@pytest.mark.parametrize('extra,bits', EXTRA, ids=[f'extra{e}-{b}bit' for e, b in EXTRA])
def test_tiff_extra_samples(tmp_path, extra, bits):
    """ExtraSamples 0 (RGB), 1 (associated: Pillow unpremultiplies) and 2
    (RGBA), none (RGBA), and 5 and 6 samples."""
    colour = WIDE if bits == 16 else RGB
    alpha = ALPHA.astype(np.uint16) * 257 if bits == 16 else ALPHA
    alpha[0, :4] = 0
    alpha[1, :4] = 255 * (257 if bits == 16 else 1)
    samples = np.concatenate([colour] + [alpha] * max(len(extra), 1), -1)
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(samples, bits, 2, extra=extra,
                                                       compression=8, order='>')))


@pytest.mark.parametrize('bits', [1, 2, 4, 8])
def test_tiff_palette_la_cmyk(tmp_path, bits):
    cmap = list(np.random.default_rng(bits).integers(0, 65536, 3 << bits))
    for k, fill in enumerate((1, 2)):
        data = mk.tiff_bytes(RGB[:, :, :1] >> (8 - bits), bits, 3, colormap=cmap,
                             compression=5, fillorder=fill)
        assert_reads_as_jax(_write(tmp_path, data, f'p{k}.tif'))
    if bits == 8:
        assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(
            np.concatenate([RGB[:, :, :1], ALPHA], -1), 8, 1, extra=(2,)), 'la.tif'))
        cmyk = mk.photo(H, W, 4, seed=2)
        assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(cmyk, 8, 5, compression=32773),
                                   'cmyk.tif'))
        assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(cmyk.astype(np.uint16) * 300, 16, 5,
                                                           order='>'), 'cmyk16.tif'))
    else:                                     # no 'P;nR' raw mode in Pillow
        path = _write(tmp_path, mk.tiff_bytes(RGB[:, :, :1] >> (8 - bits), bits, 3,
                                              colormap=cmap, fillorder=2), 'raw.tif')
        with pytest.raises(ValueError, match='raw.tif: an uncompressed P TIFF'):
            images.read_image(path, 'RGB')


@pytest.mark.parametrize('orientation', range(1, 9))
def test_tiff_orientation(tmp_path, orientation):
    data = mk.tiff_bytes(RGB, 8, 2, orientation=orientation, compression=5 if orientation % 2
                         else 1)
    assert_reads_as_jax(_write(tmp_path, data))


PILLOW = [(mode, comp) for mode in ('RGB', 'L', '1', 'RGBA', 'CMYK', 'P', 'I;16', 'LA')
          for comp in (None, 'tiff_lzw', 'packbits', 'tiff_deflate', 'tiff_adobe_deflate')]


@pytest.mark.parametrize('mode,compression', PILLOW, ids=[f'{m}-{c}' for m, c in PILLOW])
def test_tiff_written_by_pillow(tmp_path, mode, compression):
    arrays = {'RGB': RGB, 'L': RGB[:, :, 0], '1': RGB[:, :, 0] > 128,
              'RGBA': np.concatenate([RGB, ALPHA], -1), 'CMYK': mk.photo(H, W, 4, seed=1),
              'I;16': WIDE[:, :, 0], 'LA': np.concatenate([RGB[:, :, :1], ALPHA], -1)}
    im = Image.fromarray(RGB).quantize(50) if mode == 'P' else Image.fromarray(arrays[mode],
                                                                               mode)
    path = str(tmp_path / 'p.tif')
    im.save(path, 'TIFF', compression=compression)
    assert_reads_as_jax(path)


def _refused_tiff(kind):
    if kind in ('jpeg', 'group4'):
        buf = io.BytesIO()
        im = Image.fromarray(RGB) if kind == 'jpeg' else Image.fromarray(RGB[:, :, 0] > 128)
        im.save(buf, 'TIFF', compression=kind)
        return buf.getvalue()
    if kind == 'old_lzw':                     # LSB-first codes: a clear code 0x100 first
        data = mk.tiff_bytes(RGB, 8, 2, compression=5)
        off = struct.unpack('<I', data[4:8])[0]
        strip = data.index(mk.lzw_encode(RGB.tobytes())[:8])
        return data[:strip] + b'\x00\x01' + data[strip + 2:off] + data[off:]
    comp = {'lzma': 34925, 'zstd': 50000, 'webp': 50001, 'ccitt3': 3}.get(kind, 1)
    if kind == 'float':
        return mk.tiff_bytes(WIDE[:, :, :1].view(np.uint16), 16, 1, sample_format=3)
    if kind == 'ycbcr':
        return mk.tiff_bytes(RGB, 8, 6)
    if kind == 'signed16':
        return mk.tiff_bytes(WIDE[:, :, :1], 16, 1, sample_format=2)
    return mk.tiff_bytes(RGB, 8, 2, compression=1)[:8] + mk.tiff_bytes(
        RGB, 8, 2, compression=1)[8:].replace(b'\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00',
                                              b'\x03\x01\x03\x00\x01\x00\x00\x00'
                                              + struct.pack('<H', comp), 1)


REFUSED = [('jpeg', 'JPEG-in-TIFF'), ('group4', 'CCITT group 4'), ('ccitt3', 'CCITT group 3'),
           ('lzma', 'LZMA'), ('zstd', 'ZSTD'), ('webp', 'WebP-compressed'),
           ('float', 'float-sample'), ('ycbcr', 'YCbCr'), ('signed16', 'MinIsBlack 16-bit'),
           ('old_lzw', 'old-style LZW')]


@pytest.mark.parametrize('kind,what', REFUSED, ids=[k for k, _ in REFUSED])
def test_tiff_kinds_left_raise_naming_file_kind_and_item(tmp_path, kind, what):
    path = _write(tmp_path, _refused_tiff(kind), f'{kind}.tif')
    with pytest.raises(ValueError, match=f'{kind}.tif: {what}.*ROADMAP.md queue 1 item 6'):
        images.read_image(path, 'RGB')


def _cut_cases():
    return [n for n in sorted(os.listdir(MORE)) if n.endswith(('.tif', '.tiff', '.ico'))]


@pytest.mark.parametrize('name', _cut_cases())
def test_cut_tiff_and_ico_raise_naming_the_file(tmp_path, name):
    """Cut at four places: each raises naming the file, except where
    Pillow still reads the image (a cut in an ICO's unused AND mask or past
    a PNG entry's IDAT), and there the port reads what Pillow reads."""
    data = open(os.path.join(MORE, name), 'rb').read()
    raised = 0
    for n in (len(data) - 7, len(data) // 2, 30, 9):
        path = _write(tmp_path, data[:n], f'cut_{n}_{name}')
        try:
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                with Image.open(path) as im:
                    im.load()
        except Exception:                     # noqa: BLE001 - Pillow's own errors vary
            raised += 1
            with pytest.raises(ValueError, match=f'cut_{n}_{name}'):
                images.read_image(path, 'RGB')
        else:
            assert_reads_as_jax(path)
    assert raised >= 3


# ------------------------------------------------------------------- ICO

ICO = ['pillow_png', 'pillow_png_rgb', 'pillow_bmp', 'dib1', 'dib1_bw', 'dib4', 'dib8',
       'dib8_grey', 'dib24', 'dib32', 'png_wins_by_size', 'lower_depth_wins']


def _ico(case):
    rng = np.random.default_rng(len(case))
    mask = (rng.random((20, 24)) > 0.7).astype(np.uint8)
    bgra = np.concatenate([mk.photo(20, 24, 3, seed=4)[:, :, ::-1], mk.photo(20, 24, 1, seed=5)],
                          -1)
    idx = rng.integers(0, 200, (20, 24)).astype(np.uint8)
    pal = rng.integers(0, 256, 1024, dtype=np.uint8)
    pal[3::4] = 0
    if case.startswith('pillow'):
        arr = mk.photo(17, 33, 3 if case == 'pillow_png_rgb' else 4, seed=1)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, 'ICO', sizes=[(16, 16), (32, 32)],
                                  bitmap_format='bmp' if case == 'pillow_bmp' else 'png')
        return buf.getvalue()
    entry = {
        'dib1': lambda: (1, mk.dib_entry(idx % 2, 1, bytes(pal[:8]), mask)),
        'dib1_bw': lambda: (1, mk.dib_entry(idx % 2, 1, bytes([0, 0, 0, 0, 255, 255, 255, 0]),
                                            mask)),
        'dib4': lambda: (4, mk.dib_entry(idx % 16, 4, bytes(pal[:64]), mask)),
        'dib8': lambda: (8, mk.dib_entry(idx, 8, bytes(pal), mask)),
        'dib8_grey': lambda: (8, mk.dib_entry(idx, 8, bytes(np.repeat(np.arange(256, dtype=np.uint8),
                                                                      4)), mask)),
        'dib24': lambda: (24, mk.dib_entry(bgra[:, :, :3], 24, and_mask=mask)),
        'dib32': lambda: (32, mk.dib_entry(bgra, 32)),
    }
    if case == 'png_wins_by_size':
        return mk.ico_bytes([(24, 20, 8, mk.dib_entry(idx, 8, bytes(pal), mask)),
                             (32, 32, 32, images.encode_png(mk.photo(32, 32, 4, seed=3)))])
    if case == 'lower_depth_wins':
        return mk.ico_bytes([(24, 20, 32, mk.dib_entry(bgra, 32)),
                             (24, 20, 8, mk.dib_entry(idx, 8, bytes(pal), mask))])
    bits, data = entry[case]()
    return mk.ico_bytes([(24, 20, bits, data)])


@pytest.mark.parametrize('case', ICO)
def test_ico_variants(tmp_path, case):
    path = _write(tmp_path, _ico(case), 'v.ico')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        assert_reads_as_jax(path)
