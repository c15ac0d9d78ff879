"""The port's TIFF reader (``utils/tiff.py``; LZW, PackBits, CCITT fax,
ThunderScan and ZSTD in ``csrc/image_decode.cpp``) and its ICO reader
(``utils/images.py:decode_ico``) against the JAX package's Pillow calls,
bitwise, on the CPU (``test_torch_port_formats.py:assert_reads_as_jax``):

- TIFF written by ``make_formats.tiff_bytes`` and by Pillow: II and MM,
  strips and tiles, PlanarConfiguration 1 and 2, no compression, PackBits,
  LZW and Deflate (8 and 32946), the horizontal predictor at 8 and 16
  bits, FillOrder 2, MinIsWhite and MinIsBlack at 1/2/4/8/16 bits, grey +
  alpha, RGB at 8 and 16 bits with each ExtraSamples, palette at 1/2/4/8
  bits, CMYK at 8 and 16 bits, every Orientation; the kinds Pillow has no
  raw mode for raise in both;
- BigTIFF; JPEG-in-TIFF (strips and padded tiles, JPEGTables, each
  subsampling, YCbCr converted by libjpeg, grey, RGB and CMYK stored);
  LZMA; ZSTD (and the decoder against the zstd library on data of every
  block kind); YCbCr through libtiff's TIFFRGBAImage at six subsamplings
  with ReferenceBlackWhite and YCbCrCoefficients, and uncompressed YCbCr
  as Pillow's raw decoder reads it; float, signed 16/32-bit, unsigned
  32-bit and 12-bit samples with predictors 2 and 3 (MM's byte swap after
  libtiff); CCITT modified Huffman, RLEW, group 3 (1-D and 2-D, EOL fill)
  and group 4 with both fill orders; ThunderScan; old-style JPEG;
- CIELab through ``utils/cielab.py`` (its table against LittleCMS's, its
  conversion against Pillow's on a million triples);
- what Pillow does not read either raises in both, naming the file:
  WebP-compressed TIFF, big-endian BigTIFF, old-style JPEG without a
  stream, MM's 12-bit and unsigned 32-bit samples;
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
        return mk.tiff_bytes(RGB, 8, 2, compression=5, old_lzw=True, rows_per_strip=6)
    if kind == 'float':
        return mk.tiff_bytes(WIDE[:, :, :1].view(np.uint16), 16, 1, sample_format=3)
    if kind == 'ycbcr':
        return mk.tiff_bytes(mk.ycc_planes(RGB).transpose(1, 2, 0), 8, 6, compression=5,
                             ycbcr=(2, 2))
    if kind == 'signed16':
        return mk.tiff_bytes(WIDE[:, :, :1], 16, 1, sample_format=2)
    if kind == 'ccitt3':
        buf = io.BytesIO()
        Image.fromarray(RGB[:, :, 0] > 100).save(buf, 'TIFF', compression='group3',
                                                 tiffinfo={292: 1})
        return buf.getvalue()
    if kind == 'webp':
        comp = 50001
    else:
        return mk.tiff_bytes(RGB, 8, 2, compression={'lzma': 34925, 'zstd': 50000}[kind],
                             rows_per_strip=5)
    return mk.tiff_bytes(RGB, 8, 2, compression=1)[:8] + mk.tiff_bytes(
        RGB, 8, 2, compression=1)[8:].replace(b'\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00',
                                              b'\x03\x01\x03\x00\x01\x00\x00\x00'
                                              + struct.pack('<H', comp), 1)


# the kinds the port refused before it read them (each now as the JAX
# package reads it), and those Pillow does not read either
REFUSED = [('jpeg', None), ('group4', None), ('ccitt3', None), ('lzma', None), ('zstd', None),
           ('webp', 'WebP-compressed TIFF images are read neither by Pillow'),
           ('float', 'MinIsBlack 16-bit .sample format .3,.* TIFF images are read neither by '
                     'Pillow'), ('ycbcr', None), ('signed16', None),
           ('old_lzw', None)]


@pytest.mark.parametrize('kind,what', REFUSED, ids=[k for k, _ in REFUSED])
def test_tiff_kinds_left_raise_naming_file_kind_and_item(tmp_path, kind, what):
    path = _write(tmp_path, _refused_tiff(kind), f'{kind}.tif')
    if what is None:
        assert_reads_as_jax(path)
        return
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with pytest.raises(Exception):
            with Image.open(path) as im:
                im.load()
    with pytest.raises(ValueError, match=f'{kind}.tif: {what}'):
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


# ------------------------------------------- the rarer kinds (PR 27's)

YCC = mk.ycc_planes(RGB).transpose(1, 2, 0)
SUBSAMPLINGS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (4, 4)]
YCBCR = [(sub, comp) for sub in SUBSAMPLINGS for comp in (5, 8, 34925)]


@pytest.mark.parametrize('sub,compression', YCBCR,
                         ids=[f'{h}x{v}-c{c}' for (h, v), c in YCBCR])
def test_tiff_ycbcr_through_tiffrgbaimage(tmp_path, sub, compression):
    """libtiff's TIFFRGBAImage: each chroma sample over its block, the
    integer tables of TIFFYCbCrToRGB (default coefficients and reference
    levels here, others below); strips of whole units and tiles."""
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(YCC, 8, 6, compression=compression,
                                                       ycbcr=sub, rows_per_strip=2 * sub[1]),
                               'strips.tif'))
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(YCC, 8, 6, compression=compression,
                                                       ycbcr=sub, tile=(16, 16), order='>'),
                               'tiles.tif'))


@pytest.mark.parametrize('compression', [1, 5, 8])
def test_tiff_ycbcr_in_separate_planes(tmp_path, compression):
    """Three planes: TIFFRGBAImage converts them without subsampling and
    fails with it (Pillow then fails, and so does the port); Pillow's raw
    decoder reads uncompressed planes as R, G and B."""
    for sub in ((1, 1), (2, 2)):
        path = _write(tmp_path, mk.tiff_bytes(YCC, 8, 6, compression=compression, planar=2,
                                              rows_per_strip=5, tags={530: (3, list(sub))}),
                      f'p{sub[0]}.tif')
        if sub == (2, 2) and compression != 1:
            with pytest.raises(Exception):
                with Image.open(path) as im:
                    im.load()
            with pytest.raises(ValueError, match='p2.tif: subsampled YCbCr in separate planes'):
                images.read_image(path, 'RGB')
        else:
            assert_reads_as_jax(path)


@pytest.mark.parametrize('case', ['studio_range', 'bt709', 'odd_reference'])
def test_tiff_ycbcr_coefficients_and_reference(tmp_path, case):
    tags = {'studio_range': {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])},
            'bt709': {529: (5, [2126, 10000, 7152, 10000, 722, 10000])},
            'odd_reference': {529: (5, [3, 10, 6, 10, 1, 10]),
                              532: (5, [5, 2, 500, 2, 90, 1, 250, 1, 0, 1, 255, 1])}}[case]
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(YCC, 8, 6, compression=8, ycbcr=(2, 2),
                                                       tags=tags)))


@pytest.mark.parametrize('sub', [(1, 1), (2, 1), (2, 2)])
def test_tiff_uncompressed_ycbcr_as_pillow_reads_it(tmp_path, sub):
    """Pillow reads uncompressed YCbCr with its own raw decoder as 4 bytes
    a pixel ('RGBX') from each strip's offset on: where the file holds
    enough bytes it gives those bytes, else it fails as truncated; the port
    does the same (a small and a larger image, with and without trailing
    bytes)."""
    truncated = 0
    for k, (h, w) in enumerate(((H, W), (40, 60))):
        ycc = mk.ycc_planes(mk.photo(h, w, 3, seed=k)).transpose(1, 2, 0)
        data = mk.tiff_bytes(ycc, 8, 6, ycbcr=sub, rows_per_strip=4)
        for name, body in (('short', data), ('padded', data + bytes(4 * h * w))):
            path = _write(tmp_path, body, f'{name}{k}.tif')
            try:
                with Image.open(path) as im:
                    im.load()
            except OSError:
                truncated += 1
                with pytest.raises(ValueError, match=f'{name}{k}.tif: image file is truncated'):
                    images.read_image(path, 'RGB')
            else:
                assert_reads_as_jax(path)
    assert truncated >= (0 if sub == (1, 1) else 1)


JPEG_TIFF = [('ycbcr_tiles', dict(tile=(16, 16)), 6, dict(subsampling=2, tables=True)),
             ('ycbcr_strips_partial', dict(rows_per_strip=10), 6, dict(subsampling=2)),
             ('ycbcr_422_tiles', dict(tile=(32, 16)), 6, dict(subsampling=1, tables=True)),
             ('ycbcr_444', dict(rows_per_strip=16), 6, dict(subsampling=0)),
             ('rgb_stored', dict(rows_per_strip=8), 2, dict(subsampling=0, tables=True)),
             ('grey_tiles', dict(tile=(16, 32)), 1, dict(tables=True)),
             ('cmyk', dict(rows_per_strip=16), 5, dict()),
             ('rgb_planes', dict(rows_per_strip=8, planar=2), 2, dict(tables=True)),
             ('ycbcr_planes', dict(rows_per_strip=8, planar=2), 6, dict(subsampling=0))]


@pytest.mark.parametrize('case,layout,photo,jpeg', JPEG_TIFF, ids=[c for c, _, _, _ in JPEG_TIFF])
def test_tiff_jpeg_compressed(tmp_path, case, layout, photo, jpeg):
    """Each strip or tile its own JPEG stream (JPEGTables in front where
    the tables were moved there); YCbCr converted by libjpeg, the
    partial last strip's stream shorter, padded edge tiles cropped."""
    arr = {1: RGB[:, :, :1], 2: RGB, 5: mk.photo(H, W, 4, seed=6), 6: RGB}[photo]
    sub = {0: (1, 1), 1: (2, 1), 2: (2, 2)}.get(jpeg.get('subsampling', 2))
    tags = {530: (3, list(sub))} if photo == 6 else {}
    for order in '<>':
        assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(
            arr, 8, photo, order=order, compression=7, jpeg=dict(quality=85, **jpeg), tags=tags,
            **layout), f'{order == "<"}.tif'))


SAMPLES = [(kind, order, comp, pred) for kind in ('float', 'int16', 'int32', 'uint32')
           for order in '<>' for comp, pred in ((1, 1), (5, 2), (8, 1), (34925, 2), (50000, 1))]
_GREY = RGB[:, :, :1].astype(np.int64)


def _samples(kind):
    if kind == 'float':
        f = (_GREY.astype(np.float32) / 3 - 20)
        f[0, :4, 0] = [np.nan, np.inf, -np.inf, 254.75]
        return f.view(np.uint32), 32, 3
    if kind == 'int16':
        return (_GREY * 250 - 30000).astype(np.int16).view(np.uint16), 16, 2
    if kind == 'int32':
        return (_GREY * 100003 - 9000000).astype(np.int32).view(np.uint32), 32, 2
    return (_GREY * 40000000).astype(np.uint32), 32, None


@pytest.mark.parametrize('kind,order,compression,predictor', SAMPLES,
                         ids=[f'{k}-{"II" if o == "<" else "MM"}-c{c}-p{p}'
                              for k, o, c, p in SAMPLES])
def test_tiff_float_signed_and_32_bit_samples(tmp_path, kind, order, compression, predictor):
    """Modes 'F' and 'I' (Pillow's convert('L')/('RGB') clip them; F
    truncates, NaN reads 0); a compressed MM file reads with the bytes
    libtiff swapped to the host's order, as Pillow reads it; MM has no
    unsigned 32-bit mode, so Pillow fails and so does the port."""
    arr, bits, fmt = _samples(kind)
    if predictor == 2 and kind == 'float':
        predictor = 3
    path = _write(tmp_path, mk.tiff_bytes(arr, bits, 1, order=order, compression=compression,
                                          predictor=predictor, sample_format=fmt,
                                          rows_per_strip=5))
    if kind == 'uint32' and order == '>':
        with pytest.raises(ValueError, match='v.tif: MinIsBlack 32-bit .* read neither by Pillow'):
            images.read_image(path, 'L')
        return
    assert_reads_as_jax(path)


@pytest.mark.parametrize('order', '<>')
def test_tiff_12_bit_and_floating_point_predictor(tmp_path, order):
    grey12 = (RGB[:, :, :1].astype(np.uint16) * 16 + 5)
    path = _write(tmp_path, mk.tiff_bytes(grey12, 12, 1, order=order, compression=5), 'g12.tif')
    if order == '>':                          # OPEN_INFO has 12-bit for II only
        with pytest.raises(ValueError, match='g12.tif: MinIsBlack 12-bit'):
            images.read_image(path, 'L')
    else:
        assert_reads_as_jax(path)
    f = (RGB.astype(np.float32) - 100.5).view(np.uint32)[:, :, :1]
    for comp in (5, 8, 50000):
        assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(f, 32, 1, order=order, compression=comp,
                                                           predictor=3, sample_format=3,
                                                           tile=(16, 16)), f'p3_{comp}.tif'))


FAX = [(comp, opts, fill) for comp, optss in (('group3', (0, 1, 4, 5)), ('group4', (None,)),
                                              ('tiff_ccitt', (None,)))
       for opts in optss for fill in (1, 2)]


@pytest.mark.parametrize('compression,options,fill', FAX,
                         ids=[f'{c}-{o}-fill{f}' for c, o, f in FAX])
def test_tiff_ccitt(tmp_path, compression, options, fill):
    """Pillow's libtiff writes each fax coding (group 3 1-D or 2-D by
    T4Options, with EOL fill bits where bit 2 is set); long runs reach the
    makeup codes past 1728 of a 2600 pixel row."""
    rng = np.random.default_rng(len(FAX) + (options or 0))
    wide = np.zeros((6, 2600), bool)
    wide[1, 100:2400] = True
    wide[2, 3:2590] = True
    wide[3::2] = rng.random((2, 2600)) > 0.3
    for k, arr in enumerate((RGB[:, :, 0] > 120, wide)):
        info = {266: fill} if fill == 2 else {}
        if options is not None:
            info[292] = options
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, 'TIFF', compression=compression, tiffinfo=info)
        assert_reads_as_jax(_write(tmp_path, buf.getvalue(), f'f{k}.tif'))


def test_tiff_ccitt_rlew_and_miniswhite(tmp_path):
    """RLEW (32771): libtiff aligns each row on its byte pointer, so a row
    may start at an odd byte where its bit buffer held 16 bits; the port
    reads the files libtiff reads whole, bitwise, and raises where libtiff
    meets a bad code word (Pillow then returns a damaged image). Modified
    Huffman of a MinIsWhite image from the TIFF writer."""
    clean = 0
    for seed in range(12):
        bits = mk.photo(45, 67, 1, seed=seed)[:, :, 0] > 100 + seed
        buf = io.BytesIO()
        Image.fromarray(bits).save(buf, 'TIFF', compression='tiff_raw_16')
        path = _write(tmp_path, buf.getvalue(), f'rlew{seed}.tif')
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            try:
                with Image.open(path) as im:
                    whole = np.array_equal(np.asarray(im), bits)
            except Exception:                 # noqa: BLE001 - Pillow's own errors vary
                whole = False
        if whole:
            clean += 1
            assert_reads_as_jax(path)
    assert clean >= 3


@pytest.mark.parametrize('width', [67, 8, 7, 1])
def test_tiff_thunderscan(tmp_path, width):
    """ThunderScan's runs (from an odd pixel too), 2-bit and 3-bit deltas
    and raw pixels, a row at a time from pixel 0; a row that decodes to a
    wrong count fails in libtiff and in the port."""
    grey4 = RGB[:, :width, :1] >> 4
    grey4[2, :] = 7
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(grey4, 4, 1, compression=32809,
                                                       rows_per_strip=7)))
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(grey4, 4, 0, compression=32809,
                                                       order='>'), 'white.tif'))
    bad = mk.tiff_bytes(grey4, 4, 1, compression=32809)
    codes = mk.thunder_encode(grey4[:, :, 0])
    at = bad.index(codes)
    path = _write(tmp_path, bad[:at] + bytes([0x3F]) + bad[at + 1:], 'bad.tif')
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.load()
    with pytest.raises(ValueError, match='bad.tif: corrupt ThunderScan data'):
        images.read_image(path, 'L')


@pytest.mark.parametrize('sub', [0, 1, 2])
def test_tiff_old_style_jpeg(tmp_path, sub):
    """Old-style JPEG whose JPEGInterchangeFormat points to a stream: its
    raw YCbCr converted by libtiff's tables, each chroma sample over its
    block; without the tag, libtiff reads the stream its strip holds; with
    neither, Pillow fails and so does the port."""
    stream = io.BytesIO()
    Image.fromarray(RGB).save(stream, 'JPEG', quality=80, subsampling=sub)
    assert_reads_as_jax(_write(tmp_path, mk.ojpeg_tiff(stream.getvalue(), W, H), 'o.tif'))
    assert_reads_as_jax(_write(tmp_path, mk.ojpeg_tiff(stream.getvalue(), W, H,
                                                       interchange=False), 'strip.tif'))
    raw = stream.getvalue()
    path = _write(tmp_path, mk.ojpeg_tiff(raw[raw.index(b'\xff\xda'):], W, H, interchange=False),
                  'none.tif')
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.load()
    with pytest.raises(ValueError, match='none.tif: old-style JPEG without'):
        images.read_image(path, 'RGB')


BIG = [('lzw_tiles', dict(compression=5, tile=(16, 16))), ('deflate_strips',
                                                            dict(compression=8, rows_per_strip=4)),
       ('raw', dict()), ('zstd_planar', dict(compression=50000, planar=2)),
       ('jpeg_strips', dict(compression=7, rows_per_strip=16, jpeg=dict(quality=80)))]


@pytest.mark.parametrize('case,kw', BIG, ids=[c for c, _ in BIG])
def test_bigtiff(tmp_path, case, kw):
    """BigTIFF (8-byte offsets and counts, LONG8 strip offsets); Pillow
    takes the version from byte 2 only, so it reads no big-endian BigTIFF,
    and the port refuses it too."""
    photo = 6 if case == 'jpeg_strips' else 2
    path = _write(tmp_path, mk.tiff_bytes(RGB, 8, photo, big=True, **kw))
    assert_reads_as_jax(path)
    path = _write(tmp_path, mk.tiff_bytes(RGB, 8, 2, big=True, order='>'), 'mm.tif')
    with pytest.raises(Exception):
        Image.open(path)
    with pytest.raises(ValueError, match='mm.tif: big-endian BigTIFF TIFF images are read neither'):
        images.read_image(path, 'RGB')


def test_zstd_decoder_against_the_zstd_library():
    """RFC 8878 against the zstd library Pillow bundles, on data that
    brings each block kind: raw and RLE blocks, raw, RLE, Huffman (one and
    four streams) and treeless literals, predefined, RLE, described and
    repeated sequence tables, repeat offsets, several blocks a frame."""
    from hcpdiff_tpu_torch.utils import native
    rng = np.random.default_rng(7)
    text = b''.join(rng.choice([b'the ', b'quick ', b'brown ', b'fox ', b'jumps '], 40000))
    cases = [b'', bytes(5000), bytes(rng.integers(0, 256, 3000, dtype=np.uint8)), text,
             bytes(rng.integers(0, 4, 300000, dtype=np.uint8)),
             (np.cumsum(rng.integers(-2, 3, 400000)) % 256).astype(np.uint8).tobytes(),
             bytes(rng.zipf(1.6, 200000).clip(0, 255).astype(np.uint8)), text[:70]]
    for data in cases:
        for level in (-3, 1, 3, 9, 19):
            got = native.zstd(mk.zstd_compress(data, level), len(data))
            assert got.tobytes() == data, (len(data), level)
    with pytest.raises(ValueError, match='corrupt ZSTD data'):
        native.zstd(mk.zstd_compress(text, 3)[:-9], len(text))


@pytest.mark.parametrize('compression', [None, 'tiff_lzw', 'tiff_adobe_deflate', 'packbits'])
def test_tiff_cielab(tmp_path, compression):
    """CIELab reads as 'LAB' (the file's bytes) and converts to RGB as
    Pillow's LittleCMS transform does; Pillow has no LAB to L, and the
    port's grey readers raise too (``assert_reads_as_jax``)."""
    buf = io.BytesIO()
    Image.fromarray(mk.photo(H, W, 3, seed=8)).convert('LAB').save(buf, 'TIFF',
                                                                   compression=compression)
    assert_reads_as_jax(_write(tmp_path, buf.getvalue(), 'lab.tif'))
    assert_reads_as_jax(_write(tmp_path, mk.tiff_bytes(
        np.random.default_rng(9).integers(0, 256, (H, W, 3)), 8, 8, order='>', compression=5,
        predictor=2, rows_per_strip=4), 'lab_mm.tif'))


def test_cielab_conversion_against_littlecms():
    """``utils/cielab.py`` against the LittleCMS Pillow bundles: its 33^3
    nodes against an unoptimised Lab16 -> RGB16 transform at the node
    inputs, and its 8-bit conversion against Pillow's convert('RGB') on a
    million Lab triples and every L, a and b edge (the whole 2^24 matched
    when it was written)."""
    import ctypes
    import glob
    import PIL
    from hcpdiff_tpu_torch.utils import cielab
    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), '..', 'pillow.libs',
                                             'liblcms2*'))[0])
    lib.cmsCreateLab2Profile.restype = lib.cmsCreate_sRGBProfile.restype = ctypes.c_void_p
    lib.cmsCreateLab2Profile.argtypes = [ctypes.c_void_p]
    lib.cmsCreateTransform.restype = ctypes.c_void_p
    lib.cmsCreateTransform.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                       ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
    lib.cmsDoTransform.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_uint32]
    lab16, rgb16 = (10 << 16) | (3 << 3) | 2, (4 << 16) | (3 << 3) | 2   # TYPE_Lab_16, _RGB_16
    xform = lib.cmsCreateTransform(lib.cmsCreateLab2Profile(None), lab16,
                                   lib.cmsCreate_sRGBProfile(), rgb16, 0, 0x0100)  # NOOPTIMIZE
    q = np.floor(np.arange(33) * 65535.0 / 32 + 0.5).astype(np.uint16)
    grid = np.ascontiguousarray(np.stack(np.meshgrid(q, q, q, indexing='ij'), -1).reshape(-1, 3))
    want = np.zeros_like(grid)
    lib.cmsDoTransform(xform, grid.ctypes.data, want.ctypes.data, len(grid))
    np.testing.assert_array_equal(cielab.nodes().reshape(-1, 3), want)
    rng = np.random.default_rng(10)
    edges = np.array([0, 1, 2, 126, 127, 128, 129, 130, 253, 254, 255], np.uint8)
    lab = np.concatenate([rng.integers(0, 256, (1 << 20, 3), dtype=np.uint8),
                          np.stack(np.meshgrid(edges, edges, edges), -1).reshape(-1, 3)])
    im = Image.frombytes('LAB', (len(lab), 1), lab.tobytes())
    np.testing.assert_array_equal(cielab.lab_to_rgb(lab), np.asarray(im.convert('RGB'))[0])


def _rare_cut_cases():
    folder = os.path.join(DATA, 'torch_port_rare')
    return [n for n in sorted(os.listdir(folder)) if n.endswith(('.tif', '.jpg'))]


@pytest.mark.parametrize('name', _rare_cut_cases())
def test_cut_rare_files_raise_naming_the_file(tmp_path, name):
    """Each committed rare file cut at three places: where Pillow fails the
    port raises naming the file, and where Pillow still reads (a cut past
    what it needs) the port reads the same."""
    data = open(os.path.join(DATA, 'torch_port_rare', name), 'rb').read()
    raised = 0
    for n in (len(data) - 5, len(data) // 2, 40):
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
    assert raised >= 2
