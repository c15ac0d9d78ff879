"""The port's JPEG decoder (``csrc/image_decode.cpp`` through
``utils/jpeg.py``) on the kinds libjpeg-turbo 3 reads besides baseline and
progressive Huffman files, against the JAX package's Pillow calls, bitwise
(``test_torch_port_formats.py:assert_reads_as_jax``), on the CPU:

- progressive files cut after their first scans, an EOI appended, which
  libjpeg smooths (``jdcoefct.c:decompress_smooth_data``): every cut of
  Pillow's scan script at 4:2:0, 4:2:2, 4:4:4 and grey, block rows of odd
  count (the 5x5 neighbourhood reaching a dummy row), one and two block
  columns, restart intervals, and arithmetic-coded ones;
- arithmetic coding (SOF9 sequential, SOF10 progressive) written by
  ``make_formats.jpeg_arith`` (a mirror of ``jcarith.c``): samplings,
  qualities, restart intervals, DAC conditioning (L, U and Kx), table
  indices above 3;
- lossless Huffman JPEG (SOF3) by ``make_formats.jpeg_lossless``:
  predictors 1-7, point transforms, restarts, grey, RGB and CMYK,
  subsampled components (replicated);
- what Pillow does not read either raises in both, naming the file: a
  precision other than 8 (12 and 16 bits, lossless at 2-7), hierarchical
  frames, lossless arithmetic coding (SOF11), lossless YCbCr;
- cut and corrupt data of each coding raises naming the file where Pillow
  raises.
"""
import io
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from hcpdiff_tpu_torch.data import utils as tutils
from hcpdiff_tpu_torch.utils import images
from hcpdiff_tpu_torch.utils.jpeg import UnsupportedJPEG
from test_torch_port_formats import assert_reads_as_jax, mk

RGB = mk.photo(45, 67, 3, seed=41)
YCC = mk.ycc_planes(RGB)


def _write(tmp_path, data, name='v.jpg'):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _pillow_jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, 'JPEG', **kw)
    return buf.getvalue()


def _pillow_fails(path):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        try:
            with Image.open(path) as im:
                im.load()
        except Exception:                     # noqa: BLE001 - Pillow's own errors vary
            return True
    return False


# ------------------------------------------------------------- smoothing

SMOOTH = [('420', (37, 53), 2), ('422', (45, 67), 1), ('444', (45, 67), 0),
          ('grey', (45, 67), None), ('narrow', (35, 9), 2), ('one_column', (41, 8), 0)]


@pytest.mark.parametrize('case,size,sub', SMOOTH, ids=[c for c, _, _ in SMOOTH])
def test_cut_progressive_files_are_smoothed_as_libjpeg_does(tmp_path, case, size, sub):
    arr = mk.photo(*size, 3, seed=42)
    if sub is None:
        data = _pillow_jpeg(arr[:, :, 0], quality=85, progressive=True)
    else:
        data = _pillow_jpeg(arr, quality=85, progressive=True, subsampling=sub)
    for k in range(1, len(mk.scan_starts(data))):
        assert_reads_as_jax(_write(tmp_path, mk.cut_progressive(data, k), f'cut{k}.jpg'))


def test_cut_progressive_with_restarts_and_arithmetic(tmp_path):
    data = _pillow_jpeg(RGB, quality=75, progressive=True, restart_marker_blocks=3)
    for k in (1, 2, 4):
        assert_reads_as_jax(_write(tmp_path, mk.cut_progressive(data, k), f'r{k}.jpg'))
    for k in (1, 2, 3, 5, 7):
        script = mk.SIMPLE_PROGRESSION[3][:k]
        assert_reads_as_jax(_write(tmp_path, mk.jpeg_arith(YCC, [(2, 2), (1, 1), (1, 1)],
                                                           script=script), f'a{k}.jpg'))


# ------------------------------------------------------------ arithmetic

ARITH = [('seq_420', [(2, 2), (1, 1), (1, 1)], {}), ('seq_444_q95', [(1, 1)] * 3,
                                                    dict(quality=95)),
         ('seq_422_restarts', [(2, 1), (1, 1), (1, 1)], dict(restart=5)),
         ('seq_dac', [(2, 2), (1, 1), (1, 1)], dict(dac={0: (2, 6), 1: (1, 1)}, kx=1)),
         ('seq_440_q30', [(1, 2), (1, 1), (1, 1)], dict(quality=30)),
         ('prog_420', [(2, 2), (1, 1), (1, 1)], dict(script=mk.SIMPLE_PROGRESSION[3])),
         ('prog_444_restarts', [(1, 1)] * 3, dict(script=mk.SIMPLE_PROGRESSION[3], restart=4)),
         ('prog_dac', [(2, 1), (1, 1), (1, 1)], dict(script=mk.SIMPLE_PROGRESSION[3],
                                                     dac={0: (0, 3)}, kx=9))]


@pytest.mark.parametrize('case,factors,kw', ARITH, ids=[c for c, _, _ in ARITH])
def test_arithmetic_coded_jpeg(tmp_path, case, factors, kw):
    assert_reads_as_jax(_write(tmp_path, mk.jpeg_arith(YCC, factors, **kw)))


@pytest.mark.parametrize('progressive', [False, True])
def test_arithmetic_grey_and_large_values(tmp_path, progressive):
    """One component (single-component scans), and quality 100 at a
    noisy image: magnitude categories up to the X15 bins."""
    noisy = np.random.default_rng(5).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    script = mk.SIMPLE_PROGRESSION[1] if progressive else None
    assert_reads_as_jax(_write(tmp_path, mk.jpeg_arith(YCC[:1], [(1, 1)], script=script),
                               'grey.jpg'))
    assert_reads_as_jax(_write(tmp_path, mk.jpeg_arith(mk.ycc_planes(noisy), [(1, 1)] * 3,
                                                       quality=100, script=script and
                                                       mk.SIMPLE_PROGRESSION[3]), 'noisy.jpg'))


def test_arithmetic_tables_above_three(tmp_path):
    """Arithmetic coding has 16 conditioning tables: a scan naming table 9
    reads its DAC values (Huffman's limit of 3 does not apply)."""
    data = bytearray(mk.jpeg_arith(YCC[:1], [(1, 1)], dac={0: (1, 2)}))
    dac = data.index(b'\xff\xcc')
    data[dac + 4] = 9                         # DC table 9, and the scan's Td with it
    sos = data.index(b'\xff\xda')
    data[sos + 6] = 0x90
    assert_reads_as_jax(_write(tmp_path, bytes(data)))


# -------------------------------------------------------------- lossless

LOSSLESS = [(psv, pt, rows) for psv in range(1, 8) for pt, rows in ((0, 0), (2, 7))]


@pytest.mark.parametrize('psv,pt,rows', LOSSLESS,
                         ids=[f'p{p}-pt{t}-rst{r}' for p, t, r in LOSSLESS])
def test_lossless_jpeg(tmp_path, psv, pt, rows):
    assert_reads_as_jax(_write(tmp_path, mk.jpeg_lossless(RGB.transpose(2, 0, 1), psv, pt, rows,
                                                          ids=[82, 71, 66]), 'rgb.jpg'))
    assert_reads_as_jax(_write(tmp_path, mk.jpeg_lossless(RGB[None, :, :, 1], psv, pt, rows),
                               'grey.jpg'))


@pytest.mark.parametrize('factors', [[(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
                                     [(1, 2), (1, 1), (1, 1)], [(1, 1), (2, 2), (1, 2)]],
                         ids=['420', '422', '440', 'mixed'])
def test_lossless_subsampled(tmp_path, factors):
    """Subsampled lossless components: libjpeg-turbo replicates them (its
    fancy upsampling wants a DCT size above 1)."""
    for psv in (1, 7):
        assert_reads_as_jax(_write(tmp_path, mk.jpeg_lossless(
            RGB.transpose(2, 0, 1), psv, ids=[82, 71, 66], factors=factors), f'p{psv}.jpg'))


def test_lossless_component_ids_and_cmyk(tmp_path):
    """libjpeg-turbo 3 takes three lossless components for RGB whatever
    their ids (and four for CMYK), where a DCT file's 1, 2, 3 is YCbCr."""
    assert_reads_as_jax(_write(tmp_path, mk.jpeg_lossless(RGB.transpose(2, 0, 1), 1), 'ids.jpg'))
    cmyk = mk.photo(45, 67, 4, seed=43).transpose(2, 0, 1)
    assert_reads_as_jax(_write(tmp_path, mk.jpeg_lossless(cmyk, 5), 'cmyk.jpg'))


# --------------------------------------------------- what Pillow refuses

def _patched(marker_byte=None, precision=None, lossless=False):
    data = bytearray(mk.jpeg_lossless(RGB.transpose(2, 0, 1), 1, ids=[82, 71, 66]) if lossless
                     else _pillow_jpeg(RGB, quality=80))
    sof = data.index(b'\xff\xc3' if lossless else b'\xff\xc0')
    if marker_byte is not None:
        data[sof + 1] = marker_byte
    if precision is not None:
        data[sof + 4] = precision
    return bytes(data)


REFUSED = [('12bit', dict(precision=12), '12-bit'), ('16bit', dict(precision=16), '16-bit'),
           ('lossless_6bit', dict(precision=6, lossless=True), '6-bit'),
           ('lossless_12bit', dict(precision=12, lossless=True), '12-bit'),
           ('sof5', dict(marker_byte=0xC5), 'hierarchical'),
           ('sof7', dict(marker_byte=0xC7), 'hierarchical'),
           ('sof13', dict(marker_byte=0xCD), 'hierarchical'),
           ('sof11', dict(marker_byte=0xCB, lossless=True), 'lossless arithmetic-coded')]


@pytest.mark.parametrize('case,kw,what', REFUSED, ids=[c for c, _, _ in REFUSED])
def test_kinds_pillow_refuses_raise_in_both(tmp_path, case, kw, what):
    path = _write(tmp_path, _patched(**kw), f'{case}.jpg')
    assert _pillow_fails(path)
    for reader in (tutils.load_rgb, tutils.load_gray, lambda p: images.read_image(p, 'RGB')):
        with pytest.raises(UnsupportedJPEG, match=f'{case}.jpg: {what} JPEG files are read '
                                                  'neither by Pillow'):
            reader(path)


def test_lossless_ycbcr_raises_in_both(tmp_path):
    """A JFIF lossless file is YCbCr, which libjpeg-turbo does not convert
    in lossless mode: Pillow fails, and so does the port."""
    path = _write(tmp_path, mk.jpeg_lossless(YCC, 6, jfif=True), 'ycc.jpg')
    assert _pillow_fails(path)
    with pytest.raises(UnsupportedJPEG, match='ycc.jpg: lossless YCbCr'):
        tutils.load_rgb(path)


# ------------------------------------------------------- cut and corrupt

CODINGS = {'arith_seq': lambda: mk.jpeg_arith(YCC, [(2, 2), (1, 1), (1, 1)], restart=6),
           'arith_prog': lambda: mk.jpeg_arith(YCC, [(1, 1)] * 3,
                                               script=mk.SIMPLE_PROGRESSION[3]),
           'lossless': lambda: mk.jpeg_lossless(RGB.transpose(2, 0, 1), 4, restart_rows=9,
                                                 ids=[82, 71, 66]),
           'smoothed': lambda: mk.cut_progressive(_pillow_jpeg(RGB, progressive=True), 2)}


@pytest.mark.parametrize('coding', sorted(CODINGS))
def test_cut_and_corrupt_data_raise_naming_the_file(tmp_path, coding):
    """Cut inside the data (no EOI): Pillow fails, and the port raises
    naming the file. A frame header whose components are not the scan's,
    and a DHT or DAC segment that runs past its length, raise in both."""
    data = CODINGS[coding]()
    first = mk.scan_starts(data)[0]
    for n in (first + 20, (first + len(data)) // 2, len(data) - 40):
        path = _write(tmp_path, data[:n], f'cut_{n}.jpg')
        assert _pillow_fails(path)
        with pytest.raises(ValueError, match=f'cut_{n}.jpg'):
            tutils.load_rgb(path)
    bad = bytearray(data)
    bad[first + 5] = 77                       # the scan names a component the frame lacks
    path = _write(tmp_path, bytes(bad), 'bad_scan.jpg')
    assert _pillow_fails(path)
    with pytest.raises(ValueError, match='bad_scan.jpg: corrupt or cut JPEG data'):
        tutils.load_gray(path)


def test_sequential_arithmetic_scan_with_progressive_parameters_raises(tmp_path):
    """A progressive Huffman file with its SOF byte patched to SOF9: libjpeg
    only warns of the scans' progressive parameters, and its output then
    follows its buffer mode; the port raises, naming the file."""
    data = bytearray(_pillow_jpeg(RGB, progressive=True))
    data[data.index(b'\xff\xc2') + 1] = 0xC9
    path = _write(tmp_path, bytes(data), 'patched.jpg')
    with pytest.raises(ValueError, match='patched.jpg: corrupt or cut JPEG data .a sequential '
                                         'scan with progressive parameters'):
        tutils.load_rgb(path)


def test_committed_rare_jpegs_decode_with_each_coding():
    """The committed files cover each coding: their frame markers."""
    folder = os.path.join(mk.DATA, 'torch_port_rare')
    markers = set()
    for name in os.listdir(folder):
        if name.endswith('.jpg'):
            data = open(os.path.join(folder, name), 'rb').read()
            markers |= {m for m in (0xC2, 0xC3, 0xC9, 0xCA) if bytes([0xFF, m]) in data}
    assert markers == {0xC2, 0xC3, 0xC9, 0xCA}
