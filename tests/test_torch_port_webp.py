"""The port's WebP reader (``utils/webp.py`` over ``csrc/webp_decode.cpp``)
against the JAX package's Pillow calls, bitwise, on the CPU
(``test_torch_port_formats.py:assert_reads_as_jax``: the decoded mode and
pixels, ``load_rgb`` over three backgrounds, ``load_gray``, ``read_image``):

- lossy VP8 from Pillow's encoder at odd and even sizes down to 1x1 and
  several qualities; the committed files cover the simple and the normal
  loop filter, sharpness, segments and 2 and 8 token partitions, which
  each file's header is checked to hold;
- lossless VP8L: photos, and palettes of 2 to 256 colours (every
  colour-indexing bundle width), with and without alpha; together they use
  every transform, the colour cache and meta prefix codes;
- VP8X with ALPH raw and VP8L-coded under each of the four filters, with
  ICCP/EXIF/XMP chunks, and animations: Pillow's, ``write_webp_anim``'s,
  and a first frame at an offset of a larger canvas;
- a cut or corrupted file raises a ``ValueError`` naming it.
"""
import io
import os

import numpy as np
import pytest
from PIL import Image

from hcpdiff_tpu_torch.utils import images, native, webp
from test_torch_port_formats import DATA, assert_reads_as_jax, mk

MORE = os.path.join(DATA, 'torch_port_webp_tiff_ico')


def _write(tmp_path, data, name='v.webp'):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _info(data):
    """What each coded chunk of a WebP file used: [('VP8 ' | 'VP8L' |
    'ALPH', info)] (``csrc/webp_decode.cpp``'s info fields; ALPH: its
    header's method and filter)."""
    out = []
    chunks = webp.riff_chunks(data[12:], 'info')
    for kind, p in chunks:
        if kind == b'ANMF':
            chunks += webp.riff_chunks(p[16:], 'info')
    for kind, p in chunks:
        info = []
        if kind == b'VP8 ':
            native.vp8_decode(p, *webp.vp8_size(p, 'info'), info)
        elif kind == b'VP8L':
            native.vp8l_decode(p, *webp.vp8l_header(p, 'info')[:2], info)
        elif kind == b'ALPH':
            info = [p[0] & 3, (p[0] >> 2) & 3]
        else:
            continue
        out.append((kind.decode(), info))
    return out


def test_committed_lossy_files_hold_each_coding_tool():
    """The committed files' headers: [filter type, partitions, segments,
    sharpness, B_PRED macroblocks, skip flag]."""
    got = {n: _info(open(os.path.join(MORE, n), 'rb').read())
           for n in sorted(os.listdir(MORE)) if n.endswith('.webp')}
    assert got['lossy_simple_8parts.webp'][0][1][:4] == [1, 8, 1, 3]
    assert got['lossy_sharp_2parts.webp'][0][1][:4] == [2, 2, 1, 5]
    assert got['lossy_512.webp'][0][1][0] == 2 and got['lossy_512.webp'][0][1][4] > 0
    assert got['alpha_lossless_gradient.webp'][0] == ('ALPH', [1, 3])
    assert got['alpha_raw_horizontal.webp'][0] == ('ALPH', [0, 1])
    assert got['lossless_palette_rgba.webp'][0][1][0] == 8           # colour indexing
    assert got['lossless_palette_rgba.webp'][0][1][3] == 2           # 4 indices a byte
    assert got['lossless_512.webp'][0][1][2] > 1                     # meta prefix codes
    assert [k for k, _ in got['anim_offset.webp']] == ['VP8 ', 'VP8 ']


LOSSY = [(1, 1, 80), (2, 2, 80), (3, 5, 50), (16, 16, 90), (17, 33, 30), (33, 17, 75),
         (45, 67, 5), (45, 67, 100), (64, 48, 60)]


@pytest.mark.parametrize('h,w,q', LOSSY, ids=[f'{h}x{w}-q{q}' for h, w, q in LOSSY])
def test_lossy_variants(tmp_path, h, w, q):
    rgb = mk.photo(h, w, 3, seed=h * w + q)
    assert_reads_as_jax(_write(tmp_path, mk.pillow_webp(rgb, quality=q, method=q % 7)))


LOSSLESS = ['photo', 'photo_rgba', 'smooth_m0', 'smooth_m6', 'colours_2', 'colours_3',
            'colours_4', 'colours_5', 'colours_16', 'colours_17', 'colours_256', 'near_lossless']


def _lossless(case):
    h, w = 37, 53
    rgb = mk.photo(h, w, 3, seed=len(case))
    alpha = mk.photo(h, w, 1, seed=7)
    if case == 'photo':
        return mk.pillow_webp(rgb, lossless=True)
    if case == 'photo_rgba':
        return mk.pillow_webp(np.concatenate([rgb, alpha], -1), lossless=True, exact=True)
    if case.startswith('smooth'):
        smooth = mk.photo(h, w, 3, seed=3, noise=0.0)
        return mk.pillow_webp(smooth, lossless=True, method=int(case[-1]), quality=100)
    if case == 'near_lossless':
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, 'WEBP', lossless=True, quality=10)
        return buf.getvalue()
    n = int(case.split('_')[1])
    rng = np.random.default_rng(n)
    palette = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    palette[:, 3] = np.where(np.arange(n) % 3 == 0, 255, palette[:, 3])
    idx = (rgb[:, :, 0].astype(np.int64) * n // 256)
    return mk.pillow_webp(palette[idx], lossless=True, exact=True)


@pytest.mark.parametrize('case', LOSSLESS)
def test_lossless_variants(tmp_path, case):
    assert_reads_as_jax(_write(tmp_path, _lossless(case)))


def test_lossless_variants_use_every_transform_the_cache_and_meta_codes():
    infos = [i for case in LOSSLESS for k, i in _info(_lossless(case)) if k == 'VP8L']
    infos.append(_info(open(os.path.join(MORE, 'lossless_512.webp'), 'rb').read())[0][1])
    assert np.bitwise_or.reduce([i[0] for i in infos]) == 0b1111
    assert {i[3] for i in infos} >= {0, 1, 2, 3}                      # bundle bits
    assert max(i[1] for i in infos) > 0 and max(i[2] for i in infos) > 1


ALPHA = [(method, kind) for method in (0, 1) for kind in (0, 1, 2, 3)]


@pytest.mark.parametrize('method,kind', ALPHA, ids=[f'{"vp8l" if m else "raw"}-filter{k}'
                                                    for m, k in ALPHA])
def test_alpha_variants(tmp_path, method, kind):
    h, w = 29, 43
    rgb = mk.photo(h, w, 3, seed=31)
    alpha = mk.photo(h, w, 1, seed=32)[:, :, 0]
    alpha[:, :5] = 255
    alpha[3:9] = 0
    data = mk.webp_with_alpha(rgb, alpha, method, kind)
    assert _info(data)[0] == ('ALPH', [method, kind])
    assert_reads_as_jax(_write(tmp_path, data))


def test_pillow_lossy_alpha_and_metadata_chunks(tmp_path):
    """Pillow's RGBA lossy files (its alpha filtering and quantised alpha,
    the pre-processing bits set), and ICCP, EXIF and XMP chunks skipped."""
    rgba = np.concatenate([mk.photo(31, 45, 3, seed=33), mk.photo(31, 45, 1, seed=34)], -1)
    for k, kw in enumerate([dict(quality=80), dict(quality=60, alpha_quality=30),
                            dict(quality=90, icc_profile=b'\0' * 131, exif=b'Exif\0\0' + b'x' * 9,
                                 xmp=b'<x:xmpmeta/>')]):
        path = _write(tmp_path, mk.pillow_webp(rgba, **kw), f'a{k}.webp')
        assert_reads_as_jax(path)
    rgb_meta = mk.pillow_webp(rgba[:, :, :3], quality=70, icc_profile=b'\1' * 64)
    assert [k for k, _ in webp.riff_chunks(rgb_meta[12:], 'x')][:2] == [b'VP8X', b'ICCP']
    assert_reads_as_jax(_write(tmp_path, rgb_meta, 'meta.webp'))


@pytest.mark.parametrize('case', ['pillow_lossy', 'pillow_lossless', 'port', 'offset_vp8l_alpha'])
def test_animated_first_frame(tmp_path, case):
    frames = [mk.photo(27, 41, 3, seed=40 + k) for k in range(3)]
    path = str(tmp_path / 'anim.webp')
    if case.startswith('pillow'):
        Image.fromarray(frames[0]).save(path, 'WEBP', save_all=True, duration=50,
                                        append_images=[Image.fromarray(f) for f in frames[1:]],
                                        lossless=case.endswith('lossless'), quality=70)
    elif case == 'port':
        images.write_webp_anim(path, frames, 60)
    else:                                     # a VP8L frame with alpha at (6, 4) of 41x27
        rgba = np.concatenate([frames[1][:16, :20], mk.photo(16, 20, 1, seed=44)], -1)
        (_, vp8l), = mk.webp_chunks(mk.pillow_webp(rgba, lossless=True, exact=True))
        open(path, 'wb').write(mk.webp_anim_offset((41, 27), [(b'VP8L', vp8l)], (6, 4), (20, 16)))
    with Image.open(path) as im:
        assert getattr(im, 'n_frames', 1) >= 2
    assert_reads_as_jax(path)


def _cuts(data):
    return [len(data) - 1, len(data) // 2, 40, 21, 13]


@pytest.mark.parametrize('name', ['lossy_512.webp', 'lossless_512.webp',
                                  'alpha_lossless_gradient.webp', 'anim_offset.webp'])
def test_cut_webp_raises_naming_the_file(tmp_path, name):
    data = open(os.path.join(MORE, name), 'rb').read()
    for n in _cuts(data):
        path = _write(tmp_path, data[:n], f'cut_{n}_{name}')
        with pytest.raises(ValueError, match=f'cut_{n}_{name}'):
            images.read_image(path, 'RGB')


@pytest.mark.parametrize('where', ['vp8_partition', 'vp8l_stream', 'alph_stream'])
def test_corrupt_webp_raises_naming_the_file(tmp_path, where):
    """Bitstreams cut inside their chunk, the RIFF sizes made to agree:
    the decoders' own end-of-data checks raise."""
    name = {'vp8_partition': 'lossy_512.webp', 'vp8l_stream': 'lossless_512.webp',
            'alph_stream': 'alpha_lossless_gradient.webp'}[where]
    chunks = mk.webp_chunks(open(os.path.join(MORE, name), 'rb').read())
    kind = {'vp8_partition': b'VP8 ', 'vp8l_stream': b'VP8L', 'alph_stream': b'ALPH'}[where]
    chunks = [(k, p[:len(p) // 3] if k == kind else p) for k, p in chunks]
    path = _write(tmp_path, mk.riff(chunks), f'corrupt_{where}.webp')
    with pytest.raises(ValueError, match=f'corrupt_{where}.webp'):
        images.read_image(path, 'L')


def _prefix(value):
    """VP8L's prefix coding of a length or distance value >= 1: (symbol,
    extra bits, their value)."""
    v = value - 1
    if v < 4:
        return v, 0, 0
    hb = v.bit_length() - 1
    sym = 2 * hb + ((v >> (hb - 1)) & 1)
    extra = (sym - 2) >> 1
    return sym, extra, v - ((2 + (sym & 1)) << extra)


def test_vp8l_bitstreams_pillow_cannot_write(tmp_path):
    """A hand-written VP8L stream: simple prefix codes of one and two
    symbols, normal codes with a code-length code, every one of the 120
    short distance codes and long ones, and colour cache entries read
    after backward references."""
    h, w = 24, 31
    rng = np.random.default_rng(5)
    greens = sorted(int(g) for g in rng.choice(256, 4, replace=False))
    bits = []

    def put(v, n):
        bits.extend((int(v) >> k) & 1 for k in range(n))

    def msb(code, n):
        bits.extend((code >> (n - 1 - k)) & 1 for k in range(n))

    cl_order = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)

    def normal_code(lengths, cl_lengths):
        """A normal prefix code; ``cl_lengths``: the code-length code's."""
        put(0, 1)
        ncodes = max(cl_order.index(s) for s in cl_lengths) + 1
        put(ncodes - 4, 4)
        for s in cl_order[:ncodes]:
            put(cl_lengths.get(s, 0), 3)
        put(0, 1)                              # every symbol's length coded
        syms = sorted(cl_lengths, key=lambda s: (cl_lengths[s], s))
        code, prev, codes = 0, None, {}
        for s in syms:                         # canonical codes of the length symbols
            n = cl_lengths[s]
            if prev is not None:
                code = (code + 1) << (n - prev)
            codes[s], prev = (code, n), n
        for v in lengths:
            msb(*codes[v])

    put(0x2F, 8)
    put(w - 1, 14)
    put(h - 1, 14)
    put(0, 1)
    put(0, 3)
    put(0, 1)                                  # no transform
    put(1, 1)
    put(2, 4)                                  # a colour cache of 4 entries
    put(0, 1)                                  # no meta codes
    # green: 4 literals and length prefixes 0 and 1 of 3 bits, the 4
    # cache entries of 4 bits
    short = greens + [256, 257]
    lengths = [0] * (256 + 24 + 4)
    for s in short:
        lengths[s] = 3
    for s in range(280, 284):
        lengths[s] = 4
    normal_code(lengths, {0: 1, 3: 2, 4: 2})
    put(1, 1), put(0, 1), put(1, 1), put(77, 8)                 # red: one 8-bit symbol
    put(1, 1), put(1, 1), put(1, 1), put(9, 8), put(200, 8)     # blue: two symbols
    put(1, 1), put(0, 1), put(0, 1), put(1, 1)                  # alpha: one 1-bit symbol
    normal_code([5] * 32 + [0] * 8, {0: 1, 5: 1})               # distance: 32 of 5 bits

    def green(sym):
        if sym < 280:
            msb(short.index(sym), 3)
        else:
            msb(12 + sym - 280, 4)

    pos, k, total = 0, 0, w * h
    plane_codes = list(range(1, 121)) + [121, 140, 200, 330]
    while pos < total:
        r = rng.random()
        if pos >= 8 * w and k < len(plane_codes) and pos + 2 <= total and r < 0.6:
            green(257)                         # length 2
            sym, extra, val = _prefix(plane_codes[k])
            msb(sym, 5)
            put(val, extra)
            k += 1
            pos += 2
        elif pos >= 1 and r < 0.75:
            green(280 + int(rng.integers(0, 4)))   # a colour cache entry
            pos += 1
        else:
            green(greens[pos % 4])
            bits.append(int(rng.integers(0, 2)))    # blue: 9 or 200
            pos += 1
    assert k == len(plane_codes)
    data = np.packbits(np.asarray(bits, np.uint8), bitorder='little').tobytes()
    path = _write(tmp_path, mk.riff([(b'VP8L', data)]), 'hand.webp')
    assert_reads_as_jax(path)
