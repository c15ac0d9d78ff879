"""JPEG decoding and encoding for the port, which depends on no imaging
package, aiming at what Pillow gives over libjpeg-turbo 3 with its
defaults.

Decoding (``decode_jpeg``/``read_jpeg``, and ``decode_jpeg_mode``, which
also gives Pillow's mode) runs in C++ (``csrc/image_decode.cpp`` through
``utils/native.py``) and takes:

- baseline, extended sequential and progressive JPEG (SOF0, SOF1, SOF2:
  DC first and refinement scans, AC first scans with end-of-band runs, AC
  refinement scans), 8-bit samples, restart intervals, any APPn and COM
  segments;
- the same coded arithmetically (SOF9, SOF10: ``jdarith.c``'s Q-coder,
  the conditioning of a DAC segment or its defaults);
- a progressive file some of whose low coefficient bits never arrive (a
  file cut after its first scans): libjpeg-turbo's block smoothing
  (``jdcoefct.c:decompress_smooth_data``, its 5x5 DC neighbourhood);
- lossless Huffman JPEG (SOF3): predictors 1-7, the point transform,
  restart intervals, 1, 3 or 4 components, taken for grey, RGB or CMYK as
  libjpeg-turbo 3 takes them, subsampled components replicated (libjpeg's
  fancy upsampling wants a DCT size above 1);
- 1, 3 or 4 components and every set of sampling factors libjpeg takes,
  upsampled as ``jdsample.c`` chooses (fancy h2v1/h2v2 where the
  downsampled width is above 2, fancy h1v2, else replication);
- libjpeg's integer "islow" inverse DCT (``jidctint.c``) over the
  coefficients of the whole file, and ``jdapimin.c``'s colour-space guess
  (JFIF means YCbCr; else an Adobe APP14 transform, or the component ids
  'R', 'G', 'B'; four components are CMYK, or YCCK under an Adobe
  transform other than 0) with ``jdcolor.c``'s fixed-point conversions to RGB or CMYK. Pillow
  reads four components as ``CMYK;I`` (inverted), and so does this.

What Pillow does not read either raises ``UnsupportedJPEG`` (a
``ValueError``) naming the file: a precision other than 8 bits (Pillow
refuses it when it opens the file), hierarchical files (SOF5-7, 13-15),
lossless arithmetic-coded files (SOF11) and lossless YCbCr or YCCK
(libjpeg-turbo converts no colours in lossless mode). Corrupt or cut data
raises a ``ValueError`` naming the file.

Encoding (``encode_jpeg``/``write_jpeg``) writes Pillow's bytes for an
8-bit L or RGB image at a quality (the section "encoding" below).
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from . import native

# natural-order index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_MODES = {1: 'L', 3: 'RGB', 4: 'CMYK'}


class UnsupportedJPEG(ValueError):
    pass


def is_jpeg(data: bytes) -> bool:
    return data[:2] == b'\xff\xd8'


def decode_jpeg_mode(data: bytes, path: str = 'JPEG data') -> Tuple[np.ndarray, str]:
    """A JPEG's bytes -> (pixels, mode) as Pillow's ``Image.open`` gives
    them: uint8 [H, W] 'L', [H, W, 3] 'RGB' or [H, W, 4] 'CMYK'."""
    if not is_jpeg(data):
        raise ValueError(f'{path} is not a JPEG file')
    try:
        pixels = native.jpeg_decode(data)
    except native.JPEGError as e:
        if e.unsupported:
            raise UnsupportedJPEG(f'{path}: {e} JPEG files are read neither by Pillow '
                                  '(libjpeg-turbo\'s 8-bit API) nor by the PyTorch port; convert '
                                  'it to a baseline JPEG or a PNG') from None
        raise ValueError(f'{path}: corrupt or cut JPEG data ({e}); the PyTorch port reads PNG, '
                         'JPEG, GIF, BMP, WebP, TIFF and ICO images') from None
    mode = _MODES[pixels.shape[2]]
    if mode == 'CMYK':
        pixels = 255 - pixels
    return (pixels[:, :, 0] if mode == 'L' else pixels), mode


def decode_jpeg(data: bytes, path: str = 'JPEG data') -> np.ndarray:
    """A JPEG's bytes -> uint8 [H, W] (one component), [H, W, 3] (RGB) or
    [H, W, 4] (CMYK), as ``np.asarray(Image.open(...))`` gives them."""
    return decode_jpeg_mode(data, path)[0]


def read_jpeg(path: str) -> np.ndarray:
    with open(path, 'rb') as f:
        return decode_jpeg(f.read(), path)


# jidctint.c's constants (CONST_BITS 13), which the forward DCT shares
_C = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373, c1175=9633, c1501=12299,
          c1847=15137, c1961=16069, c2053=16819, c2562=20995, c3072=25172)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


# ------------------------------------------------------------ encoding ----
# What Pillow writes over libjpeg(-turbo) for an 8-bit L or RGB image with
# ``save(..., quality=q)`` and no other option: baseline sequential
# Huffman, the standard tables of the JPEG specification's annex K (the
# quantisation tables scaled by ``jpeg_quality_scaling``, the Huffman
# tables not optimised), 4:2:0 chroma (h2v2 downsampling), the islow
# forward DCT and a JFIF APP0 segment with no density.

# annex K's quantisation tables in natural order: luminance, chrominance
_STD_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32], np.int64)

# annex K's Huffman tables as DHT payloads (16 counts, then the symbols):
# DC luminance, AC luminance, DC chrominance, AC chrominance
_STD_HUFFMAN = [bytes.fromhex(h) for h in (
    '00010501010101010100000000000000000102030405060708090a0b',
    '0002010303020403050504040000017d01020300041105122131410613516107227114328191a1082342b1c1'
    '1552d1f02433627282090a161718191a25262728292a3435363738393a434445464748494a53545556575859'
    '5a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2'
    'b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8'
    'f9fa',
    '00030101010101010101010000000000000102030405060708090a0b',
    '0002010204040304070504040001027700010203110405213106124151076171132232810814429'
    '1a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a434445464748494a53'
    '5455565758595a636465666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4'
    'a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3'
    'f4f5f6f7f8f9fa')]


def quality_tables(quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_set_quality(quality, force_baseline=TRUE)``: annex
    K's tables scaled by ``jpeg_quality_scaling`` -> int64 [2, 64] in
    natural order, each entry in [1, 255]."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((_STD_QUANT * scale + 50) // 100, 1, 255)


def _huffman_codes(payload: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) of each symbol, int64 [256] each, from a DHT payload
    (canonical codes, as ``jpeg_make_c_derived_tbl`` builds them)."""
    bits, values = payload[:16], payload[16:]
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[values[k]], len_of[values[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_CODES = [_huffman_codes(p) for p in _STD_HUFFMAN]


def _fdct_pass(x: List[np.ndarray], out_shift: int, even0_shift: int) -> List[np.ndarray]:
    """One pass of libjpeg's islow forward DCT (``jfdctint.c``) over 8
    inputs (int64 arrays): outputs 0 and 4 shifted left by ``even0_shift``
    (pass 1) or descaled by ``-even0_shift`` bits (pass 2), the others
    descaled by ``out_shift`` bits, with rounding."""
    c = _C
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    if even0_shift >= 0:
        out0, out4 = (tmp10 + tmp11) << even0_shift, (tmp10 - tmp11) << even0_shift
    else:
        out0, out4 = descale(tmp10 + tmp11, -even0_shift), descale(tmp10 - tmp11, -even0_shift)
    z1 = (tmp12 + tmp13) * c['c0541']
    out2 = descale(z1 + tmp13 * c['c0765'], out_shift)
    out6 = descale(z1 - tmp12 * c['c1847'], out_shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * c['c1175']
    tmp4, tmp5 = tmp4 * c['c0298'], tmp5 * c['c2053']
    tmp6, tmp7 = tmp6 * c['c3072'], tmp7 * c['c1501']
    z1, z2 = z1 * -c['c0899'], z2 * -c['c2562']
    z3, z4 = z3 * -c['c1961'] + z5, z4 * -c['c0390'] + z5
    out7 = descale(tmp4 + z1 + z3, out_shift)
    out5 = descale(tmp5 + z2 + z4, out_shift)
    out3 = descale(tmp6 + z2 + z3, out_shift)
    out1 = descale(tmp7 + z1 + z4, out_shift)
    return [out0, out1, out2, out3, out4, out5, out6, out7]


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """uint8 samples [N, 8, 8] -> libjpeg's islow DCT [N, 8, 8] int64
    (centred on 128, scaled up by 8 as libjpeg leaves it)."""
    x = blocks.astype(np.int64) - 128
    rows = np.stack(_fdct_pass([x[:, :, k] for k in range(8)], 11, 2), axis=2)
    return np.stack(_fdct_pass([rows[:, k, :] for k in range(8)], 15, -2), axis=1)


def _reciprocals(divisors: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """libjpeg-turbo's ``compute_reciprocal`` (16-bit DCTELEM): (reciprocal,
    correction, shift r) of each divisor, so q = ((|x| + c) * fq) >> r."""
    fq, c, r = [], [], []
    for d in divisors.tolist():
        b = d.bit_length() - 1
        rr = 16 + b
        q, f = divmod(1 << rr, d)
        cc = d // 2
        if f == 0:
            q >>= 1
            rr -= 1
        elif f <= d // 2:
            cc += 1
        else:
            q += 1
        fq.append(q)
        c.append(cc)
        r.append(rr)
    return np.asarray(fq, np.int64), np.asarray(c, np.int64), np.asarray(r, np.int64)


def quantize(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """[N, 8, 8] DCT output and a natural-order table -> [N, 64] natural-
    order quantised coefficients, libjpeg-turbo's rounding (its divisors
    are the table times 8)."""
    fq, c, r = _reciprocals(qtable * 8)
    x = coefs.reshape(-1, 64)
    q = ((np.abs(x) + c) * fq) >> r
    return np.where(x < 0, -q, q)


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """libjpeg's ``rgb_ycc_convert`` with its 16-bit fixed-point tables:
    uint8 [..., 3] -> int64 [3, ...] (Y, Cb, Cr)."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    half = 1 << 15
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + (128 << 16) + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + (128 << 16) + half - 1) >> 16
    return np.stack([y, cb, cr])


def _pad(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Edge replication to at least [rows, cols] (libjpeg's
    ``expand_right_edge``/``expand_bottom_edge``)."""
    return np.pad(plane, ((0, max(rows - plane.shape[0], 0)), (0, max(cols - plane.shape[1], 0))),
                  mode='edge')


def downsample_h2v2(plane: np.ndarray, out_cols: int) -> np.ndarray:
    """libjpeg's ``h2v2_downsample``: the image's rows padded to an even
    count, its columns to ``2 * out_cols``, then each 2x2 sum plus the bias
    1, 2, 1, 2, ... along a row, shifted right by 2."""
    p = _pad(plane, plane.shape[0] + plane.shape[0] % 2, 2 * out_cols)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(out_cols) % 2 == 0, 1, 2)
    return (s + bias) >> 2


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[8 * by, 8 * bx] -> [by, bx, 8, 8]."""
    by, bx = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)


def _component_coefs(plane: np.ndarray, bh: int, bw: int, qtable: np.ndarray) -> np.ndarray:
    """A component's quantised blocks [bh, bw, 64] in zigzag order, the
    plane padded by edge replication to [8 * bh, 8 * bw]."""
    blocks = _blocks(_pad(plane, 8 * bh, 8 * bw)[:8 * bh, :8 * bw])
    q = quantize(fdct_islow(blocks.reshape(-1, 8, 8)), qtable)
    return q[:, ZIGZAG].reshape(bh, bw, 64)


def _mcu_order(y: np.ndarray, chroma: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """The 4:2:0 scan's blocks in stream order: each MCU's four luma blocks
    (libjpeg's dummy blocks where the luma has fewer: right of the image,
    zero but the DC of the block before it; below it, zero but the DC of
    the MCU's last block of the row above) and its Cb and Cr blocks ->
    (blocks [N, 64], component of each [N])."""
    my, mx = chroma[0].shape[:2]
    full = np.zeros((2 * my, 2 * mx, 64), np.int64)
    full[:y.shape[0], :y.shape[1]] = y
    if y.shape[1] < 2 * mx:                   # one block short of the last MCU column
        full[:y.shape[0], -1, 0] = full[:y.shape[0], -2, 0]
    if y.shape[0] < 2 * my:                   # one block row short of the last MCU row
        full[-1, :, 0] = np.repeat(full[-2, 1::2, 0], 2)
    luma = full.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    mcus = np.concatenate([luma, chroma[0][:, :, None], chroma[1][:, :, None]], axis=2)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    return mcus.reshape(-1, 64), comp


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (0 for 0), for |v| < 2**16."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    for k in range(16):
        n += a >= (1 << k)
    return n


def entropy_code(blocks: np.ndarray, comp: np.ndarray, tables: List[int]) -> bytes:
    """The scan's Huffman-coded bytes for zigzag blocks [N, 64] in stream
    order, ``comp`` each block's component and ``tables`` each
    component's table pair (0 luminance, 1 chrominance): libjpeg's
    ``encode_one_block`` (DC differences per component, runs of zeros with
    ZRL past 15, EOB after the last nonzero coefficient), the last byte
    filled with ones, 0xFF stuffed with 0x00."""
    n = blocks.shape[0]
    tab = np.asarray(tables, np.int64)[comp]
    # DC: each block's difference from its component's previous block
    dc = blocks[:, 0]
    diff = np.empty(n, np.int64)
    for k in range(len(tables)):
        idx = np.nonzero(comp == k)[0]
        diff[idx] = np.diff(dc[idx], prepend=0)
    size = _bit_length(diff)
    extra = np.where(diff < 0, diff - 1, diff) & ((1 << size) - 1)
    dc_code = np.stack([_CODES[0][0], _CODES[2][0]])[tab, size]
    dc_len = np.stack([_CODES[0][1], _CODES[2][1]])[tab, size]
    keys, vals, lens = [np.arange(n) * 512], [(dc_code << size) | extra], [dc_len + size]
    # AC: every nonzero coefficient with the zeros before it
    ac_codes = np.stack([_CODES[1][0], _CODES[3][0]])
    ac_lens = np.stack([_CODES[1][1], _CODES[3][1]])
    b, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    v = blocks[b, k]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    size = _bit_length(v)
    sym = ((run % 16) << 4) | size
    extra = np.where(v < 0, v - 1, v) & ((1 << size) - 1)
    keys.append(b * 512 + k * 8 + 7)
    vals.append((ac_codes[tab[b], sym] << size) | extra)
    lens.append(ac_lens[tab[b], sym] + size)
    zrl = run // 16                            # 16 zeros each, before the coefficient
    zb, zk = np.repeat(b, zrl), np.repeat(k, zrl)
    zj = np.arange(len(zb)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
    keys.append(zb * 512 + zk * 8 + zj)
    vals.append(ac_codes[tab[zb], 0xF0])
    lens.append(ac_lens[tab[zb], 0xF0])
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 512 + 511)
    vals.append(ac_codes[tab[eob], 0x00])
    lens.append(ac_lens[tab[eob], 0x00])
    order = np.argsort(np.concatenate(keys), kind='stable')
    vals, lens = np.concatenate(vals)[order], np.concatenate(lens)[order]
    # pack the codes' bits, most significant first
    shifts = np.arange(31, -1, -1)
    bits = ((vals[:, None] >> shifts) & 1).astype(np.uint8)
    bits = bits[shifts[None, :] < lens[:, None]]
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    return np.packbits(bits).tobytes().replace(b'\xff', b'\xff\x00')


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack('>BBH', 0xFF, marker, len(payload) + 2) + payload


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """A uint8 image [H, W] / [H, W, 1] (L) or [H, W, 3] (RGB) as the bytes
    of a baseline JPEG, laid out as Pillow writes it with
    ``save(..., quality=quality)``: SOI, JFIF APP0, a DQT a table, SOF0
    (RGB: Y at 2x2, Cb and Cr at 1x1), a DHT a table, one interleaved scan,
    EOI."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f'encode_jpeg takes uint8 images, not {arr.dtype}')
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f'encode_jpeg takes [H, W] or [H, W, 1/3] images, not {arr.shape}')
    h, w = arr.shape[:2]
    if not (1 <= h <= 65535 and 1 <= w <= 65535):
        raise ValueError(f'a JPEG frame has sides 1..65535, not {w}x{h}')
    qt = quality_tables(quality)
    gray = arr.ndim == 2
    out = [b'\xff\xd8', _segment(0xE0, b'JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00')]
    for t in range(1 if gray else 2):
        out.append(_segment(0xDB, bytes([t]) + qt[t][ZIGZAG].astype(np.uint8).tobytes()))
    if gray:
        comps = [(1, 0x11, 0)]
        blocks = _component_coefs(arr.astype(np.int64), -(-h // 8), -(-w // 8), qt[0])
        blocks, comp, tables = blocks.reshape(-1, 64), np.zeros(blocks.shape[0] * blocks.shape[1],
                                                                np.int64), [0]
    else:
        comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
        y, cb, cr = rgb_to_ycc(arr)
        my, mx = -(-h // 16), -(-w // 16)
        luma = _component_coefs(y, -(-h // 8), -(-w // 8), qt[0])
        chroma = [_component_coefs(_pad(downsample_h2v2(c, 8 * mx), 8 * my, 8 * mx), my, mx,
                                   qt[1]) for c in (cb, cr)]
        blocks, comp = _mcu_order(luma, chroma)
        tables = [0, 1, 1]
    out.append(_segment(0xC0, struct.pack('>BHHB', 8, h, w, len(comps))
                        + b''.join(bytes(c) for c in comps)))
    for t in sorted(set(tables)):
        out.append(_segment(0xC4, bytes([t]) + _STD_HUFFMAN[2 * t]))
        out.append(_segment(0xC4, bytes([0x10 | t]) + _STD_HUFFMAN[2 * t + 1]))
    out.append(_segment(0xDA, bytes([len(comps)]) + b''.join(
        bytes([cid, (t << 4) | t]) for (cid, _, _), t in zip(comps, tables)) + b'\x00\x3f\x00'))
    out.append(entropy_code(blocks, comp, tables))
    out.append(b'\xff\xd9')
    return b''.join(out)


def write_jpeg(path: str, image: np.ndarray, quality: int = 95) -> None:
    """Write ``encode_jpeg(image, quality)`` to ``path``."""
    with open(path, 'wb') as f:
        f.write(encode_jpeg(image, quality))


# ---------------------------------------------------- plain version ----

def _plain_dct_round_trip(plane: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """A float plane through the orthonormal 8x8 DCT, quantised by
    ``qtable`` (natural order) with rounding, and back; the edges
    replicated to whole blocks and cut off again."""
    h, w = plane.shape
    p = _pad(plane, -(-h // 8) * 8, -(-w // 8) * 8)
    k = np.arange(8)
    basis = np.where(k == 0, np.sqrt(1 / 8), 0.5)[:, None] * np.cos(
        (2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    blocks = _blocks(p) - 128.0
    q = qtable.reshape(8, 8)
    coefs = np.round(np.einsum('ui,abij,vj->abuv', basis, blocks, basis) / q) * q
    back = np.einsum('ui,abuv,vj->abij', basis, coefs, basis) + 128.0
    return back.transpose(0, 2, 1, 3).reshape(p.shape)[:h, :w]


def _plain_upsample2(plane: np.ndarray, axis: int) -> np.ndarray:
    """Twice as many samples along ``axis``, each 3/4 of its nearer
    source sample and 1/4 of the farther one, the edges replicated."""
    a = np.moveaxis(plane, axis, 0)
    before = np.concatenate([a[:1], a[:-1]])
    after = np.concatenate([a[1:], a[-1:]])
    out = np.empty((2 * a.shape[0],) + a.shape[1:])
    out[0::2] = 0.75 * a + 0.25 * before
    out[1::2] = 0.75 * a + 0.25 * after
    return np.moveaxis(out, 0, axis)


def plain_round_trip(image: np.ndarray, quality: int = 95) -> np.ndarray:
    """What a baseline JPEG of ``image`` at ``quality`` decodes to, in
    float64 and none of the encoder's or decoder's integer paths: JFIF's
    YCbCr, 4:2:0 chroma by 2x2 means, the orthonormal DCT quantised with
    ``quality_tables(quality)``, the triangle-filter chroma upsampling and
    back to RGB, clipped to [0, 255]. ``decode_jpeg(encode_jpeg(image,
    quality))`` differs from it by the integer transforms' rounding only;
    tests/test_torch_port_jpeg_encode.py states the bound and shows that a
    JPEG at another quality or of a shifted image lies well outside it."""
    x = np.asarray(image, np.float64)
    tables = quality_tables(quality)
    if x.ndim == 3 and x.shape[2] == 1:
        x = x[:, :, 0]
    if x.ndim == 2:
        return np.clip(_plain_dct_round_trip(x, tables[0]), 0, 255)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    h, w = y.shape
    chroma = []
    for c in (-0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128):
        c = _pad(c, h + h % 2, w + w % 2)
        c = c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean(axis=(1, 3))
        c = _plain_dct_round_trip(c, tables[1])
        chroma.append(_plain_upsample2(_plain_upsample2(c, 0), 1)[:h, :w] - 128)
    y = _plain_dct_round_trip(y, tables[0])
    cb, cr = chroma
    rgb = np.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb], axis=-1)
    return np.clip(rgb, 0, 255)
