"""Baseline JPEG decoding in numpy and the stdlib (the port depends on no
imaging package), aiming at what Pillow gives over libjpeg(-turbo) with
its defaults:

- baseline or extended sequential Huffman JPEG (SOF0, SOF1), 8-bit
  samples, 1 or 3 components, interleaved or one scan a component,
  restart intervals, any APPn and COM segments;
- sampling 4:4:4, 4:2:2 and 4:2:0 (the chroma at half the luma's width,
  or width and height);
- libjpeg's integer "islow" inverse DCT (``jidctint.c``: 13-bit
  constants, 2 extra bits between the passes, its range-limit table),
  its "fancy" triangle-filter chroma upsampling (``jdsample.c``
  ``h2v1_fancy_upsample``/``h2v2_fancy_upsample``, edges replicated, plain
  replication where the chroma is at most 2 samples wide) and its
  fixed-point YCbCr to RGB tables (``jdcolor.c``, 16 fraction bits).

Progressive, arithmetic-coded, lossless, hierarchical and 12-bit files,
4-component (CMYK) files and other samplings raise ``UnsupportedJPEG``
(a ``ValueError``) naming ROADMAP.md queue 1 item 6.

Huffman decoding runs in Python over a 16-bit lookup table a code table,
one block at a time; dequantization, the IDCT, upsampling and colour
conversion are numpy over the whole image.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

ROADMAP = 'ROADMAP.md queue 1 item 6'

# natural-order index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
_ZZ = ZIGZAG.tolist()

_UNSUPPORTED_SOF = {0xC2: 'progressive', 0xC3: 'lossless', 0xC5: 'hierarchical',
                    0xC6: 'hierarchical', 0xC7: 'hierarchical', 0xC9: 'arithmetic-coded',
                    0xCA: 'arithmetic-coded', 0xCB: 'arithmetic-coded', 0xCD: 'arithmetic-coded',
                    0xCE: 'arithmetic-coded', 0xCF: 'arithmetic-coded'}


class UnsupportedJPEG(ValueError):
    pass


def is_jpeg(data: bytes) -> bool:
    return data[:2] == b'\xff\xd8'


def _unsupported(path: str, what: str) -> UnsupportedJPEG:
    return UnsupportedJPEG(f'{path}: {what} JPEG files are not decoded by the PyTorch port '
                           f'({ROADMAP}); convert it to a baseline JPEG or a PNG')


def _huffman_lookup(bits: List[int], values: List[int]) -> List[int]:
    """{16-bit window: code length << 8 | symbol} as a list; 0 where no
    code starts."""
    table = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            shift = 16 - length
            table[code << shift:(code + 1) << shift] = length << 8 | values[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _windows(segment: bytes) -> List[int]:
    """32-bit big-endian windows at every byte of ``segment`` (zeros past
    its end, as libjpeg reads past a marker)."""
    b = np.frombuffer(segment + b'\0' * 8, np.uint8).astype(np.uint32)
    return ((b[:-7] << 24) | (b[1:-6] << 16) | (b[2:-5] << 8) | b[3:-4]).tolist()


def _segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from ``pos`` split at its restart markers,
    byte stuffing removed, and the position of the marker that ends it."""
    segments, start = [], pos
    while True:
        i = data.find(b'\xff', pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError('JPEG data ends inside a scan')
        nxt = data[i + 1]
        if nxt == 0:
            pos = i + 2
        elif 0xD0 <= nxt <= 0xD7:
            segments.append(data[start:i].replace(b'\xff\x00', b'\xff'))
            start = pos = i + 2
        elif nxt == 0xFF:
            pos = i + 1
        else:
            segments.append(data[start:i].replace(b'\xff\x00', b'\xff'))
            return segments, i


def _decode_scan(segments: List[bytes], units: List[List[tuple]], restart: int,
                 coefs: Dict[int, List[int]], path: str) -> None:
    """Huffman-decode the scan's units (an MCU: [(component id, block
    index, DC table, AC table)]) into ``coefs`` (natural order, 64 per
    block), restarting the DC predictions and the bit position every
    ``restart`` units."""
    per = restart or len(units)
    zz = _ZZ
    for n, segment in enumerate(segments):
        batch = units[n * per:(n + 1) * per]
        if not batch:
            break
        w = _windows(segment)
        p = 0
        pred: Dict[int, int] = {}
        for unit in batch:
            for cid, block, dc_tab, ac_tab in unit:
                out = coefs[cid]
                base = block * 64
                look = dc_tab[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not look:
                    raise ValueError(f'{path}: corrupt JPEG data (bad Huffman code)')
                p += look >> 8
                s = look & 0xFF
                v = 0
                if s:
                    v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                v += pred.get(cid, 0)
                pred[cid] = v
                out[base] = v
                k = 1
                while k < 64:
                    look = ac_tab[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not look:
                        raise ValueError(f'{path}: corrupt JPEG data (bad Huffman code)')
                    p += look >> 8
                    rs = look & 0xFF
                    s = rs & 15
                    if not s:
                        if rs != 0xF0:
                            break
                        k += 16
                        continue
                    k += rs >> 4
                    v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    if k > 63:
                        raise ValueError(f'{path}: corrupt JPEG data (coefficient past 63)')
                    out[base + zz[k]] = v
                    k += 1
            if p > len(segment) * 8 + 32:
                raise ValueError(f'{path}: corrupt JPEG data (scan ends early)')


# jidctint.c's constants (CONST_BITS 13)
_C = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373, c1175=9633, c1501=12299,
          c1847=15137, c1961=16069, c2053=16819, c2562=20995, c3072=25172)


def _idct_pass(x: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of libjpeg's islow IDCT over 8 inputs (int64 arrays),
    descaled by ``shift`` bits with rounding."""
    c = _C
    z1 = (x[2] + x[6]) * c['c0541']
    tmp2 = z1 - x[6] * c['c1847']
    tmp3 = z1 + x[2] * c['c0765']
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * c['c1175']
    t0, t1, t2, t3 = t0 * c['c0298'], t1 * c['c2053'], t2 * c['c3072'], t3 * c['c1501']
    z1, z2 = z1 * -c['c0899'], z2 * -c['c2562']
    z3, z4 = z3 * -c['c1961'] + z5, z4 * -c['c0390'] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    r = 1 << (shift - 1)
    return [(tmp10 + t3 + r) >> shift, (tmp11 + t2 + r) >> shift, (tmp12 + t1 + r) >> shift,
            (tmp13 + t0 + r) >> shift, (tmp13 - t0 + r) >> shift, (tmp12 - t1 + r) >> shift,
            (tmp11 - t2 + r) >> shift, (tmp10 - t3 + r) >> shift]


def _range_limit() -> np.ndarray:
    """libjpeg's post-IDCT table, indexed by the value & 1023: the value
    plus 128 clamped to [0, 255] for |value| < 512."""
    x = np.arange(1024)
    return np.select([x < 128, x < 512, x < 896], [x + 128, 255, 0], x - 896).astype(np.uint8)


_RANGE = _range_limit()


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """[N, 64] natural-order coefficients and their table -> [N, 8, 8]
    uint8 samples."""
    c = (coefs.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    ws = np.stack(_idct_pass([c[:, k, :] for k in range(8)], 11), axis=1)     # columns
    out = np.stack(_idct_pass([ws[:, :, k] for k in range(8)], 18), axis=2)   # rows
    return _RANGE[out & 1023]


def _h2v1(a: np.ndarray) -> np.ndarray:
    """libjpeg's h2v1 fancy upsampling (edges replicated)."""
    p = np.pad(a, ((0, 0), (1, 1)), mode='edge')
    out = np.empty((a.shape[0], 2 * a.shape[1]), np.int32)
    out[:, 0::2] = (3 * a + p[:, :-2] + 1) >> 2
    out[:, 1::2] = (3 * a + p[:, 2:] + 2) >> 2
    return out


def _h2v2(a: np.ndarray) -> np.ndarray:
    """libjpeg's h2v2 fancy upsampling: the nearer row thrice and the
    other once, then the same across with rounding 8 and 7 (edges
    replicated)."""
    pr = np.pad(a, ((1, 1), (0, 0)), mode='edge')
    cols = np.empty((2 * a.shape[0], a.shape[1]), np.int32)
    cols[0::2] = 3 * a + pr[:-2]
    cols[1::2] = 3 * a + pr[2:]
    pc = np.pad(cols, ((0, 0), (1, 1)), mode='edge')
    out = np.empty((cols.shape[0], 2 * a.shape[1]), np.int32)
    out[:, 0::2] = (3 * cols + pc[:, :-2] + 8) >> 4
    out[:, 1::2] = (3 * cols + pc[:, 2:] + 7) >> 4
    return out


def _upsample(a: np.ndarray, fx: int, fy: int, path: str) -> np.ndarray:
    if (fx, fy) == (1, 1):
        return a
    if (fx, fy) == (2, 1):
        return _h2v1(a) if a.shape[1] > 2 else np.repeat(a, 2, axis=1)
    if (fx, fy) == (2, 2):
        return _h2v2(a) if a.shape[1] > 2 else np.repeat(np.repeat(a, 2, axis=0), 2, axis=1)
    raise _unsupported(path, f'{fx}x{fy} chroma-subsampled')


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's ``ycc_rgb_convert`` with its tables, [H, W] each ->
    uint8 [H, W, 3]."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + 32768) >> 16
    cb_b = (_fix(1.77200) * x + 32768) >> 16
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + 32768
    y = y.astype(np.int64)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, path: str = 'JPEG data') -> np.ndarray:
    """A baseline JPEG's bytes -> uint8 [H, W] (one component) or [H, W,
    3] (RGB). Corrupt or cut data raises a ``ValueError``."""
    if not is_jpeg(data):
        raise ValueError(f'{path} is not a JPEG file')
    try:
        return _decode(data, path)
    except (IndexError, KeyError, struct.error) as e:
        raise ValueError(f'{path}: corrupt or cut JPEG data ({type(e).__name__}: {e})') from e


def _decode(data: bytes, path: str) -> np.ndarray:
    qtables: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, List[int]] = {}
    ac_tabs: Dict[int, List[int]] = {}
    comps: List[dict] = []
    coefs: Dict[int, List[int]] = {}
    restart, jfif, adobe = 0, False, None
    height = width = 0
    pos = 2
    while True:
        i = data.find(b'\xff', pos)
        if i < 0 or i + 1 >= len(data):
            break                                 # no EOI: decode what is there
        pos = i + 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7 or marker == 0:
            continue
        (length,) = struct.unpack('>H', data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if marker in _UNSUPPORTED_SOF:
            raise _unsupported(path, _UNSUPPORTED_SOF[marker])
        if marker in (0xC0, 0xC1):
            precision, height, width, n = struct.unpack('>BHHB', seg[:6])
            if precision != 8:
                raise _unsupported(path, f'{precision}-bit')
            if n not in (1, 3):
                raise _unsupported(path, f'{n}-component')
            if height == 0:
                raise _unsupported(path, 'DNL-sized')
            comps = [dict(id=seg[6 + 3 * k], h=seg[7 + 3 * k] >> 4, v=seg[7 + 3 * k] & 15,
                          tq=seg[8 + 3 * k]) for k in range(n)]
            hmax, vmax = max(c['h'] for c in comps), max(c['v'] for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c['bw'], c['bh'] = mcux * c['h'], mcuy * c['v']
                c['w'] = -(-width * c['h'] // hmax)
                c['hgt'] = -(-height * c['v'] // vmax)
                coefs[c['id']] = [0] * (c['bw'] * c['bh'] * 64)
        elif marker == 0xDB:
            k = 0
            while k < len(seg):
                pq, tq = seg[k] >> 4, seg[k] & 15
                size = 128 if pq else 64
                vals = (np.frombuffer(seg[k + 1:k + 1 + size], '>u2') if pq
                        else np.frombuffer(seg[k + 1:k + 65], np.uint8))
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qtables[tq] = table
                k += 1 + size
        elif marker == 0xC4:
            k = 0
            while k < len(seg):
                tc, th = seg[k] >> 4, seg[k] & 15
                bits = list(seg[k + 1:k + 17])
                values = list(seg[k + 17:k + 17 + sum(bits)])
                (ac_tabs if tc else dc_tabs)[th] = _huffman_lookup(bits, values)
                k += 17 + sum(bits)
        elif marker == 0xDD:
            (restart,) = struct.unpack('>H', seg[:2])
        elif marker == 0xE0 and seg[:5] == b'JFIF\0':
            jfif = True
        elif marker == 0xEE and seg[:5] == b'Adobe' and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:
            if not comps:
                raise ValueError(f'{path}: scan before the frame header')
            ns = seg[0]
            sel = [(seg[1 + 2 * k], seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15) for k in range(ns)]
            by_id = {c['id']: c for c in comps}
            tabs = [(by_id[cid], dc_tabs[td], ac_tabs[ta]) for cid, td, ta in sel]
            if ns == 1:           # one component: its own blocks, one an MCU
                c, dt, at = tabs[0]
                bw, bh = -(-c['w'] // 8), -(-c['hgt'] // 8)
                units = [[(c['id'], r * c['bw'] + x, dt, at)] for r in range(bh) for x in range(bw)]
            else:
                mcux = comps[0]['bw'] // comps[0]['h']
                mcuy = comps[0]['bh'] // comps[0]['v']
                units = [[(c['id'], (my * c['v'] + v) * c['bw'] + mx * c['h'] + h, dt, at)
                          for c, dt, at in tabs for v in range(c['v']) for h in range(c['h'])]
                         for my in range(mcuy) for mx in range(mcux)]
            segments, pos = _segments(data, pos)
            _decode_scan(segments, units, restart, coefs, path)
    if not comps:
        raise ValueError(f'{path}: no frame header')
    hmax, vmax = max(c['h'] for c in comps), max(c['v'] for c in comps)
    planes = []
    for c in comps:
        blocks = idct_islow(np.asarray(coefs[c['id']], np.int64).reshape(-1, 64),
                            qtables[c['tq']])
        plane = blocks.reshape(c['bh'], c['bw'], 8, 8).transpose(0, 2, 1, 3).reshape(
            c['bh'] * 8, c['bw'] * 8)[:c['hgt'], :c['w']].astype(np.int32)
        plane = _upsample(plane, hmax // c['h'], vmax // c['v'], path)
        planes.append(plane[:height, :width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    ids = [c['id'] for c in comps]
    rgb = (adobe == 0) if not jfif and adobe is not None else (
        not jfif and ids == [ord('R'), ord('G'), ord('B')])
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, 'rb') as f:
        return decode_jpeg(f.read(), path)
