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


# ------------------------------------------- arithmetic and lossless JPEG

def aritab():
    """Table D.2 of ITU-T T.81 as libjpeg packs it (jaricom.c's
    jpeg_aritab), read from the decoder's source."""
    src = open(os.path.join(os.path.dirname(os.path.dirname(DATA)), 'hcpdiff_tpu_torch', 'csrc',
                            'image_decode.cpp')).read()
    body = src[src.index('kAritab[114] = {') + 16:]
    return [int(v, 16) for v in body[:body.index('}')].replace('\n', ' ').split(',')]


class ArithEncoder:
    """jcarith.c's Q-coder: ``encode(stats, index, bit)`` codes one binary
    decision in the bin ``stats[index]``; ``finish()`` terminates the
    code and returns the byte-stuffed data."""

    def __init__(self):
        self.tab = aritab()
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_pending(self, byte):
        if self.zc:
            self.out += b'\0' * self.zc
            self.zc = 0
        self._emit(byte)

    def encode(self, st, i, val):
        sv = st[i]
        qe = self.tab[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_pending(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._release()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def _release(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._flush_pending(self.buffer)
        if self.sc:
            if self.zc:
                self.out += b'\0' * self.zc
                self.zc = 0
            self.out += b'\xff\0' * self.sc
            self.sc = 0

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_pending(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._release()
        if self.c & 0x7FFF800:
            if self.zc:
                self.out += b'\0' * self.zc
                self.zc = 0
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _arith_value(enc, st, at, v, fixed, high):
    """Figures F.6-F.9 for a nonzero value ``v`` (AC: sign in the fixed
    bin, bins from ``at``; ``high`` the X2 bin)."""
    enc.encode(fixed, 0, 0 if v > 0 else 1)
    v = abs(v) - 1
    m = 0
    if v:
        enc.encode(st, at, 1)
        m, v2 = 1, v >> 1
        if v2:
            enc.encode(st, at, 1)
            m <<= 1
            at = high
            v2 >>= 1
            while v2:
                enc.encode(st, at, 1)
                m <<= 1
                at += 1
                v2 >>= 1
    enc.encode(st, at, 0)
    at += 14
    m >>= 1
    while m:
        enc.encode(st, at, 1 if m & v else 0)
        m >>= 1


class _ArithScan:
    """One scan's statistics and DC state (jcarith.c's start_pass)."""

    def __init__(self, ncomp, dac):
        self.enc = ArithEncoder()
        self.dc = [[0] * 64 for _ in range(16)]
        self.ac = [[0] * 256 for _ in range(16)]
        self.fixed = [113]
        self.last = [0] * ncomp
        self.ctx = [0] * ncomp
        self.dac = dac

    def dc_diff(self, ci, tbl, m):
        """Figure F.4 and F.1.4.4.1.2 for DC value ``m`` of scan component ``ci``."""
        st, enc, s0 = self.dc[tbl], self.enc, self.ctx[ci]
        v = m - self.last[ci]
        if v == 0:
            enc.encode(st, s0, 0)
            self.ctx[ci] = 0
            return
        self.last[ci] = m
        enc.encode(st, s0, 1)
        if v > 0:
            enc.encode(st, s0 + 1, 0)
            at, self.ctx[ci] = s0 + 2, 4
        else:
            v = -v
            enc.encode(st, s0 + 1, 1)
            at, self.ctx[ci] = s0 + 3, 8
        m = 0
        v -= 1
        if v:
            enc.encode(st, at, 1)
            m, v2, at = 1, v >> 1, 20
            while v2:
                enc.encode(st, at, 1)
                m <<= 1
                at += 1
                v2 >>= 1
        enc.encode(st, at, 0)
        lo, hi = self.dac.get(tbl, (0, 1))
        if m < (1 << lo) >> 1:
            self.ctx[ci] = 0
        elif m > (1 << hi) >> 1:
            self.ctx[ci] += 8
        at += 14
        m >>= 1
        while m:
            enc.encode(st, at, 1 if m & v else 0)
            m >>= 1

    def ac_first(self, tbl, coefs, ss, se, al, kx):
        """Figure F.5 (G.1.3.2 with ``al``) over zigzag ``coefs``."""
        st, enc = self.ac[tbl], self.enc
        vals = [(abs(int(c)) >> al) * (1 if c >= 0 else -1) for c in coefs]
        ke = se
        while ke >= ss and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            at = 3 * (k - 1)
            enc.encode(st, at, 0)
            while vals[k] == 0:
                enc.encode(st, at + 1, 0)
                at += 3
                k += 1
            enc.encode(st, at + 1, 1)
            _arith_value(enc, st, at + 2, vals[k], self.fixed, 189 if k <= kx else 217)
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl, coefs, ss, se, ah, al):
        """Figure G.10 over zigzag ``coefs``."""
        st, enc = self.ac[tbl], self.enc
        shifted = [abs(int(c)) >> al for c in coefs]
        ke = se
        while ke > 0 and shifted[ke] == 0:
            ke -= 1
        kex = ke
        while kex > 0 and abs(int(coefs[kex])) >> ah == 0:
            kex -= 1
        k = ss
        while k <= ke:
            at = 3 * (k - 1)
            if k > kex:
                enc.encode(st, at, 0)
            while True:
                v = shifted[k]
                if v:
                    if v >> 1:
                        enc.encode(st, at + 2, v & 1)
                    else:
                        enc.encode(st, at + 1, 1)
                        enc.encode(self.fixed, 0, 0 if coefs[k] >= 0 else 1)
                    break
                enc.encode(st, at + 1, 0)
                at += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)


# libjpeg's jpeg_simple_progression for three components and for one
SIMPLE_PROGRESSION = {
    3: [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
        ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
        ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)],
    1: [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
        ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]}


def jpeg_arith(planes, factors, quality=75, script=None, restart=0, dac=None, kx=5):
    """An arithmetic-coded JPEG (jcarith.c) of 8-bit planes [C, H, W] with
    sampling factors [(h, v)]: sequential (SOF9) with one interleaved scan,
    or progressive (SOF10) by ``script`` [(components, Ss, Se, Ah, Al)];
    ``restart`` MCUs an interval; ``dac`` {table: (L, U)} and ``kx`` the
    conditioning written in a DAC segment (else the defaults 0, 1, 5)."""
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
    dac = dac or {}
    out = [b'\xff\xd8', _segment(0xE0, b'JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00')]
    for t in sorted(set(tables)):
        out.append(_segment(0xDB, bytes([t]) + qt[t][jpeg.ZIGZAG].astype(np.uint8).tobytes()))
    out.append(_segment(0xCA if script else 0xC9, struct.pack('>BHHB', 8, height, width, nc)
                        + b''.join(bytes([k + 1, (h << 4) | v, tables[k]])
                                   for k, (h, v) in enumerate(factors))))
    if dac or kx != 5:
        out.append(_segment(0xCC, b''.join(bytes([t, (u << 4) | lo]) for t, (lo, u) in
                                           sorted(dac.items()))
                            + b''.join(bytes([16 + t, kx]) for t in sorted(set(tables)))))
    if restart:
        out.append(_segment(0xDD, struct.pack('>H', restart)))
    for comps, ss, se, ah, al in (script or [(tuple(range(nc)), 0, 63, 0, 0)]):
        out.append(_segment(0xDA, bytes([len(comps)]) + b''.join(
            bytes([k + 1, (tables[k] << 4) | tables[k]]) for k in comps) + bytes([ss, se, ah << 4 | al])))
        sc = _ArithScan(len(comps), dac)
        # the scan's units: the MCUs of an interleaved scan, else the blocks
        # that cover the component
        if len(comps) > 1:
            units = [[(ci, k, my * factors[k][1] + y, mx * factors[k][0] + x)
                      for ci, k in enumerate(comps) for y in range(factors[k][1])
                      for x in range(factors[k][0])] for my in range(mcuy) for mx in range(mcux)]
        else:
            k = comps[0]
            h, v = factors[k]
            bw = -(-(-(-width * h // hmax)) // 8)
            bh = -(-(-(-height * v // vmax)) // 8)
            units = [[(0, k, by, bx)] for by in range(bh) for bx in range(bw)]
        data, rst = bytearray(), 0
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                data += sc.enc.finish() + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) % 8
                sc = _ArithScan(len(comps), dac)
            for ci, k, by, bx in unit:
                blk = coefs[k][by, bx]
                tbl = tables[k]
                if not script:
                    sc.dc_diff(ci, tbl, int(blk[0]))
                    sc.ac_first(tbl, blk, 1, 63, 0, kx)
                elif ss == 0 and ah == 0:
                    sc.dc_diff(ci, tbl, int(blk[0]) >> al)
                elif ss == 0:
                    sc.enc.encode(sc.fixed, 0, (int(blk[0]) >> al) & 1)
                elif ah == 0:
                    sc.ac_first(tbl, blk, ss, se, al, kx)
                else:
                    sc.ac_refine(tbl, blk, ss, se, ah, al)
        out.append(bytes(data) + sc.enc.finish())
    out.append(b'\xff\xd9')
    return b''.join(out)


def _lossless_predict(x, psv, pt, restart_rows):
    """jclossls.c's differences of one component's samples [H, W] (after
    the point transform): the first row of each restart interval from
    1 << (7 - pt) and the left sample, the first column from the sample
    above, the rest by predictor ``psv``."""
    x = x.astype(np.int64) >> pt
    h, w = x.shape
    pred = np.zeros_like(x)
    for y in range(h):
        if y == 0 or (restart_rows and y % restart_rows == 0):
            pred[y, 0] = 1 << (7 - pt)
            pred[y, 1:] = x[y, :-1]
            continue
        ra, rb, rc = x[y, :-1], x[y - 1, 1:], x[y - 1, :-1]
        pred[y, 0] = x[y - 1, 0]
        pred[y, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                       6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]
    return x - pred


def jpeg_lossless(planes, psv, pt=0, restart_rows=0, ids=None, jfif=False, factors=None):
    """A lossless Huffman JPEG (SOF3) of 8-bit planes [C, H, W], one
    interleaved scan with predictor ``psv`` and point transform ``pt``;
    a DC table of 5-bit codes for the 17 difference categories; component
    ids ``ids`` (default 1, 2, ...), a JFIF segment where ``jfif``;
    ``factors`` [(h, v)] subsample the components (means of their cells,
    each MCU h x v samples of each)."""
    nc, height, width = planes.shape
    ids = ids or list(range(1, nc + 1))
    if factors:
        return _lossless_sampled(planes, psv, pt, ids, factors)
    diffs = np.stack([_lossless_predict(planes[k], psv, pt, restart_rows) for k in range(nc)], -1)
    out = [b'\xff\xd8']
    if jfif:
        out.append(_segment(0xE0, b'JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00'))
    out.append(_segment(0xC3, struct.pack('>BHHB', 8, height, width, nc)
                        + b''.join(bytes([i, 0x11, 0]) for i in ids)))
    bits = [0] * 16
    bits[4] = 17
    out.append(_segment(0xC4, bytes([0]) + bytes(bits) + bytes(range(17))))
    if restart_rows:
        out.append(_segment(0xDD, struct.pack('>H', restart_rows * width)))
    out.append(_segment(0xDA, bytes([nc]) + b''.join(bytes([i, 0]) for i in ids)
                        + bytes([psv, 0, pt])))
    rows = [diffs] if not restart_rows else [diffs[y:y + restart_rows]
                                             for y in range(0, height, restart_rows)]
    for r, part in enumerate(rows):
        acc = []
        for d in part.reshape(-1).tolist():
            a = abs(d)
            n = a.bit_length()
            acc.append(format(n, '05b'))
            if n:
                acc.append(format(d if d > 0 else d - 1 + (1 << n), f'0{n}b'))
        bitstr = ''.join(acc)
        bitstr += '1' * (-len(bitstr) % 8)
        data = int(bitstr, 2).to_bytes(len(bitstr) // 8, 'big') if bitstr else b''
        out.append(data.replace(b'\xff', b'\xff\x00'))
        if r + 1 < len(rows):
            out.append(bytes([0xFF, 0xD0 + r % 8]))
    out.append(b'\xff\xd9')
    return b''.join(out)


def _lossless_sampled(planes, psv, pt, ids, factors):
    """jpeg_lossless with sampling factors: no restarts, no JFIF."""
    nc, height, width = planes.shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    units = []
    for k, (h, v) in enumerate(factors):
        dw, dh = -(-width * h // hmax), -(-height * v // vmax)
        plane = _downsample(planes[k].astype(np.int64), vmax // v, hmax // h, dh, dw)
        d = _lossless_predict(plane.astype(np.uint8), psv, pt, 0)
        units.append(np.pad(d, ((0, mcuy * v - dh), (0, mcux * h - dw))))
    order = []
    for my in range(mcuy):
        for mx in range(mcux):
            for k, (h, v) in enumerate(factors):
                order += units[k][my * v:(my + 1) * v, mx * h:(mx + 1) * h].reshape(-1).tolist()
    out = [b'\xff\xd8', _segment(0xC3, struct.pack('>BHHB', 8, height, width, nc) + b''.join(
        bytes([i, (h << 4) | v, 0]) for i, (h, v) in zip(ids, factors)))]
    bits = [0] * 16
    bits[4] = 17
    out.append(_segment(0xC4, bytes([0]) + bytes(bits) + bytes(range(17))))
    out.append(_segment(0xDA, bytes([nc]) + b''.join(bytes([i, 0]) for i in ids)
                        + bytes([psv, 0, pt])))
    acc = []
    for d in order:
        n = abs(d).bit_length()
        acc.append(format(n, '05b'))
        if n:
            acc.append(format(d if d > 0 else d - 1 + (1 << n), f'0{n}b'))
    bitstr = ''.join(acc)
    bitstr += '1' * (-len(bitstr) % 8)
    out.append(int(bitstr, 2).to_bytes(len(bitstr) // 8, 'big').replace(b'\xff', b'\xff\x00'))
    out.append(b'\xff\xd9')
    return b''.join(out)


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

def lzw_encode(data, old_style=False):
    """TIFF LZW (MSB first from 9 bits, the width growing a code early, a
    clear code when the table fills), as libtiff writes it; ``old_style``:
    LSB first, the width growing a code later, as early TIFF writers
    did."""
    out, acc, nacc = bytearray(), 0, 0
    late = 1 if old_style else 0

    def put(code, nbits):
        nonlocal acc, nacc
        if old_style:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
            return
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
        elif nxt > (1 << nbits) - 1 + late:
            nbits += 1
        w = bytes([c])
    if w:
        put(table[w], nbits)
        nxt += 1
        if nxt > (1 << nbits) - 1 + late:
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


def _pack12(flat):
    """[h, n] samples below 4096 -> [h, ceil(1.5 n)] bytes, MSB first."""
    h, n = flat.shape
    v = np.pad(flat.astype(np.uint16), ((0, 0), (0, n % 2))).reshape(h, -1, 2)
    out = np.stack([v[..., 0] >> 4, ((v[..., 0] & 15) << 4) | (v[..., 1] >> 8), v[..., 1] & 255],
                   -1).astype(np.uint8).reshape(h, -1)
    return out[:, :(3 * n + 1) // 2]


def zstd_compress(data, level=19):
    """ZSTD frames of ``data`` from the zstd library Pillow bundles."""
    import ctypes
    import glob
    import PIL
    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), '..', 'pillow.libs',
                                             'libzstd*'))[0])
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                                  ctypes.c_size_t, ctypes.c_int]
    cap = lib.ZSTD_compressBound(len(data))
    buf = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(buf, cap, data, len(data), level)
    return buf.raw[:n]


def thunder_encode(rows4):
    """ThunderScan codes of 4-bit rows [h, w]: runs of the last pixel (never
    up to a row's end, where libtiff writes nothing), 2-bit and 3-bit delta
    codes, raw pixels."""
    out = bytearray()
    two = {0: 0, 1: 1, -1: 3}
    for row in rows4.tolist():
        last, i, w = 0, 0, len(row)
        while i < w:
            run = 0
            while i + run < w - 1 and run < 63 and row[i + run] == last:
                run += 1
            if run >= 2:
                out.append(run)
                i += run
                continue
            d = [row[i + k] - (row[i + k - 1] if k else last) for k in range(min(3, w - i))]
            if len(d) == 3 and all(x in two for x in d):
                out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | two[d[2]])
                last, i = row[i + 2], i + 3
            elif len(d) >= 2 and all(-3 <= x <= 3 for x in d[:2]):
                out.append(0x80 | (d[0] & 7) << 3 | (d[1] & 7))
                last, i = row[i + 1], i + 2
            else:
                out.append(0xC0 | row[i])
                last, i = row[i], i + 1
    return bytes(out)


def _ycbcr_units(block, sub):
    """Y, Cb, Cr samples [rows, w, 3] -> TIFF's packed units (sub_h x sub_v
    Y samples, then the block's Cb and Cr, means of the block's edge-padded
    samples)."""
    sh, sv = sub
    rows, w, _ = block.shape
    p = np.pad(block.astype(np.int64), ((0, -rows % sv), (0, -w % sh), (0, 0)), mode='edge')
    uy, ux = p.shape[0] // sv, p.shape[1] // sh
    y = p[:, :, 0].reshape(uy, sv, ux, sh).transpose(0, 2, 1, 3).reshape(uy, ux, sh * sv)
    c = (p[:, :, 1:].reshape(uy, sv, ux, sh, 2).mean(axis=(1, 3)) + 0.5).astype(np.int64)
    return np.concatenate([y, c], -1).astype(np.uint8).reshape(uy, -1)


def tiff_bytes(samples, bits, photometric, order='<', compression=1, predictor=1, planar=1,
               rows_per_strip=None, tile=None, extra=(), colormap=None, fillorder=1,
               sample_format=None, orientation=None, big=False, ycbcr=None, tags=None,
               jpeg=None, old_lzw=False):
    """A one-page TIFF of samples [h, w, spp] (values below 2**bits; 32-bit
    floats as their uint32 bits) with the given layout; every chunk
    compressed as ``compression`` says (1 none, 5 LZW, 8 Deflate, 32773
    PackBits, 34925 LZMA, 50000 ZSTD, 32809 ThunderScan, 7 JPEG: ``jpeg``
    {'quality', 'subsampling', 'tables'} encoded by Pillow, its tables
    moved into JPEGTables where 'tables'), after the horizontal
    ``predictor`` (2) or the floating-point one (3) where set. ``big``
    writes BigTIFF; ``ycbcr`` (h, v) packs Y, Cb, Cr samples into
    subsampled units; ``tags`` {tag: (type, values)} adds entries;
    ``old_lzw`` writes LZW's old LSB-first codes."""
    h, w, spp = samples.shape
    planes = [samples[:, :, k:k + 1] for k in range(spp)] if planar == 2 else [samples]
    chunks = []
    jpeg_tables = None

    def encode(block, per):
        nonlocal jpeg_tables
        if compression == 7:
            import io
            buf = io.BytesIO()
            im = Image.fromarray(block.reshape(block.shape[0], -1, per).squeeze(-1) if per == 1
                                 else block.reshape(block.shape[0], -1, per),
                                 {1: 'L', 3: 'RGB', 4: 'CMYK'}[per])
            opts = dict(jpeg or {})
            tables = opts.pop('tables', False)
            im.save(buf, 'JPEG', **opts)
            raw = buf.getvalue()
            if tables:                    # DQT and DHT into JPEGTables, the rest stays
                segs, keep, p = [], [raw[:2]], 2
                while raw[p + 1] != 0xDA:
                    n = struct.unpack('>H', raw[p + 2:p + 4])[0]
                    (segs if raw[p + 1] in (0xDB, 0xC4) else keep).append(raw[p:p + 2 + n])
                    p += 2 + n
                jpeg_tables = b'\xff\xd8' + b''.join(segs) + b'\xff\xd9'
                raw = b''.join(keep) + raw[p:]
            return raw
        if ycbcr:
            raw = _ycbcr_units(block.reshape(block.shape[0], -1, 3), ycbcr).tobytes()
        else:
            if predictor == 2:            # each sample less the one a pixel to its left
                block = block.astype(np.int64)
                block[:, per:] = block[:, per:] - block[:, :-per]
                block = block & ((1 << bits) - 1)
            if predictor == 3:            # libtiff's fpDiff: byte planes, then differences
                b = block.astype('<u4').view(np.uint8).reshape(block.shape[0], -1, 4)
                planes_ = b[:, :, ::-1].transpose(0, 2, 1).reshape(block.shape[0], -1)
                d = planes_.astype(np.int64)
                d[:, per:] = d[:, per:] - d[:, :-per]
                raw = (d & 255).astype(np.uint8).tobytes()
            elif bits in (16, 32):
                raw = block.astype(order + ('u2' if bits == 16 else 'u4')).tobytes()
            elif bits == 12:
                raw = _pack12(block.reshape(block.shape[0], -1)).tobytes()
            else:
                raw = _pack_samples(block.reshape(block.shape[0], -1, 1), bits).tobytes() \
                    if bits < 8 else block.astype(np.uint8).tobytes()
        if compression == 5:
            raw = lzw_encode(raw, old_lzw)
        elif compression in (8, 32946):
            raw = zlib.compress(raw, 9)
        elif compression == 32773:
            raw = packbits_encode(raw)
        elif compression == 34925:
            import lzma
            raw = lzma.compress(raw)
        elif compression == 50000:
            raw = zstd_compress(raw)
        elif compression == 32809:
            raw = thunder_encode(block.reshape(block.shape[0], -1))
        return _reverse_bits(raw) if fillorder == 2 else raw

    for plane in planes:
        per = plane.shape[2]
        if tile is None:
            rps = rows_per_strip or h
            for y in range(0, h, rps):
                rows = plane[y:y + rps]
                chunks.append(encode(rows.reshape(-1, w * per) if bits >= 8 and not ycbcr
                                     and compression != 7 else rows, per))
        else:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, per), samples.dtype)
                    part = plane[ty:ty + th, tx:tx + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(t.reshape(th, tw * per) if bits >= 8 and not ycbcr
                                         and compression != 7 else t, per))
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
    if ycbcr:
        entries[530] = (3, list(ycbcr))
    if jpeg_tables:
        entries[347] = (7, list(jpeg_tables))
    entries.update(tags or {})
    body = bytearray()
    offsets = []
    start = 16 if big else 8
    for c in chunks:
        offsets.append(start + len(body))
        body += c + (b'\0' if len(c) % 2 else b'')
    off_type = 16 if big else 4
    if tile is None:
        entries[273] = (off_type, offsets)
        entries[278] = (4, [rows_per_strip or h])
        entries[279] = (off_type, [len(c) for c in chunks])
    else:
        entries[322], entries[323] = (3, [tile[0]]), (3, [tile[1]])
        entries[324] = (off_type, offsets)
        entries[325] = (off_type, [len(c) for c in chunks])
    ifd_at = start + len(body)
    n = len(entries)
    count_fmt, entry_fmt, entry_size, inline = ('Q', 'HHQ', 20, 8) if big else ('H', 'HHI', 12, 4)
    extra_at = ifd_at + struct.calcsize(order + count_fmt) + entry_size * n + inline
    ifd, tail = struct.pack(order + count_fmt, n), bytearray()
    type_fmt = {1: 'B', 2: 'B', 3: 'H', 4: 'I', 5: 'I', 7: 'B', 11: 'f', 16: 'Q', 17: 'q'}
    for tag in sorted(entries):
        typ, vals = entries[tag]
        packed = struct.pack(order + type_fmt[typ] * len(vals), *vals)
        count = len(vals) // 2 if typ == 5 else len(vals)
        if len(packed) <= inline:
            ifd += struct.pack(order + entry_fmt, tag, typ, count) + packed.ljust(inline, b'\0')
        else:
            ifd += struct.pack(order + entry_fmt, tag, typ, count) + struct.pack(
                order + ('Q' if big else 'I'), extra_at + len(tail))
            tail += packed + (b'\0' if len(packed) % 2 else b'')
    if big:
        head = (b'II+\0' if order == '<' else b'MM\0+') + struct.pack(order + 'HHQ', 8, 0, ifd_at)
    else:
        head = (b'II*\0' if order == '<' else b'MM\0*') + struct.pack(order + 'I', ifd_at)
    return head + bytes(body) + ifd + b'\0' * inline + bytes(tail)


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


def scan_starts(data):
    """The positions of a JPEG's SOS markers."""
    out, p = [], 2
    while p + 4 <= len(data):
        if data[p] != 0xFF or data[p + 1] in (0x00, 0xFF):
            p += 1
            continue
        m = data[p + 1]
        if m in (0xD8, 0xD9) or 0xD0 <= m <= 0xD7:
            p += 2
            continue
        n = struct.unpack('>H', data[p + 2:p + 4])[0]
        if m == 0xDA:
            out.append(p)
        p += 2 + n
    return out


def cut_progressive(data, scans):
    """A progressive JPEG cut after its first ``scans`` scans, EOI appended:
    libjpeg smooths the blocks whose low coefficients never arrive."""
    return data[:scan_starts(data)[scans]] + b'\xff\xd9'


def ojpeg_tiff(stream, width, height, interchange=True):
    """An old-style JPEG TIFF (compression 6, YCbCr, II) whose one strip is
    a whole JPEG stream, JPEGInterchangeFormat (513) and its length (514)
    pointing to it where ``interchange``."""
    entries = [(256, 4, width), (257, 4, height), (258, 3, 8), (259, 3, 6), (262, 3, 6),
               (273, 4, None), (277, 3, 3), (278, 4, height), (279, 4, len(stream))]
    if interchange:
        entries += [(513, 4, None), (514, 4, len(stream))]
    at = 8 + 2 + 12 * len(entries) + 4
    ifd = struct.pack('<H', len(entries)) + b''.join(
        struct.pack('<HHII', tag, typ, 1, at if v is None else v) if typ == 4 else
        struct.pack('<HHIHH', tag, typ, 1, v, 0) for tag, typ, v in entries)
    return b'II*\0' + struct.pack('<I', 8) + ifd + b'\0\0\0\0' + stream


RARE = os.path.join(DATA, 'torch_port_rare')


def write_rare():
    """The rarer JPEG and TIFF kinds in ../torch_port_rare: progressive
    JPEGs cut after their first scans (smoothed), arithmetic-coded and
    lossless JPEG, BigTIFF, JPEG-in-TIFF, LZMA, ZSTD, YCbCr, float, signed,
    32-bit and 12-bit samples, CIELab, CCITT group 3 (2-D), group 4 and
    RLEW, ThunderScan and old-style JPEG; 512 px where the kind fits in
    about 30 KB, else at the sizes above."""
    import io
    sh, sw = SMALL
    small = photo(sh, sw, 3, seed=31)
    big = photo(512, 512, 3, seed=32, cell=48, noise=0.0)
    files = {}

    def pillow(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    prog = pillow(Image.fromarray(photo(*SIZE, 3, seed=33)), 'JPEG', quality=85, progressive=True)
    files['prog_cut3_420.jpg'] = cut_progressive(prog, 3)
    files['prog_cut1_grey.jpg'] = cut_progressive(pillow(Image.fromarray(small[:, :, 0]), 'JPEG',
                                                         quality=90, progressive=True), 1)
    ycc = ycc_planes(big)
    files['arith_420_512.jpg'] = jpeg_arith(ycc, [(2, 2), (1, 1), (1, 1)], quality=60,
                                            restart=32, dac={0: (1, 4), 1: (0, 2)}, kx=3)
    files['arith_prog_444.jpg'] = jpeg_arith(ycc_planes(small), [(1, 1)] * 3, quality=85,
                                             script=SIMPLE_PROGRESSION[3])
    files['arith_prog_cut.jpg'] = jpeg_arith(ycc_planes(small), [(2, 1), (1, 1), (1, 1)],
                                             quality=80, script=SIMPLE_PROGRESSION[3][:2])
    files['lossless_rgb_p7.jpg'] = jpeg_lossless(small.transpose(2, 0, 1), 7, ids=[82, 71, 66])
    files['lossless_grey_p4_pt1.jpg'] = jpeg_lossless(small[None, :, :, 0], 4, pt=1,
                                                      restart_rows=9)
    poster = (photo(512, 512, 3, seed=35, cell=96, noise=0.0) >> 6) << 6  # lossless stays small
    files['bigtiff_lzw_tiles_512.tif'] = tiff_bytes(poster, 8, 2, compression=5, predictor=2,
                                                    big=True, tile=(128, 128))
    files['jpeg_ycbcr_tiles_512.tif'] = tiff_bytes(
        photo(500, 500, 3, seed=34, cell=48, noise=0.0), 8, 6, compression=7, tile=(96, 96),
        jpeg=dict(quality=70, subsampling=2, tables=True), tags={530: (3, [2, 2])})
    files['jpeg_grey_strips.tif'] = tiff_bytes(small[:, :, :1], 8, 1, compression=7,
                                               rows_per_strip=16, jpeg=dict(quality=80))
    files['lzma_rgb.tif'] = tiff_bytes(small, 8, 2, compression=34925, rows_per_strip=16)
    files['zstd_predictor_512.tif'] = tiff_bytes(poster, 8, 2, compression=50000, predictor=2,
                                                 rows_per_strip=64)
    files['ycbcr22_lzw.tif'] = tiff_bytes(
        ycc_planes(small).transpose(1, 2, 0), 8, 6, compression=5, ycbcr=(2, 2),
        rows_per_strip=8, tags={532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])})
    files['ycbcr21_deflate_mm.tif'] = tiff_bytes(ycc_planes(small).transpose(1, 2, 0), 8, 6,
                                                 compression=8, ycbcr=(2, 1), order='>')
    grey = small[:, :, :1].astype(np.float32)
    files['float_pred3.tif'] = tiff_bytes((grey / 3 - 20).view(np.uint32), 32, 1, compression=8,
                                          predictor=3, sample_format=3, rows_per_strip=16)
    files['int16_signed_mm.tif'] = tiff_bytes(
        (grey.astype(np.int64) * 250 - 30000).astype(np.int16).view(np.uint16), 16, 1,
        order='>', sample_format=2)
    files['int32_zstd.tif'] = tiff_bytes(
        (grey.astype(np.int64) * 3 - 100).astype(np.int32).view(np.uint32), 32, 1,
        compression=50000, sample_format=2)
    files['grey12.tif'] = tiff_bytes(grey.astype(np.uint16) * 16 + 9, 12, 1, compression=5)
    bilevel = Image.fromarray(big[:, :, 0] > 128)
    files['g3_2d_fill2_512.tif'] = pillow(bilevel, 'TIFF', compression='group3',
                                          tiffinfo={292: 5, 266: 2})
    files['g4_512.tif'] = pillow(bilevel, 'TIFF', compression='group4')
    for seed in range(40, 80):            # one libtiff reads back whole (see rlew_bytes)
        bits = photo(sh, sw, 1, seed=seed)[:, :, 0] > 110
        files['rlew.tif'] = pillow(Image.fromarray(bits), 'TIFF', compression='tiff_raw_16')
        with Image.open(io.BytesIO(files['rlew.tif'])) as im:
            if np.array_equal(np.asarray(im), bits):
                break
    files['thunderscan.tif'] = tiff_bytes(small[:, :, :1] >> 4, 4, 1, compression=32809,
                                          rows_per_strip=16)
    files['ojpeg_420.tif'] = ojpeg_tiff(pillow(Image.fromarray(small), 'JPEG', quality=85), sw,
                                        sh)
    files['cielab_lzw.tif'] = pillow(Image.fromarray(small).convert('LAB'), 'TIFF',
                                     compression='tiff_lzw')
    os.makedirs(RARE, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(RARE, name), 'wb') as f:
            f.write(data)
    with open(os.path.join(RARE, 'captions.json'), 'w') as f:
        json.dump({os.path.splitext(n)[0]: f'a photo of cat {n}' for n in sorted(files)}, f,
                  indent=0)


def digest(arr):
    arr = np.ascontiguousarray(arr, np.uint8)
    return [hashlib.sha256(arr.tobytes()).hexdigest(), list(arr.shape)]


def image_files():
    """Paths relative to tests/data of every image here, in torch_port_jpeg,
    torch_port_webp_tiff_ico and torch_port_rare."""
    out = []
    for folder in ('torch_port_formats', 'torch_port_jpeg', 'torch_port_webp_tiff_ico',
                   'torch_port_rare'):
        out += [f'{folder}/{n}' for n in sorted(os.listdir(os.path.join(DATA, folder)))
                if os.path.splitext(n)[1] in ('.jpg', '.png', '.gif', '.bmp', '.webp', '.tif',
                                              '.tiff', '.ico')]
    return out


def expected():
    """{path: {'rgb': [sha256, shape], 'l': [sha256, shape] or None where
    Pillow's convert('L') fails}} by the JAX package's Pillow calls."""
    import warnings
    from hcpdiff_tpu.data.utils import composite_rgba
    warnings.filterwarnings('ignore', 'Palette images with Transparency')
    out = {}
    for rel in image_files():
        with Image.open(os.path.join(DATA, rel)) as im:
            rgb = np.asarray(composite_rgba(im))
        with Image.open(os.path.join(DATA, rel)) as im:
            try:                            # Pillow converts no CIELab image to L
                grey = digest(np.asarray(im.convert('L')))
            except ValueError:
                grey = None
        out[rel] = {'rgb': digest(rgb), 'l': grey}
    return out


if __name__ == '__main__':
    write_all()
    write_more()
    write_rare()
    with open(os.path.join(HERE, 'expected.json'), 'w') as f:
        json.dump(expected(), f, indent=1, sort_keys=True)
