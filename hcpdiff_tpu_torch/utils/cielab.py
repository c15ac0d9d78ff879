"""Pillow's ``convert('RGB')`` of a 'LAB' image, without Pillow or
LittleCMS, bit for bit.

Pillow converts LAB to RGB through LittleCMS (``Image.convert`` builds
``ImageCms.buildTransform(createProfile('LAB'), createProfile('sRGB'),
'LAB', 'RGB')``: perceptual intent, no flags). LittleCMS links the D50
Lab identity profile to its built-in sRGB profile as the pipeline
Lab -> XYZ (D50) -> the inverse of sRGB's colorant matrix (Rec. 709
primaries and D65 white adapted to D50 by Bradford) -> the inverse sRGB
curve, samples it into a 33x33x33 table of 16-bit nodes, each evaluated in
single precision from its 16-bit input, and for 8-bit input interpolates
that table tetrahedrally in fixed point (``PrelinEval8``), the output
reduced to 8 bits by ``FROM_16_TO_8``. ``nodes`` computes the table as
LittleCMS does and ``lab_to_rgb`` interpolates it.

Pillow keeps a LAB pixel's a and b offset by 128 (its unpacker flips their
sign bit); ``lab_to_rgb`` takes the file's bytes, as a TIFF stores them.
Pillow has no LAB to L conversion, so ``convert('L')`` fails.
"""
from __future__ import annotations

import functools

import numpy as np

GRID = 33                                  # _cmsReasonableGridpointsByColorspace for 3 channels
MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0
D50 = (0.9642, 1.0, 0.8249)


def _inverse(a):
    """cmsmtrx.c's _cmsMAT3inverse, term for term."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _matmul(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)]
            for i in range(3)]


def _apply(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def srgb_to_xyz_d50():
    """cmsvirt.c's sRGB colorants (cmswtpnt.c's _cmsBuildRGB2XYZtransferMatrix
    and _cmsAdaptMatrixToD50, Bradford), in double precision."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _apply(_inverse([[xr, xg, xb], [yr, yg, yb],
                            [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    rgb = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
           [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)]]
    bradford = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367], [0.0389, -0.0685, 1.0296]]
    src = _apply(bradford, [xn / yn, 1.0, (1 - xn - yn) / yn])
    dst = _apply(bradford, list(D50))
    cone = [[dst[0] / src[0], 0, 0], [0, dst[1] / src[1], 0], [0, 0, dst[2] / src[2]]]
    return _matmul(_matmul(_inverse(bradford), _matmul(cone, bradford)), rgb)


@functools.lru_cache(maxsize=1)
def nodes() -> np.ndarray:
    """The transform's table, int64 [33, 33, 33, 3] of 16-bit RGB at the
    16-bit Lab inputs round(i * 65535 / 32): each stage in LittleCMS's
    precision (float32 between stages, double within them)."""
    f32, f64 = np.float32, np.float64
    q = np.floor(np.arange(GRID) * 65535.0 / (GRID - 1) + 0.5)
    grid = np.stack(np.meshgrid(q, q, q, indexing='ij'), -1).reshape(-1, 3)
    x = (grid.astype(f32) / f32(65535.0)).astype(f64)
    lab_l, lab_a, lab_b = x[:, 0] * 100.0, x[:, 1] * 255.0 - 128.0, x[:, 2] * 255.0 - 128.0
    fy = (lab_l + 16.0) / 116.0                   # cmspcs.c's cmsLab2XYZ, D50

    def f_1(t):
        return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)

    xyz = [(f_1(fy + 0.002 * lab_a) * D50[0] / MAX_ENCODEABLE_XYZ).astype(f32),
           (f_1(fy) * D50[1] / MAX_ENCODEABLE_XYZ).astype(f32),
           (f_1(fy - 0.005 * lab_b) * D50[2] / MAX_ENCODEABLE_XYZ).astype(f32)]
    inv = [[v * MAX_ENCODEABLE_XYZ for v in row] for row in _inverse(srgb_to_xyz_d50())]
    out = []
    for row in inv:
        lin = (xyz[0].astype(f64) * row[0] + xyz[1].astype(f64) * row[1]
               + xyz[2].astype(f64) * row[2]).astype(f32).astype(f64)
        # the inverse of sRGB's parametric curve (type 4, as type -4)
        g, a, b, c, d = 2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045
        with np.errstate(invalid='ignore'):
            v = np.where(lin >= (a * d + b) ** g, (np.power(np.maximum(lin, 0), 1.0 / g) - b) / a,
                         lin / c)
        w = v.astype(f32).astype(f64) * 65535.0 + 0.5
        out.append(np.where(w <= 0, 0, np.where(w >= 65535.0, 65535, np.floor(w))))
    return np.stack(out, -1).astype(np.int64).reshape(GRID, GRID, GRID, 3)


def _steps():
    """PrelinOpt8alloc's tables for the 8-bit input v (as 16 bits, v * 257):
    the node below and the 16-bit fraction above it."""
    a = np.arange(256, dtype=np.int64) * 257 * (GRID - 1)
    fixed = a + (a + 0x7FFF) // 0xFFFF             # _cmsToFixedDomain
    return fixed >> 16, fixed & 0xFFFF


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] CIELab as a TIFF stores it (L, then a and b signed)
    -> uint8 [..., 3] RGB as Pillow's ``convert('RGB')`` gives it."""
    shape = lab.shape[:-1]
    px = lab.reshape(-1, 3).astype(np.int64) ^ np.array([0, 128, 128])
    table = nodes()
    base, frac = _steps()
    x0, y0, z0 = (base[px[:, k]] for k in range(3))
    rx, ry, rz = (frac[px[:, k]] for k in range(3))
    x1, y1, z1 = (np.where(r == 0, b0, b0 + 1) for r, b0 in ((rx, x0), (ry, y0), (rz, z0)))

    def d(x, y, z):
        return table[x, y, z]

    c0 = d(x0, y0, z0)
    cases = (  # PrelinEval8's six tetrahedra, in its order
        ((rx >= ry) & (ry >= rz), lambda: (d(x1, y0, z0) - c0, d(x1, y1, z0) - d(x1, y0, z0),
                                           d(x1, y1, z1) - d(x1, y1, z0))),
        ((rx >= rz) & (rz >= ry), lambda: (d(x1, y0, z0) - c0, d(x1, y1, z1) - d(x1, y0, z1),
                                           d(x1, y0, z1) - d(x1, y0, z0))),
        ((rz >= rx) & (rx >= ry), lambda: (d(x1, y0, z1) - d(x0, y0, z1),
                                           d(x1, y1, z1) - d(x1, y0, z1), d(x0, y0, z1) - c0)),
        ((ry >= rx) & (rx >= rz), lambda: (d(x1, y1, z0) - d(x0, y1, z0), d(x0, y1, z0) - c0,
                                           d(x1, y1, z1) - d(x1, y1, z0))),
        ((ry >= rz) & (rz >= rx), lambda: (d(x1, y1, z1) - d(x0, y1, z1), d(x0, y1, z0) - c0,
                                           d(x0, y1, z1) - d(x0, y1, z0))),
        ((rz >= ry) & (ry >= rx), lambda: (d(x1, y1, z1) - d(x0, y1, z1),
                                           d(x0, y1, z1) - d(x0, y0, z1), d(x0, y0, z1) - c0)))
    c = [np.zeros_like(c0) for _ in range(3)]
    taken = np.zeros(len(px), bool)
    for cond, terms in cases:
        sel = (cond & ~taken)[:, None]
        for k, t in enumerate(terms()):
            c[k] = np.where(sel, t, c[k])
        taken |= cond
    rest = c[0] * rx[:, None] + c[1] * ry[:, None] + c[2] * rz[:, None] + 0x8001
    out16 = c0 + ((rest + (rest >> 16)) >> 16)
    return ((out16 * 65281 + 8388608) >> 24).astype(np.uint8).reshape(*shape, 3)
