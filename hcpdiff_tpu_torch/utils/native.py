"""ctypes bindings of the port's three native host libraries, built by one
helper:

- ``image_ops`` (counterpart of ``hcpdiff_tpu/utils/native.py``):
  resample (Pillow's bicubic filter with antialias support scaling, in
  float throughout), crop and normalize to [-1, 1] in C++, over
  ``csrc/image_ops.cpp``, the port's copy of the repository's
  ``csrc/image_ops.cpp`` (a test holds the two byte-identical). The data
  path takes it under ``HCP_NATIVE_IMG=1``.
- ``image_decode``: the serial loops of image decoding, over
  ``csrc/image_decode.cpp``: JPEG (sequential, progressive and lossless,
  Huffman or arithmetic coded, as libjpeg-turbo decodes them), GIF's LZW,
  BMP's RLE8/RLE4 and PNG's row filters, TIFF's LZW, PackBits, CCITT fax,
  ThunderScan and ZSTD. Every image the port reads goes
  through it (``utils/images.py:decode_image``).
- ``webp_decode``: WebP's three codings over ``csrc/webp_decode.cpp``: the
  lossy VP8 key frame to RGBA as libwebp converts it, the lossless VP8L
  image, and the ALPH chunk's alpha plane (``utils/webp.py``).

At first use, ``g++`` builds a library with the Makefile's flags into
``hcpdiff_tpu_torch/_build/libhcp_<name>_<hash>.so``, the hash of the
source, the flags and the host's name: ``-march=native`` builds for this
host's CPU, so an edited source, and a checkout copied to another machine,
build anew. The library is written under a temporary name and moved into
place with ``os.replace``, so processes that build at once each load a
whole file. The compiler's output goes to ``_build/<name>_build.log``. Where
the JAX package returns None when no library builds, here a failed build
raises, naming the library and its log; there is no Python fallback.

ctypes releases the GIL for the length of each call, so the trainer's
prefetch thread decodes while a step runs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / 'csrc' / 'image_ops.cpp'
DECODE_SOURCE = PKG_DIR / 'csrc' / 'image_decode.cpp'
WEBP_SOURCE = PKG_DIR / 'csrc' / 'webp_decode.cpp'
BUILD_DIR = PKG_DIR / '_build'
BUILD_LOG = BUILD_DIR / 'image_ops_build.log'
# csrc/Makefile's CXXFLAGS, and its link line's -shared ... -lpthread
CXX_FLAGS = ['-O3', '-march=native', '-ffast-math', '-funroll-loops', '-fPIC', '-std=c++17',
             '-Wall']
VERSION = 1                      # hcp_image_ops_version()
DECODE_VERSION = 3               # hcp_image_decode_version()
WEBP_VERSION = 1                 # hcp_webp_decode_version()

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64


def build(source: Path = SOURCE, name: str = 'image_ops') -> Path:
    """Compile ``source`` into ``_build/libhcp_<name>_<hash>.so`` unless that
    library exists; returns its path. Raises RuntimeError naming the library
    and its build log on failure."""
    key = source.read_bytes() + ' '.join(CXX_FLAGS + [platform.node()]).encode()
    h = hashlib.sha256(key).hexdigest()[:16]
    lib_path = BUILD_DIR / f'libhcp_{name}_{h}.so'
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log_path = BUILD_DIR / f'{name}_build.log'
    cxx = os.environ.get('CXX') or shutil.which('g++') or 'g++'
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / lib_path.name
        cmd = [cxx, *CXX_FLAGS, '-shared', '-o', str(tmp_lib), str(source), '-lpthread']
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            log, ok = f'{" ".join(cmd)}\n(rc {proc.returncode})\n{proc.stdout}{proc.stderr}', \
                proc.returncode == 0
        except (OSError, subprocess.SubprocessError) as e:
            log, ok = f'{" ".join(cmd)}\n{e!r}\n', False
        log_path.write_text(log)
        if not ok:
            raise RuntimeError(f'the native library {name} ({source.name}) did not build; '
                               f'see {log_path}')
        os.replace(tmp_lib, lib_path)     # atomic: other processes see all or nothing
    return lib_path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded image_ops library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    lib.hcp_resize_crop_normalize.argtypes = [_U8P] + [ctypes.c_int] * 8 + [_F32P]
    lib.hcp_resize_crop_normalize.restype = None
    if lib.hcp_image_ops_version() != VERSION:
        raise RuntimeError(f'{SOURCE}: expected hcp_image_ops_version() {VERSION}')
    return lib


@functools.lru_cache(maxsize=None)
def decoder() -> ctypes.CDLL:
    """The loaded image_decode library (built first if needed)."""
    lib = ctypes.CDLL(str(build(DECODE_SOURCE, 'image_decode')))
    err = [ctypes.c_char_p, ctypes.c_int]
    lib.hcp_jpeg_header.argtypes = [_U8P, _I64, _I32P] + err
    lib.hcp_jpeg_decode.argtypes = [_U8P, _I64, _U8P, _I64, _I32P, ctypes.c_int] + err
    lib.hcp_gif_lzw.argtypes = [_U8P, _I64, ctypes.c_int, _U8P, _I64]
    lib.hcp_gif_lzw.restype = _I64
    lib.hcp_bmp_rle.argtypes = [_U8P, _I64, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P]
    lib.hcp_png_unfilter.argtypes = [_U8P, _I64, _I64, ctypes.c_int, _U8P]
    lib.hcp_png_unfilter.restype = _I64
    lib.hcp_tiff_lzw.argtypes = [_U8P, _I64, _U8P, _I64, ctypes.c_char_p, ctypes.c_int]
    lib.hcp_tiff_lzw.restype = _I64
    lib.hcp_packbits.argtypes = [_U8P, _I64, _U8P, _I64]
    lib.hcp_packbits.restype = _I64
    lib.hcp_fax_decode.argtypes = [_U8P, _I64] + [ctypes.c_int] * 4 + [_U8P] + err
    lib.hcp_thunderscan.argtypes = [_U8P, _I64, ctypes.c_int, ctypes.c_int, _U8P]
    lib.hcp_zstd.argtypes = [_U8P, _I64, _U8P, _I64] + err
    lib.hcp_zstd.restype = _I64
    if lib.hcp_image_decode_version() != DECODE_VERSION:
        raise RuntimeError(f'{DECODE_SOURCE}: expected hcp_image_decode_version() '
                           f'{DECODE_VERSION}')
    return lib


@functools.lru_cache(maxsize=None)
def webp_decoder() -> ctypes.CDLL:
    """The loaded webp_decode library (built first if needed)."""
    lib = ctypes.CDLL(str(build(WEBP_SOURCE, 'webp_decode')))
    for fn in (lib.hcp_vp8_decode, lib.hcp_vp8l_decode, lib.hcp_alpha_decode):
        fn.argtypes = [_U8P, _I64, ctypes.c_int, ctypes.c_int, _U8P, _I32P, ctypes.c_char_p,
                       ctypes.c_int]
    if lib.hcp_webp_decode_version() != WEBP_VERSION:
        raise RuntimeError(f'{WEBP_SOURCE}: expected hcp_webp_decode_version() {WEBP_VERSION}')
    return lib


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def _bytes(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if len(data) else np.zeros(1, np.uint8)


class JPEGError(ValueError):
    """A JPEG the decoder refuses: ``unsupported`` for a valid file of a kind
    it does not take, else corrupt data; the message says which."""

    def __init__(self, msg: str, unsupported: bool):
        super().__init__(msg)
        self.unsupported = unsupported


def jpeg_decode(data: bytes, colour: Optional[str] = None):
    """A JPEG's bytes -> uint8 [H, W, C] as libjpeg outputs it: C = 1 grey,
    3 RGB, 4 CMYK. ``colour`` overrides libjpeg's colour-space guess as
    libtiff's JPEG codecs do: 'none' (the components as stored), 'rgb'
    (YCbCr to RGB), 'raw' (a list of each component's samples [dh, dw],
    neither upsampled nor converted). Raises JPEGError."""
    lib = decoder()
    src = _bytes(data)
    info = np.zeros(11, np.int32)
    err = ctypes.create_string_buffer(256)
    rc = lib.hcp_jpeg_header(_u8(src), len(data), info.ctypes.data_as(_I32P), err, 256)
    if rc == 0:
        w, h, c = (int(v) for v in info[:3])
        sizes = [(int(info[4 + 2 * k]), int(info[3 + 2 * k])) for k in range(c)]
        out = np.empty(sum(a * b for a, b in sizes) if colour == 'raw' else h * w * c, np.uint8)
        rc = lib.hcp_jpeg_decode(_u8(src), len(data), _u8(out), out.size,
                                 info.ctypes.data_as(_I32P),
                                 {None: -1, 'none': 0, 'rgb': 1, 'raw': 2}[colour], err, 256)
    if rc:
        raise JPEGError(err.value.decode(errors='replace'), unsupported=rc == 1)
    if colour != 'raw':
        return out.reshape(h, w, c)
    planes, at = [], 0
    for dh, dw in sizes:
        planes.append(out[at:at + dh * dw].reshape(dh, dw))
        at += dh * dw
    return planes


def gif_lzw(data: bytes, min_code_size: int, npix: int) -> np.ndarray:
    """The first ``npix`` indices of a GIF image's LZW data (its sub-blocks
    joined), zeros past where the data ends. Raises ValueError on a code
    that names no entry."""
    out = np.zeros(npix, np.uint8)
    got = decoder().hcp_gif_lzw(_u8(_bytes(data)), len(data), int(min_code_size), _u8(out), npix)
    if got < 0:
        raise ValueError('corrupt GIF LZW data')
    return out


def bmp_rle(file: bytes, start: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """Pillow's BmpRleDecoder on ``file`` from ``start``: uint8 [height,
    width] indices, rows in file order (bottom-up as stored)."""
    out = np.empty((height, width), np.uint8)
    decoder().hcp_bmp_rle(_u8(_bytes(file)), len(file), int(start), int(width), int(height),
                          int(rle4), _u8(out))
    return out


def png_unfilter(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """PNG rows (a filter byte, then ``rowbytes``) unfiltered -> uint8
    [height, rowbytes]. Raises ValueError on an unknown filter type."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size < height * (rowbytes + 1):
        raise ValueError(f'{raw.size} bytes of PNG pixel data for {height} rows of {rowbytes}')
    out = np.empty((height, rowbytes), np.uint8)
    bad = decoder().hcp_png_unfilter(_u8(raw), height, rowbytes, max(int(bpp), 1), _u8(out))
    if bad:
        raise ValueError(f'PNG filter type {raw[(bad - 1) * (rowbytes + 1)]} does not exist')
    return out


def _webp_call(fn, data: bytes, width: int, height: int, channels: int,
               info: Optional[list] = None) -> np.ndarray:
    out = np.empty((height, width, channels) if channels > 1 else (height, width), np.uint8)
    got = np.zeros(6, np.int32)
    err = ctypes.create_string_buffer(256)
    if fn(_u8(_bytes(data)), len(data), int(width), int(height), _u8(out),
          got.ctypes.data_as(_I32P), err, 256):
        raise ValueError(err.value.decode(errors='replace'))
    if info is not None:
        info[:] = got.tolist()
    return out


def vp8_decode(data: bytes, width: int, height: int, info: Optional[list] = None) -> np.ndarray:
    """A VP8 key frame (a 'VP8 ' chunk's payload) -> uint8 RGBA [height,
    width, 4] as libwebp outputs it, alpha 255. Raises ValueError. ``info``,
    a list, receives what the frame used (``csrc/webp_decode.cpp``)."""
    return _webp_call(webp_decoder().hcp_vp8_decode, data, width, height, 4, info)


def vp8l_decode(data: bytes, width: int, height: int, info: Optional[list] = None) -> np.ndarray:
    """A VP8L bitstream (a 'VP8L' chunk's payload) -> uint8 RGBA [height,
    width, 4]. Raises ValueError."""
    return _webp_call(webp_decoder().hcp_vp8l_decode, data, width, height, 4, info)


def alpha_decode(data: bytes, width: int, height: int, info: Optional[list] = None) -> np.ndarray:
    """An 'ALPH' chunk's payload -> uint8 alpha [height, width]. Raises
    ValueError."""
    return _webp_call(webp_decoder().hcp_alpha_decode, data, width, height, 1, info)


def tiff_lzw(data: bytes, size: int) -> np.ndarray:
    """A TIFF LZW strip or tile (the code width grows one code early; or
    old-style, LSB first, as libtiff tells it) -> its first ``size``
    bytes, zeros where the data ends early. Raises ValueError on a code
    that names no entry."""
    out = np.zeros(size, np.uint8)
    err = ctypes.create_string_buffer(256)
    got = decoder().hcp_tiff_lzw(_u8(_bytes(data)), len(data), _u8(out), size, err, 256)
    if got < 0:
        raise ValueError(err.value.decode(errors='replace'))
    return out


def packbits(data: bytes, size: int) -> np.ndarray:
    """A PackBits strip or tile -> its first ``size`` bytes, zeros where
    the data ends early."""
    out = np.zeros(size, np.uint8)
    decoder().hcp_packbits(_u8(_bytes(data)), len(data), _u8(out), size)
    return out


def fax(data: bytes, compression: int, width: int, rows: int, options: int = 0) -> np.ndarray:
    """A CCITT strip or tile (compression 2, 3, 4 or 32771; ``options``
    its T4Options or T6Options) -> ``rows`` rows of ``(width + 7) // 8``
    bytes, the second colour's runs as 1 bits. Raises ValueError on
    corrupt or cut data."""
    out = np.zeros(rows * ((width + 7) // 8), np.uint8)
    err = ctypes.create_string_buffer(256)
    if decoder().hcp_fax_decode(_u8(_bytes(data)), len(data), int(compression), int(options),
                                int(width), int(rows), _u8(out), err, 256):
        raise ValueError(f'corrupt CCITT data ({err.value.decode(errors="replace")})')
    return out


def thunderscan(data: bytes, width: int, rows: int) -> np.ndarray:
    """A ThunderScan strip or tile -> ``rows`` rows of ``(width + 1) // 2``
    bytes of 4-bit pixels. Raises ValueError where a row decodes to a wrong
    count of pixels, as libtiff does."""
    out = np.zeros(rows * ((width + 1) // 2), np.uint8)
    if decoder().hcp_thunderscan(_u8(_bytes(data)), len(data), int(width), int(rows), _u8(out)):
        raise ValueError('corrupt ThunderScan data (a row of the wrong length)')
    return out


def zstd(data: bytes, size: int) -> np.ndarray:
    """ZSTD frames -> their first ``size`` bytes (fewer where the data
    holds fewer). Raises ValueError on corrupt or cut data."""
    out = np.zeros(size, np.uint8)
    err = ctypes.create_string_buffer(256)
    got = decoder().hcp_zstd(_u8(_bytes(data)), len(data), _u8(out), size, err, 256)
    if got < 0:
        raise ValueError(f'corrupt ZSTD data ({err.value.decode(errors="replace")})')
    return out[:got]


def resize_crop_normalize(img: np.ndarray, resize_wh: Tuple[int, int],
                          crop_xy: Tuple[int, int], target_wh: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [th, tw, 3] in [-1, 1]: resized to
    ``resize_wh`` = (w, h), cropped at ``crop_xy`` = (x, y) to ``target_wh``."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'the native route takes uint8 [H, W, 3] images, got {img.shape}')
    (dw, dh), (cx, cy), (tw, th) = resize_wh, crop_xy, target_wh
    out = np.empty((th, tw, 3), np.float32)
    library().hcp_resize_crop_normalize(img.ctypes.data_as(_U8P), img.shape[0], img.shape[1],
                                        dh, dw, cy, cx, th, tw, out.ctypes.data_as(_F32P))
    return out
