"""ctypes binding of the native image preprocessing library (counterpart
of ``hcpdiff_tpu/utils/native.py``): resample (Pillow's bicubic filter
with antialias support scaling, in float throughout), crop and normalize
to [-1, 1] in C++, over ``csrc/image_ops.cpp``, the port's copy of the
repository's ``csrc/image_ops.cpp`` (a test holds the two byte-identical).

At first use, ``g++`` builds it with the Makefile's flags into
``hcpdiff_tpu_torch/_build/libhcp_image_ops_<hash>.so``, the hash of the
source, the flags and the host's name: ``-march=native`` builds for this
host's CPU, so an edited source, and a checkout copied to another machine,
build anew. The compiler's output goes to ``_build/image_ops_build.log``. Where the JAX package
returns None when no library builds, here :func:`library` raises, naming
the log: the route is asked for only under ``HCP_NATIVE_IMG=1``.
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
from typing import Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / 'csrc' / 'image_ops.cpp'
BUILD_DIR = PKG_DIR / '_build'
BUILD_LOG = BUILD_DIR / 'image_ops_build.log'
# csrc/Makefile's CXXFLAGS, and its link line's -shared ... -lpthread
CXX_FLAGS = ['-O3', '-march=native', '-ffast-math', '-funroll-loops', '-fPIC', '-std=c++17',
             '-Wall']
VERSION = 1                      # hcp_image_ops_version()

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` into ``_build/`` unless that library exists;
    returns its path. Raises RuntimeError naming the build log on failure."""
    key = source.read_bytes() + ' '.join(CXX_FLAGS + [platform.node()]).encode()
    h = hashlib.sha256(key).hexdigest()[:16]
    lib_path = BUILD_DIR / f'libhcp_image_ops_{h}.so'
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
        BUILD_LOG.write_text(log)
        if not ok:
            raise RuntimeError(f'the native image library did not build (HCP_NATIVE_IMG=1); '
                               f'see {BUILD_LOG}')
        os.replace(tmp_lib, lib_path)     # atomic: other processes see all or nothing
    return lib_path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    lib.hcp_resize_crop_normalize.argtypes = [_U8P] + [ctypes.c_int] * 8 + [_F32P]
    lib.hcp_resize_crop_normalize.restype = None
    if lib.hcp_image_ops_version() != VERSION:
        raise RuntimeError(f'{SOURCE}: expected hcp_image_ops_version() {VERSION}')
    return lib


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
