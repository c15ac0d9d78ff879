"""Image crop/resize utilities (counterpart of ``hcpdiff_tpu/data/utils.py``).

The JAX package works on PIL images; here an image is a uint8 HWC numpy
array, read by ``utils/images.py`` (PNG only: the port decodes no other
format) and resized by its copy of Pillow's bicubic filter, so crops
equal the JAX package's bit for bit. The crop geometry (and the seeded
random offsets) is the JAX package's, and its crop info is returned for
SDXL crop conditioning.

Not ported: ``resize_crop_fix_native``, the opt-in ``HCP_NATIVE_IMG=1``
path over ``csrc/image_ops.cpp`` (ROADMAP.md queue 1 item 6).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.images import UnsupportedPNG, read_png, resize_bicubic, to_model_input

__all__ = ['crop_geometry', 'resize_crop_fix', 'pad_crop_fix', 'to_model_input',
           'composite_rgba', 'load_rgb', 'load_gray']


def crop_geometry(w0: int, h0: int, size: Tuple[int, int],
                  rng: Optional[np.random.Generator] = None) -> Tuple[int, int, int, int]:
    """(nw, nh, x0, y0): the resize that covers ``size`` = (w, h) and the
    crop's corner, centred or drawn from ``rng`` (x0 first, then y0)."""
    tw, th = size
    scale = max(tw / w0, th / h0)
    nw, nh = round(w0 * scale), round(h0 * scale)
    if rng is not None:
        x0 = int(rng.integers(0, max(nw - tw, 0) + 1))
        y0 = int(rng.integers(0, max(nh - th, 0) + 1))
    else:
        x0, y0 = (nw - tw) // 2, (nh - th) // 2
    return nw, nh, x0, y0


def resize_crop_fix(img: np.ndarray, size: Tuple[int, int],
                    rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, dict]:
    """Resize (bicubic) so the target fits, then centre (or seeded-random)
    crop. size = (w, h). Returns (image, {crop_coord, original_size,
    target_size})."""
    h0, w0 = img.shape[:2]
    tw, th = size
    nw, nh, x0, y0 = crop_geometry(w0, h0, size, rng)
    img = resize_bicubic(img, (nw, nh))[y0:y0 + th, x0:x0 + tw]
    return img, {'crop_coord': (x0, y0), 'original_size': (w0, h0), 'target_size': (tw, th)}


def pad_crop_fix(img: np.ndarray, size: Tuple[int, int]) -> Tuple[np.ndarray, dict]:
    """Resize to fit inside, pad the rest with zeros (no content loss)."""
    h0, w0 = img.shape[:2]
    tw, th = size
    scale = min(tw / w0, th / h0)
    nw, nh = round(w0 * scale), round(h0 * scale)
    img = resize_bicubic(img, (nw, nh))
    canvas = np.zeros((th, tw) + img.shape[2:], np.uint8)
    x0, y0 = (tw - nw) // 2, (th - nh) // 2
    canvas[y0:y0 + nh, x0:x0 + nw] = img
    return canvas, {'crop_coord': (0, 0), 'original_size': (w0, h0), 'target_size': (tw, th),
                    'pad_coord': (x0, y0)}


def composite_rgba(arr: np.ndarray, bg_color: Sequence[int] = (255, 255, 255)) -> np.ndarray:
    """An RGBA uint8 image over an opaque ``bg_color``, as Pillow's
    ``Image.alpha_composite(background, image).convert('RGB')`` computes
    it (7 extra bits of precision, rounded divisions by 255); L and RGB
    images come back as RGB."""
    if arr.ndim == 2:
        return np.repeat(arr[:, :, None], 3, axis=2)
    if arr.shape[2] == 3:
        return arr
    src = arr.astype(np.int64)
    a = src[..., 3:4]
    dst = np.asarray(bg_color, np.int64)[:3]
    outa255 = a * 255 + 255 * (255 - a)
    coef1 = a * 255 * 255 * 128 // np.maximum(outa255, 1)
    coef2 = 255 * 128 - coef1
    tmp = src[..., :3] * coef1 + dst * coef2 + (0x80 << 7)
    out = ((((tmp >> 8) + tmp) >> 8) >> 7)
    out = np.where(a == 0, dst, out)
    return out.astype(np.uint8)


def _read(path: str) -> np.ndarray:
    try:
        return read_png(path)
    except UnsupportedPNG as e:
        raise ValueError(f'{path}: the PyTorch port reads 8-bit L/RGB/RGBA PNG images only '
                         f'({e}); convert the file to such a PNG') from e
    except ValueError as e:
        if 'is not a PNG file' in str(e):
            raise ValueError(f'{path}: the PyTorch port reads PNG images only (JPEG and other '
                             'formats are not decoded; ROADMAP.md queue 1 item 6); '
                             'convert the file to PNG') from e
        raise


def load_rgb(path: str, bg_color: Sequence[int] = (255, 255, 255)) -> np.ndarray:
    """A PNG as uint8 RGB, transparent pixels over ``bg_color`` (the JAX
    package's ``composite_rgba(Image.open(path), bg_color)``)."""
    return composite_rgba(_read(path), bg_color)


def load_gray(path: str) -> np.ndarray:
    """A PNG as uint8 L, as Pillow's ``convert('L')`` gives it (alpha
    dropped)."""
    arr = _read(path)
    if arr.ndim == 2:
        return arr
    rgb = arr[:, :, :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)
