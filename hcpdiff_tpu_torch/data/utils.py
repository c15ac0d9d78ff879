"""Image crop/resize utilities (counterpart of ``hcpdiff_tpu/data/utils.py``).

The JAX package works on PIL images; here an image is a uint8 HWC numpy
array, read by ``utils/images.py:decode_image`` (PNG of every type,
baseline and progressive JPEG, GIF and BMP, as Pillow's ``Image.open``
gives them; WebP other than the port's own, TIFF and ICO raise, naming the
file) and resized by its copy of Pillow's bicubic filter, so crops equal
the JAX package's bit for bit. The crop geometry (and the seeded
random offsets) is the JAX package's, and its crop info is returned for
SDXL crop conditioning.

``HCP_NATIVE_IMG=1`` takes the JAX package's opt-in native route
(``resize_crop_fix_native``: resample, crop and normalize in C++,
``utils/native.py`` over ``csrc/image_ops.cpp``) for RGB images, with the
same crop geometry and seeded draws, so crop info is identical on both
routes; the resampling stays in float between its two passes, where
Pillow's filter rounds to uint8, so the arrays differ by a fraction of a
level (the JAX package measured Pillow faster, so it is not the default).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.images import read_decoded, resize_bicubic, to_l, to_model_input, to_rgb, to_rgba

__all__ = ['crop_geometry', 'resize_crop_fix', 'resize_crop_fix_native', 'native_route',
           'pad_crop_fix', 'to_model_input', 'composite_rgba', 'load_rgb', 'load_gray']


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


def native_route(img: np.ndarray) -> bool:
    """Whether ``img`` takes ``resize_crop_fix_native``: ``HCP_NATIVE_IMG=1``
    and an RGB image (others take the plain path, as in the JAX package)."""
    return (os.environ.get('HCP_NATIVE_IMG') == '1' and img.ndim == 3 and img.shape[2] == 3)


def resize_crop_fix_native(img: np.ndarray, size: Tuple[int, int],
                           rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, dict]:
    """``resize_crop_fix`` then ``to_model_input`` in one pass of the native
    library: uint8 RGB [H, W, 3] -> float32 [h, w, 3] in [-1, 1], and the
    same crop info (the geometry and draws are ``crop_geometry``'s). Raises
    where the library does not build."""
    from ..utils import native
    h0, w0 = img.shape[:2]
    tw, th = size
    nw, nh, x0, y0 = crop_geometry(w0, h0, size, rng)
    arr = native.resize_crop_normalize(img, (nw, nh), (x0, y0), (tw, th))
    return arr, {'crop_coord': (x0, y0), 'original_size': (w0, h0), 'target_size': (tw, th)}


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


def load_rgb(path: str, bg_color: Optional[Sequence[int]] = (255, 255, 255)) -> np.ndarray:
    """An image as uint8 RGB: the JAX package's ``composite_rgba(Image.open(path),
    bg_color)``, which composites over ``bg_color`` the modes RGBA, LA and P
    only (so an RGB PNG with ``tRNS`` keeps its pixels, and a palette PNG or
    a GIF is composited) and converts the rest; with ``bg_color`` None,
    Pillow's ``convert('RGB')``, which drops the alpha."""
    img = read_decoded(path)
    if bg_color is not None and img.mode in ('RGBA', 'LA', 'P'):
        return composite_rgba(to_rgba(img), bg_color)
    return to_rgb(img)


def load_gray(path: str) -> np.ndarray:
    """An image as uint8 L, as Pillow's ``convert('L')`` gives it (alpha
    dropped)."""
    return to_l(read_decoded(path))
