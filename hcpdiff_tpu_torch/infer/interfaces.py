"""Output interfaces (counterpart of ``hcpdiff_tpu/infer/interfaces.py``).

``DiskInterface(save_root, image_type='png', quality=95, save_cfg=True)``
writes numbered images and, with ``save_cfg``, a reproduction YAML beside
each, with the JAX package's file names (``{n}-img.png``, ``{n}-img.yaml``)
and counter (the number of files of its type already in the directory),
through the port's writers (the card's machine has no Pillow):

- ``png``: ``utils/images.py:write_png``;
- ``jpg``/``jpeg``: ``utils/jpeg.py:write_jpeg`` at ``quality``, the bytes
  Pillow writes (4:2:0, standard tables);
- ``webp``: one lossless VP8L frame (``utils/images.py:write_webp``); the
  JAX interface writes Pillow's lossy WebP at ``quality`` (ROADMAP.md,
  "Reference behaviours");

any other type raises a ``ValueError`` naming it. The YAML goes through
``config/yaml_lite.py``'s writer.

An interface whose ``need_inter_imgs`` is set makes the Visualizer keep
every denoise step's x0 prediction and decode it: ``on_inter_step`` then
gets each step's (index, count, None, x0 latents, decoded images), on
every interface, before ``on_infer_finish``, as the JAX Visualizer calls
them.

- ``DiskAnimInterface`` also writes each image's x0 previews as an
  animated WebP, ``{n}-steps.webp`` beside its ``{n}-img.{type}``: lossless
  frames (``utils/images.py:write_webp_anim``; the card's machine has no
  Pillow), ``frame_ms`` each. The JAX interface names every image of a
  batch's file ``{last n}-steps.webp``, so only the last image's animation
  is kept, and writes Pillow's lossy frames (ROADMAP.md, "Reference
  behaviours");
- ``WebUIInterface`` prints ``[hcp-progress] i/n t=...`` at each step it
  is shown and ``[hcp-finish] n=...`` after a request, as the JAX one does.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import yaml_lite
from ..utils.images import write_png, write_webp, write_webp_anim
from ..utils.jpeg import write_jpeg

IMAGE_TYPES = ('png', 'jpg', 'jpeg', 'webp')


def _uint8(images) -> np.ndarray:
    arr = np.asarray(images)
    return arr if arr.dtype == np.uint8 else (np.clip(arr, 0, 1) * 255).astype(np.uint8)


class BaseInterface:
    need_inter_imgs = False

    def on_inter_step(self, i: int, num_steps: int, t, latents, images) -> None:
        pass

    def on_infer_finish(self, images, info: Optional[Dict[str, Any]] = None):
        pass


class DiskInterface(BaseInterface):
    def __init__(self, save_root: str = 'output/', image_type: str = 'png', quality: int = 95,
                 save_cfg: bool = True):
        image_type = str(image_type).lower()
        if image_type not in IMAGE_TYPES:
            raise ValueError(f'image_type {image_type!r}: the PyTorch port writes '
                             f'{", ".join(IMAGE_TYPES)}')
        self.save_root = save_root
        self.image_type = image_type
        self.quality = int(quality)
        self.save_cfg = bool(save_cfg)
        os.makedirs(save_root, exist_ok=True)
        self.counter = len([f for f in os.listdir(save_root) if f.endswith(image_type)])

    def _write(self, path: str, img: np.ndarray) -> None:
        if self.image_type == 'png':
            write_png(path, img)
        elif self.image_type == 'webp':
            write_webp(path, img)
        else:
            write_jpeg(path, img, self.quality)

    def on_infer_finish(self, images, info: Optional[Dict[str, Any]] = None) -> List[str]:
        paths = []
        for img in _uint8(images):
            name = f'{self.counter}-img'
            p = os.path.join(self.save_root, f'{name}.{self.image_type}')
            self._write(p, img)
            if self.save_cfg and info is not None:
                yaml_lite.dump(info, os.path.join(self.save_root, f'{name}.yaml'))
            paths.append(p)
            self.counter += 1
        return paths


class DiskAnimInterface(DiskInterface):
    """DiskInterface, and each image's x0 previews as ``{n}-steps.webp``."""
    need_inter_imgs = True

    def __init__(self, save_root: str = 'output/', image_type: str = 'png', quality: int = 95,
                 save_cfg: bool = True, frame_ms: int = 150):
        super().__init__(save_root, image_type, quality, save_cfg)
        self.frame_ms = int(frame_ms)
        self._frames: List[np.ndarray] = []

    def on_inter_step(self, i, num_steps, t, latents, images):
        if images is not None:
            self._frames.append(_uint8(images))

    def on_infer_finish(self, images, info: Optional[Dict[str, Any]] = None) -> List[str]:
        first = self.counter
        paths = super().on_infer_finish(images, info)
        for b in range(len(paths) if self._frames else 0):
            write_webp_anim(os.path.join(self.save_root, f'{first + b}-steps.webp'),
                            [f[b] for f in self._frames], self.frame_ms)
        self._frames = []
        return paths


class WebUIInterface(BaseInterface):
    def on_inter_step(self, i, num_steps, t, latents, images):
        print(f'[hcp-progress] {i}/{num_steps} t={t}', flush=True)

    def on_infer_finish(self, images, info=None):
        print(f'[hcp-finish] n={len(images)}', flush=True)
