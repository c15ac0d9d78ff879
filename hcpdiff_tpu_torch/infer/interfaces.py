"""Output interfaces (counterpart of ``hcpdiff_tpu/infer/interfaces.py``).

``DiskInterface`` writes numbered images and a reproduction YAML beside
each, with the JAX package's file names (``{n}-img.png``, ``{n}-img.yaml``)
and counter (the number of image files already in the directory), through
``utils/images.py``'s PNG writer and ``config/yaml_lite.py``'s writer. The
animated-steps and WebUI interfaces are not ported yet and raise.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import yaml_lite
from ..utils.images import write_png


class BaseInterface:
    def on_infer_finish(self, images, info: Optional[Dict[str, Any]] = None):
        pass


class DiskInterface(BaseInterface):
    def __init__(self, save_root: str = 'output/', image_type: str = 'png'):
        if image_type != 'png':
            raise NotImplementedError(f'image_type {image_type!r}: the PyTorch port writes PNG '
                                      'only (other formats need Pillow)')
        self.save_root = save_root
        self.image_type = image_type
        os.makedirs(save_root, exist_ok=True)
        self.counter = len([f for f in os.listdir(save_root) if f.endswith(image_type)])

    def on_infer_finish(self, images, info: Optional[Dict[str, Any]] = None) -> List[str]:
        arr = np.asarray(images)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        paths = []
        for img in arr:
            name = f'{self.counter}-img'
            p = os.path.join(self.save_root, f'{name}.{self.image_type}')
            write_png(p, img)
            if info is not None:
                yaml_lite.dump(info, os.path.join(self.save_root, f'{name}.yaml'))
            paths.append(p)
            self.counter += 1
        return paths


class DiskAnimInterface(DiskInterface):
    def __init__(self, *a, **kw):
        raise NotImplementedError('DiskAnimInterface (intermediate-step animation) is not '
                                  'ported yet (ROADMAP.md queue 1 item 5)')


class WebUIInterface(BaseInterface):
    def __init__(self, *a, **kw):
        raise NotImplementedError('WebUIInterface is not ported yet (ROADMAP.md queue 1 item 5)')
