"""The ControlNet condition image at inference (counterpart of
``hcpdiff_tpu/data/processor.py``, which reads images through Pillow):
``ex_input.cond`` of a config, read as an RGB float32 [B, H, W, 3] in
[0, 1]. A path is read by ``utils/images.py`` (``read_image``) and resized
by its copy of Pillow's bicubic, so the card's machine needs no Pillow."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ..utils.images import read_image, resize_bicubic


class ControlNetProcessor:
    """``image``: a path, or an array ([H, W, 3] or [B, H, W, 3], uint8 or
    float; values above 1.5 are read as 0-255), taken as it is."""

    def __init__(self, image: Union[str, np.ndarray], size: Optional[Tuple[int, int]] = None):
        self.image = image
        self.size = size

    def __call__(self, width: int = 512, height: int = 512, batch_size: int = 1) -> np.ndarray:
        """[batch_size, height, width, 3] (a path's image resized to width x
        height; an array's own rows, repeated when it has one)."""
        if isinstance(self.image, str):
            rgb = resize_bicubic(read_image(self.image, 'RGB'), (width, height))
            arr = rgb.astype(np.float32) / 255.0
        else:
            arr = np.asarray(self.image, np.float32)
            if arr.max() > 1.5:
                arr = arr / 255.0
        if arr.ndim == 3:
            arr = arr[None]
        return np.repeat(arr, batch_size, axis=0) if arr.shape[0] == 1 else arr
