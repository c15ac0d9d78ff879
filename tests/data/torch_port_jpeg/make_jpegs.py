"""Writes this folder's JPEGs with Pillow from seeded arrays, committed so
that a host without Pillow can train on them: bicubic-enlarged random
cells with a little noise, at chip_smoke.py's trainer sizes 512x512 and
640x448, 4:2:0, 4:4:4 and 4:2:2 with restart markers.

    python tests/data/torch_port_jpeg/make_jpegs.py
"""
import json
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
SPECS = [((512, 512), dict(quality=90, subsampling=2)), ((448, 640), dict(quality=90, subsampling=2)),
         ((512, 512), dict(quality=85, subsampling=0)),
         ((448, 640), dict(quality=90, subsampling=1, restart_marker_rows=2))]


def photo(h, w, seed):
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(cells).resize((w, h), Image.BICUBIC), np.float32)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


if __name__ == '__main__':
    for i, (size, kw) in enumerate(SPECS):
        Image.fromarray(photo(*size, 200 + i)).save(os.path.join(HERE, f'img_{i}.jpg'), 'JPEG', **kw)
    with open(os.path.join(HERE, 'captions.json'), 'w') as f:
        json.dump({f'img_{i}': f'a photo of cat {i}' for i in range(len(SPECS))}, f, indent=0)
