"""Images from a prompt list through the Visualizer, e.g. DreamBooth
regularisation images (a port of ``hcpdiff_tpu/tools/gen_from_ptlist.py``):

    python -m hcpdiff_tpu_torch.tools.gen_from_ptlist --cfg cfgs/infer/text2img.yaml \\
        --prompt_file prompts.txt --out_dir imgs_reg/ [--num_per_prompt 2] \\
        [--image_type png|jpg|webp] [--quality 95] [key=value ...]

The prompts come from a ``.txt`` (one a line), a ``.csv`` (the first
column) or a ``.parquet`` (its ``prompt`` column, else its first; needs
pandas). Each prompt is one ``vis_to_dir`` call of ``--num_per_prompt``
requests, at seeds ``seed``, ``seed + 1``, ... (the JAX tool draws every
one at ``seed``), written by a ``DiskInterface`` at ``--out_dir`` in
``--image_type`` at ``--quality``, with the reproduction YAML beside
each. The ``key=value`` overrides go to the config, as for
``python -m hcpdiff_tpu_torch.visualizer``: it runs on the card unless
they say ``device=cpu``.
"""
from __future__ import annotations

import argparse
import csv
from typing import List, Tuple

import numpy as np


def load_prompts(path: str) -> List[str]:
    if path.endswith('.parquet'):
        try:
            import pandas as pd
        except ImportError:
            raise SystemExit('pandas is not installed: use a .txt or .csv prompt file')
        df = pd.read_parquet(path)
        col = 'prompt' if 'prompt' in df.columns else df.columns[0]
        return list(df[col].astype(str))
    if path.endswith('.csv'):
        with open(path, newline='', encoding='utf-8') as f:
            return [row[0] for row in csv.reader(f) if row]
    with open(path, encoding='utf-8') as f:
        return [line.strip() for line in f if line.strip()]


def main(argv=None) -> Tuple[object, np.ndarray]:
    """Returns the Visualizer and every image (float32 [N, H, W, 3])."""
    from ..config import load
    from ..infer.interfaces import DiskInterface
    from ..infer.visualizer import Visualizer
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--cfg', required=True)
    p.add_argument('--prompt_file', required=True)
    p.add_argument('--out_dir', default='imgs_reg/')
    p.add_argument('--num_per_prompt', type=int, default=1)
    p.add_argument('--image_type', default='png')
    p.add_argument('--quality', type=int, default=95)
    a, unknown = p.parse_known_args(argv)
    prompts = load_prompts(a.prompt_file)
    if not prompts:
        raise SystemExit(f'{a.prompt_file} holds no prompt')
    viser = Visualizer(load(a.cfg, unknown))
    viser.interfaces = [DiskInterface(a.out_dir, image_type=a.image_type, quality=a.quality)]
    images = np.concatenate([viser.vis_to_dir(prompt=prompt, num=a.num_per_prompt)
                             for prompt in prompts], axis=0)
    print(f'generated {len(images)} images in {a.out_dir}')
    return viser, images


if __name__ == '__main__':
    main()
