"""Embedding files between webui and HCP, SDXL's two encoders joined or
split (a port of ``hcpdiff_tpu/tools/embedding_convert.py``):

    python -m hcpdiff_tpu_torch.tools.embedding_convert --from_webui --path e.pt \\
        --dump_path out.pt [--sdxl]
    python -m hcpdiff_tpu_torch.tools.embedding_convert --to_webui --path e.pt \\
        --dump_path out.pt [--sdxl]

Exactly one of ``--from_webui`` and ``--to_webui`` gives the direction.
With ``--sdxl --from_webui`` an SDXL webui file (``{'clip_l': [n, 768],
'clip_g': [n, 1280]}``) becomes one HCP embedding of the joined rows
([n, 2048], the layout the trainer splits); with ``--sdxl --to_webui`` an
HCP embedding is split back at column 768. Without ``--sdxl`` the file is
rewritten as an HCP/webui ``.pt`` (``{'string_to_param': {'*': vectors},
'name'}``), the layout both sides share. Files are read with
``weights_only=True``; a file that holds no embedding, or not the one
the direction reads, raises.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..ckpt.formats import load_webui_embedding, save_webui_embedding

CLIP_L_DIM = 768


def convert(path: str, dump_path: str, sdxl: bool = False, to_webui: bool = False) -> None:
    obj = torch.load(path, map_location='cpu', weights_only=True)
    split = isinstance(obj, dict) and ('clip_l' in obj or 'clip_g' in obj)
    if sdxl and not to_webui:
        if not (split and 'clip_l' in obj and 'clip_g' in obj):
            raise ValueError(f'{path}: no clip_l and clip_g rows (not an SDXL webui embedding)')
        vec = np.concatenate([obj['clip_l'].float().numpy(), obj['clip_g'].float().numpy()],
                             axis=-1)
        save_webui_embedding(dump_path, vec, os.path.splitext(os.path.basename(path))[0])
        return
    if split:
        raise ValueError(f'{path} is an SDXL webui embedding (clip_l/clip_g): convert it with '
                         '--from_webui --sdxl')
    name, vec = load_webui_embedding(path)
    if vec.ndim != 2:
        raise ValueError(f'{path}: an embedding of shape {vec.shape}, not [n, dim]')
    if sdxl:
        if vec.shape[1] <= CLIP_L_DIM:
            raise ValueError(f'{path}: [n, {vec.shape[1]}] is no SDXL embedding (768 + 1280)')
        os.makedirs(os.path.dirname(os.path.abspath(dump_path)), exist_ok=True)
        torch.save({'clip_l': torch.tensor(vec[:, :CLIP_L_DIM]),
                    'clip_g': torch.tensor(vec[:, CLIP_L_DIM:])}, dump_path)
        return
    save_webui_embedding(dump_path, vec, name)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--from_webui', action='store_true')
    p.add_argument('--to_webui', action='store_true')
    p.add_argument('--path', required=True)
    p.add_argument('--dump_path', required=True)
    p.add_argument('--sdxl', action='store_true')
    a = p.parse_args(argv)
    if a.to_webui == a.from_webui:
        raise SystemExit('specify one of --to_webui and --from_webui')
    convert(a.path, a.dump_path, a.sdxl, a.to_webui)
    print(f'wrote {a.dump_path}')


if __name__ == '__main__':
    main()
