"""Create a prompt-tuning word's embedding file (a port of
``hcpdiff_tpu/tools/create_embedding.py``):

    python -m hcpdiff_tpu_torch.tools.create_embedding <model> <name> <n_word> \\
        [--init_text 'a photo of cat'] [--root embs/] [--replace]

``<model>`` is a diffusers-layout directory or ``tiny``/``tiny_sdxl``.
The vectors start from the rows of ``--init_text``'s tokens in the text
encoder's table (``*[sigma, n]`` adds n normal vectors of std sigma),
tiled or cut to ``n_word``; without it, normal vectors of std 0.017 (numpy,
seed 42, the JAX tool's draws). For SDXL each vector joins the two
encoders' rows ([n, 768 + 1280], the layout the trainer splits); the JAX
tool takes the first encoder's alone. The file is a webui ``.pt``
embedding, ``<root>/<name>.pt``. Only the text encoders are read from a
directory.
"""
from __future__ import annotations

import argparse
import os
import re
from typing import Optional

import numpy as np
import torch

from ..ckpt.formats import save_webui_embedding
from ..models.factory import build_models, is_sdxl_dir, load_clip
from ..utils.clip_tokenizer import CLIPTokenizer

RANDOM_SLOT = re.compile(r'\*\[([0-9.]+),\s*(\d+)\]')


class PTCreator:
    def __init__(self, pretrained: str = 'tiny', root: str = 'embs/'):
        if pretrained in ('tiny', 'tiny_sdxl'):
            world = build_models(pretrained, dtype=torch.float32, device='cpu')
            self.tokenizer = world['tokenizer']
            encoders = [world['te']] + ([world['te2']] if world['sdxl'] else [])
        else:
            tok_dir = os.path.join(pretrained, 'tokenizer')
            self.tokenizer = (CLIPTokenizer.from_pretrained(tok_dir) if os.path.isdir(tok_dir)
                              else CLIPTokenizer.tiny())
            names = ['text_encoder'] + (['text_encoder_2'] if is_sdxl_dir(pretrained) else [])
            encoders = [load_clip(os.path.join(pretrained, n), 'cpu') for n in names]
        self.table = np.concatenate([te.token_embedding.detach().float().numpy()
                                     for te in encoders], axis=1)
        self.dim = self.table.shape[1]
        self.root = root

    def creat_word_pt(self, name: str, n_word: int, init_text: Optional[str] = None,
                      replace: bool = False, seed: int = 42) -> str:
        path = os.path.join(self.root, f'{name}.pt')
        if os.path.exists(path) and not replace:
            raise FileExistsError(f'{path} exists (use replace=True)')
        rng = np.random.default_rng(seed)
        vectors = []
        if init_text:
            for m in RANDOM_SLOT.finditer(init_text):
                sigma, n = float(m.group(1)), int(m.group(2))
                vectors.append(rng.normal(0, sigma, size=(n, self.dim)))
            rest = RANDOM_SLOT.sub(' ', init_text).strip()
            if rest:
                ids = [i for i in self.tokenizer.tokenize_words(rest) if i < self.table.shape[0]]
                if ids:
                    vectors.append(self.table[ids])
        init = (np.concatenate(vectors, axis=0) if vectors
                else rng.normal(0, 0.017, size=(n_word, self.dim)))
        if init.shape[0] < n_word:                      # tile, then cut to n_word
            init = np.tile(init, (int(np.ceil(n_word / init.shape[0])), 1))
        os.makedirs(self.root, exist_ok=True)
        save_webui_embedding(path, init[:n_word].astype(np.float32), name, step=0)
        return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description='Create a prompt-tuning embedding file')
    p.add_argument('pretrained')
    p.add_argument('name')
    p.add_argument('n_word', type=int)
    p.add_argument('--init_text', default=None)
    p.add_argument('--root', default='embs/')
    p.add_argument('--replace', action='store_true')
    a = p.parse_args(argv)
    path = PTCreator(a.pretrained, a.root).creat_word_pt(a.name, a.n_word, a.init_text,
                                                         a.replace)
    print(f'created {path}')
    return path


if __name__ == '__main__':
    main()
