"""Write a diffusers-layout model directory of seeded random weights (through
``ckpt/diffusers_layout.py:write_module``), for runs of the config-driven
entry point (``python -m hcpdiff_tpu_torch.visualizer``) while the repo
ships no checkpoint.

    python -m hcpdiff_tpu_torch.tools.random_diffusers --model sd15|sd21|sdxl --out DIR \\
        [--seed 0] [--dtype f16|f32] [--device cuda|cpu]

The weights are ``tools/random_sd15.py``'s (``random_sd21.py``'s,
``random_sdxl.py``'s) at the seed, before their bf16 cast. SD2.1's UNet
``config.json`` is a real SD2.1 directory's: ``attention_head_dim: [5, 10,
20, 20]``, ``cross_attention_dim: 1024`` and ``use_linear_projection:
true``, with ``proj_in``/``proj_out`` stored as Linear [C, C] weights; SD1.5
and SDXL keep 1x1 convs. Each submodel directory gets a
``config.json`` and ``diffusion_pytorch_model.safetensors`` (UNet, VAE) or
``model.safetensors`` (text encoders), in F16 by default, as diffusers'
fp16 variant holds them (SD1.5: about 2 GB), or F32. There is no
``tokenizer/``: the factory then takes the byte-level tiny tokenizer,
whose BOS/EOS ids the text encoders' configs carry.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..ckpt.diffusers_layout import write_module
from .random_sd15 import sd15_modules
from .random_sd21 import sd21_modules
from .random_sdxl import sdxl_modules

SUBDIRS = {'sd15': ('unet', 'vae', 'text_encoder'),
           'sd21': ('unet', 'vae', 'text_encoder'),
           'sdxl': ('unet', 'vae', 'text_encoder', 'text_encoder_2')}
MODULES = {'sd15': sd15_modules, 'sd21': sd21_modules, 'sdxl': sdxl_modules}
LINEAR_PROJECTION = {'sd21'}        # the models whose directories hold Linear proj_in/out
DTYPES = {'f16': torch.float16, 'f32': torch.float32}


@torch.no_grad()
def write_dir(out_dir: str, model: str = 'sd15', seed: int = 0,
              dtype: torch.dtype = torch.float16, device='cuda') -> str:
    """Write ``model``'s seeded weights under ``out_dir``; one submodel at
    a time is held on ``device``."""
    for sub, module in zip(SUBDIRS[model], MODULES[model](torch.device(device), seed)):
        write_module(module, os.path.join(out_dir, sub), dtype,
                     linear_projection=model in LINEAR_PROJECTION)
        del module
    return out_dir


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--model', choices=sorted(SUBDIRS), default='sd15')
    p.add_argument('--out', required=True)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--dtype', choices=sorted(DTYPES), default='f16')
    p.add_argument('--device', default='cuda')
    a = p.parse_args(argv)
    write_dir(a.out, a.model, a.seed, DTYPES[a.dtype], a.device)
    print(a.out)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
