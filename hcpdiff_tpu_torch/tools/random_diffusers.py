"""Write a diffusers-layout model directory of seeded random weights: the
port's counterpart of the JAX package's
``CkptManagerDiffusers.save_pipeline``, for runs of the config-driven
entry point (``python -m hcpdiff_tpu_torch.visualizer``) while the repo
ships no checkpoint.

    python -m hcpdiff_tpu_torch.tools.random_diffusers --model sd15 --out DIR \\
        [--seed 0] [--dtype f16|f32] [--device cuda|cpu]

The weights are ``tools/random_sd15.py``'s (or ``random_sdxl.py``'s) at the
seed, before their bf16 cast. Each submodel directory gets a
``config.json`` and ``diffusion_pytorch_model.safetensors`` (UNet, VAE) or
``model.safetensors`` (text encoders), in F16 by default, as diffusers'
fp16 variant holds them (SD1.5: about 2 GB), or F32. There is no
``tokenizer/``: the factory then takes the byte-level tiny tokenizer,
whose BOS/EOS ids the text encoders' configs carry.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import torch

from ..ckpt import safetensors_io
from ..ckpt.diffusers_layout import clip_key_map, from_port, unet_key_map, vae_key_map
from ..models.clip import CLIPTextModel
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL
from .random_sd15 import sd15_modules
from .random_sdxl import sdxl_modules

SUBDIRS = {'sd15': ('unet', 'vae', 'text_encoder'),
           'sdxl': ('unet', 'vae', 'text_encoder', 'text_encoder_2')}
MODULES = {'sd15': sd15_modules, 'sdxl': sdxl_modules}
DTYPES = {'f16': torch.float16, 'f32': torch.float32}


def unet_config(cfg) -> Dict:
    return {'_class_name': 'UNet2DConditionModel', 'in_channels': cfg.in_channels,
            'out_channels': cfg.out_channels, 'block_out_channels': list(cfg.block_out_channels),
            'down_block_types': list(cfg.down_block_types),
            'up_block_types': list(cfg.up_block_types), 'layers_per_block': cfg.layers_per_block,
            'transformer_layers_per_block': list(cfg.transformer_layers_per_block),
            'attention_head_dim': list(cfg.num_heads),
            'cross_attention_dim': cfg.cross_attention_dim,
            'norm_num_groups': cfg.norm_num_groups,
            'addition_embed_type': cfg.addition_embed_type,
            'addition_time_embed_dim': cfg.addition_time_embed_dim,
            'projection_class_embeddings_input_dim': cfg.projection_class_embeddings_input_dim,
            'use_linear_projection': False}


def vae_config(cfg) -> Dict:
    return {'_class_name': 'AutoencoderKL', 'in_channels': cfg.in_channels,
            'out_channels': cfg.out_channels, 'latent_channels': cfg.latent_channels,
            'block_out_channels': list(cfg.block_out_channels),
            'layers_per_block': cfg.layers_per_block, 'norm_num_groups': cfg.norm_num_groups,
            'scaling_factor': cfg.scaling_factor}


def clip_config_json(cfg) -> Dict:
    arch = 'CLIPTextModelWithProjection' if cfg.projection_dim else 'CLIPTextModel'
    return {'architectures': [arch], 'vocab_size': cfg.vocab_size,
            'hidden_size': cfg.hidden_size, 'intermediate_size': cfg.intermediate_size,
            'num_hidden_layers': cfg.num_hidden_layers,
            'num_attention_heads': cfg.num_attention_heads,
            'max_position_embeddings': cfg.max_position_embeddings,
            'hidden_act': cfg.hidden_act, 'layer_norm_eps': cfg.layer_norm_eps,
            'eos_token_id': cfg.eos_token_id, 'bos_token_id': cfg.bos_token_id,
            'projection_dim': cfg.projection_dim}


def write_module(module: torch.nn.Module, sub_dir: str, dtype: torch.dtype) -> None:
    """One submodel directory: config.json and the weights in ``dtype``."""
    cfg = module.cfg
    if isinstance(module, UNet2DCondition):
        config, key_map, fname = unet_config(cfg), unet_key_map(cfg), \
            'diffusion_pytorch_model.safetensors'
    elif isinstance(module, AutoencoderKL):
        config, key_map, fname = vae_config(cfg), vae_key_map(cfg), \
            'diffusion_pytorch_model.safetensors'
    elif isinstance(module, CLIPTextModel):
        config, key_map, fname = clip_config_json(cfg), clip_key_map(cfg), 'model.safetensors'
    else:
        raise TypeError(f'no diffusers layout for {type(module).__name__}')
    os.makedirs(sub_dir, exist_ok=True)
    with open(os.path.join(sub_dir, 'config.json'), 'w') as f:
        json.dump(config, f, indent=2)
    sd = {k: v.detach().to('cpu', dtype) for k, v in module.state_dict().items()}
    safetensors_io.save_file(from_port(sd, key_map, sub_dir), os.path.join(sub_dir, fname),
                             metadata={'format': 'pt'})


@torch.no_grad()
def write_dir(out_dir: str, model: str = 'sd15', seed: int = 0,
              dtype: torch.dtype = torch.float16, device='cuda') -> str:
    """Write ``model``'s seeded weights under ``out_dir``; one submodel at
    a time is held on ``device``."""
    for sub, module in zip(SUBDIRS[model], MODULES[model](torch.device(device), seed)):
        write_module(module, os.path.join(out_dir, sub), dtype)
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
