"""A webui/LDM single-file checkpoint -> a diffusers-layout directory (a
port of ``hcpdiff_tpu/tools/sd2diffusers.py``):

    python -m hcpdiff_tpu_torch.tools.sd2diffusers --checkpoint_path sd15.safetensors \\
        --dump_path models/my-sd [--half] [--prediction_type epsilon|v_prediction]
    python -m hcpdiff_tpu_torch.tools.sd2diffusers --vae_pt_path vae.pt --dump_path my-vae/

The file's UNet, VAE and text encoder (SD1.x's CLIP or SD2.x's open_clip
tower, told apart by ``ldm_convert.is_sd2_checkpoint``) go to ``unet/``,
``vae/`` and ``text_encoder/``, each with the JAX tool's fixed
``config.json`` (SD1.5's or SD2's), beside its ``model_index.json`` and
a DDIM ``scheduler/scheduler_config.json`` (``v_prediction`` for SD2
unless ``--prediction_type`` says otherwise). ``models/factory.py``
reads these configs back as ``UNetConfig.sd15()``/``sd21()``,
``VAEConfig.sd()`` and ``CLIPTextConfig.sd15()``/``sd2()``. Tensors keep
their dtype (``--half``: fp16). A ``.ckpt`` is read with
``weights_only=True`` (``CkptManagerWebui.read_single_file`` says which
files need more). The JAX tool's ``--original_config_file`` and
``--vae_path``, which it takes and never reads, are not options here:
argparse refuses them.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from ..ckpt import safetensors_io
from ..ckpt.ldm_convert import VAE_LDM_PREFIX, is_sd2_checkpoint, split_ldm_checkpoint, \
    vae_ldm_to_diffusers
from ..ckpt.manager import CkptManagerWebui

SD15_UNET_CONFIG = {
    '_class_name': 'UNet2DConditionModel',
    'in_channels': 4, 'out_channels': 4,
    'block_out_channels': [320, 640, 1280, 1280],
    'down_block_types': ['CrossAttnDownBlock2D', 'CrossAttnDownBlock2D',
                         'CrossAttnDownBlock2D', 'DownBlock2D'],
    'up_block_types': ['UpBlock2D', 'CrossAttnUpBlock2D',
                       'CrossAttnUpBlock2D', 'CrossAttnUpBlock2D'],
    'layers_per_block': 2, 'cross_attention_dim': 768,
    'attention_head_dim': 8, 'norm_num_groups': 32, 'sample_size': 64,
}
SD_VAE_CONFIG = {
    '_class_name': 'AutoencoderKL',
    'in_channels': 3, 'out_channels': 3, 'latent_channels': 4,
    'block_out_channels': [128, 256, 512, 512], 'layers_per_block': 2,
    'norm_num_groups': 32, 'scaling_factor': 0.18215,
}
SD15_TE_CONFIG = {
    'architectures': ['CLIPTextModel'], 'vocab_size': 49408,
    'hidden_size': 768, 'intermediate_size': 3072, 'num_hidden_layers': 12,
    'num_attention_heads': 12, 'max_position_embeddings': 77,
    'hidden_act': 'quick_gelu', 'bos_token_id': 49406, 'eos_token_id': 49407,
}
SD2_UNET_CONFIG = dict(SD15_UNET_CONFIG, cross_attention_dim=1024,
                       attention_head_dim=[5, 10, 20, 20], sample_size=96)
SD2_TE_CONFIG = dict(SD15_TE_CONFIG, hidden_size=1024, intermediate_size=4096,
                     num_hidden_layers=23, num_attention_heads=16, hidden_act='gelu')
WEIGHTS = {'unet': 'diffusion_pytorch_model.safetensors',
           'vae': 'diffusion_pytorch_model.safetensors', 'text_encoder': 'model.safetensors'}


def _write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f, indent=2)


def convert_vae_only(vae_pt_path: str, dump_path: str, allow_pickle: bool = False) -> None:
    """A VAE alone (``.pt``/``.ckpt``/``.safetensors``, with or without the
    ``first_stage_model.`` prefix) -> a diffusers VAE directory."""
    sd = CkptManagerWebui.read_single_file(vae_pt_path, allow_pickle)
    if not any(k.startswith(VAE_LDM_PREFIX) for k in sd):
        sd = {VAE_LDM_PREFIX + k: v for k, v in sd.items()}
    vae = vae_ldm_to_diffusers(sd)
    if not vae:
        raise ValueError(f'{vae_pt_path}: no VAE weights under the LDM names')
    _write_json(os.path.join(dump_path, 'config.json'), SD_VAE_CONFIG)
    safetensors_io.save_file(vae, os.path.join(dump_path, WEIGHTS['vae']))
    print(f'wrote diffusers vae to {dump_path}')


def convert(checkpoint_path: str, dump_path: str, half: bool = False,
            prediction_type: Optional[str] = None, allow_pickle: bool = False) -> None:
    sd = CkptManagerWebui.read_single_file(checkpoint_path, allow_pickle)
    sd2 = is_sd2_checkpoint(sd)
    parts = split_ldm_checkpoint(sd)
    empty = [k for k, v in parts.items() if not v]
    if empty:
        raise ValueError(f'{checkpoint_path}: no {empty} weights under the LDM names '
                         '(not an SD1.x/SD2.x single-file checkpoint)')
    if half:
        parts = {p: {k: v.half() for k, v in d.items()} for p, d in parts.items()}
    sched = {'_class_name': 'DDIMScheduler', 'beta_start': 0.00085, 'beta_end': 0.012,
             'beta_schedule': 'scaled_linear', 'num_train_timesteps': 1000, 'steps_offset': 1,
             'prediction_type': prediction_type or ('v_prediction' if sd2 else 'epsilon')}
    _write_json(os.path.join(dump_path, 'scheduler', 'scheduler_config.json'), sched)
    _write_json(os.path.join(dump_path, 'model_index.json'),
                {'_class_name': 'StableDiffusionPipeline',
                 'unet': ['diffusers', 'UNet2DConditionModel'],
                 'vae': ['diffusers', 'AutoencoderKL'],
                 'text_encoder': ['transformers', 'CLIPTextModel'],
                 'scheduler': ['diffusers', sched['_class_name']]})
    configs = {'unet': SD2_UNET_CONFIG if sd2 else SD15_UNET_CONFIG, 'vae': SD_VAE_CONFIG,
               'text_encoder': SD2_TE_CONFIG if sd2 else SD15_TE_CONFIG}
    for sub, cfg in configs.items():
        _write_json(os.path.join(dump_path, sub, 'config.json'), cfg)
        safetensors_io.save_file(parts[sub], os.path.join(dump_path, sub, WEIGHTS[sub]))
    print(f'wrote diffusers layout to {dump_path}')


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--checkpoint_path', default=None)
    p.add_argument('--dump_path', required=True)
    p.add_argument('--vae_pt_path', default=None,
                   help='convert a standalone VAE instead of a full checkpoint')
    p.add_argument('--half', action='store_true')
    p.add_argument('--prediction_type', default=None, choices=['epsilon', 'v_prediction'])
    p.add_argument('--allow_pickle', action='store_true',
                   help='read a .ckpt with the full unpickler (trusted files only)')
    a = p.parse_args(argv)
    if a.vae_pt_path:
        convert_vae_only(a.vae_pt_path, a.dump_path, a.allow_pickle)
        return
    if not a.checkpoint_path:
        raise SystemExit('--checkpoint_path or --vae_pt_path required')
    convert(a.checkpoint_path, a.dump_path, a.half, a.prediction_type, a.allow_pickle)


if __name__ == '__main__':
    main()
