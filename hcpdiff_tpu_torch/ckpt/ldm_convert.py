"""LDM/webui ControlNet files (``control_model.*`` keys) -> the port's
ControlNet state dict: the part of ``hcpdiff_tpu/ckpt/ldm_convert.py``
that ``CkptManagerBase.load_plugins`` needs (``unet_ldm_to_diffusers_map``,
``_convert_by_module_map``, ``controlnet_ldm_to_ours``), copied, with the
diffusers -> port step through ``diffusers_layout.py``'s UNet key map.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from .diffusers_layout import to_port, unet_key_map

UNET_LDM_PREFIX = 'model.diffusion_model.'
CONTROL_LDM_PREFIX = 'control_model.'


def _resnet_map(ldm: str, dif: str):
    return [(f'{ldm}.in_layers.0', f'{dif}.norm1'),
            (f'{ldm}.in_layers.2', f'{dif}.conv1'),
            (f'{ldm}.emb_layers.1', f'{dif}.time_emb_proj'),
            (f'{ldm}.out_layers.0', f'{dif}.norm2'),
            (f'{ldm}.out_layers.3', f'{dif}.conv2'),
            (f'{ldm}.skip_connection', f'{dif}.conv_shortcut')]


def unet_ldm_to_diffusers_map(num_blocks: int = 4, layers_per_block: int = 2,
                              attn_blocks=(True, True, True, False)) -> Dict[str, str]:
    """{LDM module: diffusers module} of an SD1.x-shaped UNet."""
    m: Dict[str, str] = {
        'time_embed.0': 'time_embedding.linear_1',
        'time_embed.2': 'time_embedding.linear_2',
        'input_blocks.0.0': 'conv_in',
        'out.0': 'conv_norm_out',
        'out.2': 'conv_out',
        'middle_block.1': 'mid_block.attentions.0',
    }
    pairs = []
    i = 1
    for b in range(num_blocks):
        for l in range(layers_per_block):
            pairs += _resnet_map(f'input_blocks.{i}.0', f'down_blocks.{b}.resnets.{l}')
            if attn_blocks[b]:
                m[f'input_blocks.{i}.1'] = f'down_blocks.{b}.attentions.{l}'
            i += 1
        if b < num_blocks - 1:
            m[f'input_blocks.{i}.0.op'] = f'down_blocks.{b}.downsamplers.0.conv'
            i += 1
    pairs += _resnet_map('middle_block.0', 'mid_block.resnets.0')
    pairs += _resnet_map('middle_block.2', 'mid_block.resnets.1')
    i = 0
    for b in range(num_blocks):
        ab = attn_blocks[num_blocks - 1 - b]
        for l in range(layers_per_block + 1):
            pairs += _resnet_map(f'output_blocks.{i}.0', f'up_blocks.{b}.resnets.{l}')
            if ab:
                m[f'output_blocks.{i}.1'] = f'up_blocks.{b}.attentions.{l}'
            if b < num_blocks - 1 and l == layers_per_block:
                m[f'output_blocks.{i}.{2 if ab else 1}.conv'] = f'up_blocks.{b}.upsamplers.0.conv'
            i += 1
    m.update(dict(pairs))
    return m


def _convert_by_module_map(sd: Mapping[str, torch.Tensor], module_map: Dict[str, str],
                           prefix: str) -> Dict[str, torch.Tensor]:
    """Rename ``prefix``-ed '<module>.<param>' keys by the longest module
    prefix the map holds (attention blocks map as whole modules: their
    inner names are the same in both layouts); other keys are dropped."""
    out: Dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        if not key.startswith(prefix):
            continue
        mod, _, param = key[len(prefix):].rpartition('.')
        cur, rest = mod, ''
        while cur:
            if cur in module_map:
                new_mod = module_map[cur] + rest
                out[f'{new_mod}.{param}' if new_mod else param] = v
                break
            cur, _, tail = cur.rpartition('.')
            rest = f'.{tail}{rest}'
    return out


def controlnet_ldm_to_ours(sd: Mapping[str, torch.Tensor], unet_cfg) -> Dict[str, torch.Tensor]:
    """A webui/LDM ControlNet state dict ('control_model.*') -> the port's
    ``ControlNet`` state dict: the shared down and mid blocks by the UNet's
    LDM -> diffusers -> port maps, the zero convs and the hint block's
    convs by position (``ControlNetConditioningEmbedding`` has the same
    ladder; its convs sit at the hint block's even indices)."""
    body = {k[len(CONTROL_LDM_PREFIX):]: v for k, v in sd.items()
            if k.startswith(CONTROL_LDM_PREFIX)}
    mod_map = unet_ldm_to_diffusers_map(
        len(unet_cfg.block_out_channels), unet_cfg.layers_per_block,
        tuple('CrossAttn' in t for t in unet_cfg.down_block_types))
    dif = _convert_by_module_map({UNET_LDM_PREFIX + k: v for k, v in body.items()}, mod_map,
                                 UNET_LDM_PREFIX)
    out = to_port(dif, unet_key_map(unet_cfg), 'controlnet')

    def put_conv(dst: str, src: str):
        out[f'{dst}.weight'] = body[f'{src}.weight']
        out[f'{dst}.bias'] = body[f'{src}.bias']

    n = 0
    while f'zero_convs.{n}.0.weight' in body:
        put_conv(f'zero_{n}', f'zero_convs.{n}.0')
        n += 1
    if 'middle_block_out.0.weight' in body:
        put_conv('zero_mid', 'middle_block_out.0')
    hint = (['cond_embedding.conv_in'] + [f'cond_embedding.blocks_{i}' for i in range(6)]
            + ['cond_embedding.conv_out'])
    for i, dst in enumerate(hint):
        if f'input_hint_block.{2 * i}.weight' in body:
            put_conv(dst, f'input_hint_block.{2 * i}')
    return out
