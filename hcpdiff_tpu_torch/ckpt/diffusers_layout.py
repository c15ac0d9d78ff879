"""diffusers/transformers state dicts <-> the port's state dicts.

The key maps are copies of ``hcpdiff_tpu/ckpt/sd_convert.py:_unet_key_map``
and ``_vae_key_map`` (that file imports flax) and of the CLIP names of
``hcpdiff_tpu/ckpt/clip_convert.py``: lists of (diffusers module path, JAX
module path, kind). The port's modules are named after the JAX tree's
paths, and torch keeps diffusers' layouts (Linear [out, in], Conv OIHW),
so loading is a renaming. Two layout rules remain, as in ``bridge.py``:

- a norm's ``weight`` is the JAX ``scale`` (the name is the same here);
- ``proj_in``/``proj_out`` are Linear in the port; SD1.5's checkpoints
  hold them as 1x1 convs [out, in, 1, 1] (``linear_or_conv1x1``), SD2.x and
  SDXL's as Linear. ``from_port`` writes 1x1 convs, as the JAX package's
  ``CkptManagerDiffusers.save_pipeline`` does, or, with
  ``linear_projection`` (an SD2.1 directory, whose ``config.json`` then
  says ``use_linear_projection: true``), Linear.

``to_port`` is strict: a diffusers key that no entry of the map takes
raises, except transformers' ``position_ids`` buffers. ``write_module``
writes one submodel directory (``config.json`` and safetensors weights)
from a port module: the writer behind ``tools/random_diffusers.py`` and
``CkptManagerDiffusers.save_pipeline``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from . import safetensors_io

KeyMap = List[Tuple[str, str, str]]


def unet_key_map(cfg) -> KeyMap:
    """The UNet's map (``sd_convert.py:_unet_key_map``) for a UNetConfig."""
    m: KeyMap = [
        ('conv_in', 'conv_in', 'conv'),
        ('time_embedding.linear_1', 'time_embedding_linear_1', 'linear'),
        ('time_embedding.linear_2', 'time_embedding_linear_2', 'linear'),
        ('conv_norm_out', 'conv_norm_out', 'norm'),
        ('conv_out', 'conv_out', 'conv'),
    ]
    if cfg.addition_embed_type == 'text_time':
        m += [('add_embedding.linear_1', 'add_embedding_linear_1', 'linear'),
              ('add_embedding.linear_2', 'add_embedding_linear_2', 'linear')]

    def resnet(tp, fp):
        return [(f'{tp}.norm1', f'{fp}.norm1', 'norm'),
                (f'{tp}.conv1', f'{fp}.conv1', 'conv'),
                (f'{tp}.time_emb_proj', f'{fp}.time_emb_proj', 'linear'),
                (f'{tp}.norm2', f'{fp}.norm2', 'norm'),
                (f'{tp}.conv2', f'{fp}.conv2', 'conv'),
                (f'{tp}.conv_shortcut', f'{fp}.conv_shortcut', 'conv')]

    def transformer(tp, fp, depth):
        out = [(f'{tp}.norm', f'{fp}.norm', 'norm'),
               (f'{tp}.proj_in', f'{fp}.proj_in', 'linear_or_conv1x1'),
               (f'{tp}.proj_out', f'{fp}.proj_out', 'linear_or_conv1x1')]
        for k in range(depth):
            b, fb = f'{tp}.transformer_blocks.{k}', f'{fp}.transformer_blocks_{k}'
            for a in ('attn1', 'attn2'):
                out += [(f'{b}.{a}.to_q', f'{fb}.{a}.to_q', 'linear'),
                        (f'{b}.{a}.to_k', f'{fb}.{a}.to_k', 'linear'),
                        (f'{b}.{a}.to_v', f'{fb}.{a}.to_v', 'linear'),
                        (f'{b}.{a}.to_out.0', f'{fb}.{a}.to_out', 'linear')]
            out += [(f'{b}.ff.net.0.proj', f'{fb}.ff.proj', 'linear'),
                    (f'{b}.ff.net.2', f'{fb}.ff.out', 'linear'),
                    (f'{b}.norm1', f'{fb}.norm1', 'norm'),
                    (f'{b}.norm2', f'{fb}.norm2', 'norm'),
                    (f'{b}.norm3', f'{fb}.norm3', 'norm')]
        return out

    n_blocks = len(cfg.block_out_channels)
    for bi, btype in enumerate(cfg.down_block_types):
        for li in range(cfg.layers_per_block):
            m += resnet(f'down_blocks.{bi}.resnets.{li}', f'down_{bi}_res_{li}')
            if btype == 'CrossAttnDownBlock2D':
                m += transformer(f'down_blocks.{bi}.attentions.{li}',
                                 f'down_{bi}_attn_{li}',
                                 cfg.transformer_layers_per_block[bi])
        if bi < n_blocks - 1:
            m += [(f'down_blocks.{bi}.downsamplers.0.conv',
                   f'down_{bi}_downsample.conv', 'conv')]

    m += resnet('mid_block.resnets.0', 'mid_res_0')
    if cfg.mid_cross_attn:
        m += transformer('mid_block.attentions.0', 'mid_attn',
                         cfg.transformer_layers_per_block[-1])
    m += resnet('mid_block.resnets.1', 'mid_res_1')

    rev = list(reversed(range(n_blocks)))
    for bi, btype in enumerate(cfg.up_block_types):
        for li in range(cfg.layers_per_block + 1):
            m += resnet(f'up_blocks.{bi}.resnets.{li}', f'up_{bi}_res_{li}')
            if btype == 'CrossAttnUpBlock2D':
                m += transformer(f'up_blocks.{bi}.attentions.{li}',
                                 f'up_{bi}_attn_{li}',
                                 cfg.transformer_layers_per_block[rev[bi]])
        if bi < len(cfg.up_block_types) - 1:
            m += [(f'up_blocks.{bi}.upsamplers.0.conv',
                   f'up_{bi}_upsample.conv', 'conv')]
    return m


def vae_key_map(cfg) -> KeyMap:
    """The VAE's map (``sd_convert.py:_vae_key_map``) for a VAEConfig."""
    def resnet(tp, fp):
        return [(f'{tp}.norm1', f'{fp}.norm1', 'norm'),
                (f'{tp}.conv1', f'{fp}.conv1', 'conv'),
                (f'{tp}.norm2', f'{fp}.norm2', 'norm'),
                (f'{tp}.conv2', f'{fp}.conv2', 'conv'),
                (f'{tp}.conv_shortcut', f'{fp}.conv_shortcut', 'conv')]

    def attn(tp, fp):
        return [(f'{tp}.group_norm', f'{fp}.group_norm', 'norm'),
                (f'{tp}.to_q', f'{fp}.to_q', 'linear'),
                (f'{tp}.to_k', f'{fp}.to_k', 'linear'),
                (f'{tp}.to_v', f'{fp}.to_v', 'linear'),
                (f'{tp}.to_out.0', f'{fp}.to_out', 'linear')]

    m: KeyMap = [
        ('encoder.conv_in', 'encoder.conv_in', 'conv'),
        ('encoder.conv_norm_out', 'encoder.conv_norm_out', 'norm'),
        ('encoder.conv_out', 'encoder.conv_out', 'conv'),
        ('decoder.conv_in', 'decoder.conv_in', 'conv'),
        ('decoder.conv_norm_out', 'decoder.conv_norm_out', 'norm'),
        ('decoder.conv_out', 'decoder.conv_out', 'conv'),
        ('quant_conv', 'quant_conv', 'conv'),
        ('post_quant_conv', 'post_quant_conv', 'conv'),
    ]
    n = len(cfg.block_out_channels)
    for bi in range(n):
        for li in range(cfg.layers_per_block):
            m += resnet(f'encoder.down_blocks.{bi}.resnets.{li}',
                        f'encoder.down_{bi}_res_{li}')
        if bi < n - 1:
            m += [(f'encoder.down_blocks.{bi}.downsamplers.0.conv',
                   f'encoder.down_{bi}_downsample', 'conv')]
    m += resnet('encoder.mid_block.resnets.0', 'encoder.mid_res_0')
    m += attn('encoder.mid_block.attentions.0', 'encoder.mid_attn')
    m += resnet('encoder.mid_block.resnets.1', 'encoder.mid_res_1')
    m += resnet('decoder.mid_block.resnets.0', 'decoder.mid_res_0')
    m += attn('decoder.mid_block.attentions.0', 'decoder.mid_attn')
    m += resnet('decoder.mid_block.resnets.1', 'decoder.mid_res_1')
    for bi in range(n):
        for li in range(cfg.layers_per_block + 1):
            m += resnet(f'decoder.up_blocks.{bi}.resnets.{li}',
                        f'decoder.up_{bi}_res_{li}')
        if bi < n - 1:
            m += [(f'decoder.up_blocks.{bi}.upsamplers.0.conv',
                   f'decoder.up_{bi}_upsample', 'conv')]
    return m


def clip_key_map(cfg) -> KeyMap:
    """transformers' CLIPTextModel(WithProjection) names
    (``clip_convert.py:clip_text_torch_to_params``) for a CLIPTextConfig;
    ``table`` entries are bare parameters (the embedding tables)."""
    t = 'text_model.'
    m: KeyMap = [(t + 'embeddings.token_embedding', 'token_embedding', 'table'),
                 (t + 'embeddings.position_embedding', 'position_embedding', 'table'),
                 (t + 'final_layer_norm', 'final_layer_norm', 'norm')]
    for i in range(cfg.num_hidden_layers):
        tp, fp = f'{t}encoder.layers.{i}', f'layers_{i}'
        m += [(f'{tp}.layer_norm1', f'{fp}.layer_norm1', 'norm'),
              (f'{tp}.layer_norm2', f'{fp}.layer_norm2', 'norm'),
              (f'{tp}.mlp.fc1', f'{fp}.fc1', 'linear'),
              (f'{tp}.mlp.fc2', f'{fp}.fc2', 'linear')]
        m += [(f'{tp}.self_attn.{p}', f'{fp}.self_attn.{p}', 'linear')
              for p in ('q_proj', 'k_proj', 'v_proj', 'out_proj')]
    if cfg.projection_dim is not None:
        m.append(('text_projection', 'text_projection', 'linear'))
    return m


def clip_canonical(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A CLIP state dict with its encoder keys under ``text_model.`` (the
    JAX converter takes bare, ``text_model.`` and
    ``transformer.text_model.`` keys)."""
    out = {}
    for k, v in sd.items():
        if k.startswith('transformer.text_model.'):
            k = k[len('transformer.'):]
        elif not k.startswith('text_model.') and k != 'text_projection.weight':
            k = 'text_model.' + k
        out[k] = v
    return out


def to_port(sd: Mapping[str, torch.Tensor], key_map: KeyMap, what: str
            ) -> Dict[str, torch.Tensor]:
    """diffusers keys -> the port's; raises on a key the map does not take."""
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for tp, fp, kind in key_map:
        w_key, b_key = tp + '.weight', tp + '.bias'
        if w_key not in sd:
            continue
        used.add(w_key)
        w = sd[w_key]
        if kind == 'table':
            out[fp] = w
            continue
        if kind == 'linear_or_conv1x1' and w.dim() == 4:
            if w.shape[2:] != (1, 1):
                raise ValueError(f'{what}: {w_key} is a {tuple(w.shape[2:])} conv, not 1x1')
            w = w[:, :, 0, 0]
        out[fp + '.weight'] = w
        if b_key in sd:
            used.add(b_key)
            out[fp + '.bias'] = sd[b_key]
    left = [k for k in sd if k not in used and not k.endswith('position_ids')]
    if left:
        raise KeyError(f'{what}: {len(left)} keys the diffusers layout does not name, '
                       f'e.g. {left[:5]}')
    return out


def from_port(sd: Mapping[str, torch.Tensor], key_map: KeyMap, what: str,
              linear_projection: bool = False) -> Dict[str, torch.Tensor]:
    """The port's keys -> diffusers'; proj_in/proj_out as 1x1 convs, or as
    Linear under ``linear_projection``."""
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for tp, fp, kind in key_map:
        if kind == 'table':
            if fp in sd:
                out[tp + '.weight'] = sd[fp]
                used.add(fp)
            continue
        w_key, b_key = fp + '.weight', fp + '.bias'
        if w_key not in sd:
            continue
        used.add(w_key)
        w = sd[w_key]
        conv1x1 = kind == 'linear_or_conv1x1' and not linear_projection
        out[tp + '.weight'] = w[:, :, None, None] if conv1x1 else w
        if b_key in sd:
            used.add(b_key)
            out[tp + '.bias'] = sd[b_key]
    left = [k for k in sd if k not in used]
    if left:
        raise KeyError(f'{what}: {len(left)} port keys the diffusers layout does not name, '
                       f'e.g. {left[:5]}')
    return out


def unet_alias_map(cfg) -> Dict[str, str]:
    """{JAX/port module path: diffusers module path} of the UNet's kernel
    modules (``hcpdiff_tpu/models/factory.py:unet_alias_map``)."""
    return {fp: tp for tp, fp, kind in unet_key_map(cfg) if kind != 'norm'}


def vae_alias_map(cfg) -> Dict[str, str]:
    return {fp: tp for tp, fp, kind in vae_key_map(cfg) if kind != 'norm'}


def clip_alias_map(cfg) -> Dict[str, str]:
    """``hcpdiff_tpu/models/factory.py:clip_alias_map``."""
    out = {}
    for i in range(cfg.num_hidden_layers):
        fb, tb = f'layers_{i}', f'text_model.encoder.layers.{i}'
        for p in ('q_proj', 'k_proj', 'v_proj', 'out_proj'):
            out[f'{fb}.self_attn.{p}'] = f'{tb}.self_attn.{p}'
        out[f'{fb}.fc1'] = f'{tb}.mlp.fc1'
        out[f'{fb}.fc2'] = f'{tb}.mlp.fc2'
    return out


def unet_config(cfg, linear_projection: bool = False) -> Dict:
    """A UNetConfig as diffusers' ``config.json`` (``qkv_bias``, the port's
    biased q/k/v for pre-0.9 LoRAs, only where set); ``attention_head_dim``
    holds the heads a level, as diffusers reads it."""
    out = {'_class_name': 'UNet2DConditionModel', 'in_channels': cfg.in_channels,
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
           'use_linear_projection': bool(linear_projection)}
    if cfg.qkv_bias:
        out['qkv_bias'] = True
    return out


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


def write_module(module: torch.nn.Module, sub_dir: str, dtype: Optional[torch.dtype] = None,
                 state: Optional[Mapping[str, torch.Tensor]] = None,
                 linear_projection: bool = False) -> None:
    """One submodel directory: config.json and the module's weights, each in
    ``dtype`` (None: the dtype it has); ``state`` ({name: tensor}) replaces
    some of the module's own (merged weights held beside it). A UNet's
    proj_in/proj_out are written as Linear under ``linear_projection``,
    else as 1x1 convs."""
    from ..models.clip import CLIPTextModel
    from ..models.unet import UNet2DCondition
    from ..models.vae import AutoencoderKL
    cfg = module.cfg
    if isinstance(module, UNet2DCondition):
        config, key_map, fname = unet_config(cfg, linear_projection), unet_key_map(cfg), \
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
    sd = {**module.state_dict(), **(state or {})}
    sd = {k: v.detach().to('cpu', dtype or v.dtype) for k, v in sd.items()}
    safetensors_io.save_file(from_port(sd, key_map, sub_dir, linear_projection),
                             os.path.join(sub_dir, fname),
                             metadata={'format': 'pt'})
