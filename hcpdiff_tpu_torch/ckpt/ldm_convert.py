"""LDM/webui single-file checkpoints <-> diffusers-layout state dicts, and
webui ControlNet files (counterpart of ``hcpdiff_tpu/ckpt/ldm_convert.py``,
with its names, on ``torch.Tensor``s).

- ``unet_ldm_to_diffusers``/``unet_diffusers_to_ldm``: an SD1.x/SD2.x
  UNet (4 levels, 2 resnets a level) by a module map; the transformer
  blocks map as whole modules, their inner names being alike;
- ``vae_ldm_to_diffusers``/``vae_diffusers_to_ldm``: the SD VAE, the
  decoder's up blocks in reverse order, the mid-block attention's 1x1
  convs as Linear weights in the diffusers layout;
- ``te_ldm_to_diffusers``: SD1.x's CLIP under ``cond_stage_model.
  transformer.`` (a prefix strip); ``te_openclip_to_diffusers``: SD2.x's
  open_clip tower, its fused ``in_proj`` split into q, k and v, and
  ``te_diffusers_to_openclip`` its inverse (no JAX counterpart: the JAX
  ``diffusers2sd`` writes every encoder under SD1.x's prefix);
- ``split_ldm_checkpoint``: one single file -> {'unet', 'vae',
  'text_encoder'} diffusers state dicts (``is_sd2_checkpoint`` picks the
  text tower);
- ``controlnet_ldm_to_ours``: a ``control_model.*`` file -> the port's
  ControlNet state dict, the diffusers -> port step through
  ``diffusers_layout.py``'s UNet key map.

Keys that the maps to diffusers do not name are dropped, as in the JAX
functions (the LDM
files carry EMA copies, the noise schedule's buffers and open_clip's
contrastive head beside the weights).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from .diffusers_layout import to_port, unet_key_map

UNET_LDM_PREFIX = 'model.diffusion_model.'
VAE_LDM_PREFIX = 'first_stage_model.'
TE_LDM_PREFIX = 'cond_stage_model.transformer.'
TE_LDM_PREFIX_V2 = 'cond_stage_model.model.'
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


def _vae_resnet_map(ldm: str, dif: str):
    return [(f'{ldm}.norm1', f'{dif}.norm1'), (f'{ldm}.conv1', f'{dif}.conv1'),
            (f'{ldm}.norm2', f'{dif}.norm2'), (f'{ldm}.conv2', f'{dif}.conv2'),
            (f'{ldm}.nin_shortcut', f'{dif}.conv_shortcut')]


def vae_ldm_to_diffusers_map(num_blocks: int = 4, layers_per_block: int = 2
                             ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """(module map, attention map) of the SD VAE: {LDM module: diffusers
    module}; the attention map's weights are 1x1 convs in LDM and Linear in
    diffusers."""
    m: Dict[str, str] = {
        'encoder.conv_in': 'encoder.conv_in',
        'encoder.norm_out': 'encoder.conv_norm_out',
        'encoder.conv_out': 'encoder.conv_out',
        'decoder.conv_in': 'decoder.conv_in',
        'decoder.norm_out': 'decoder.conv_norm_out',
        'decoder.conv_out': 'decoder.conv_out',
        'quant_conv': 'quant_conv',
        'post_quant_conv': 'post_quant_conv',
    }
    pairs = []
    for b in range(num_blocks):
        for l in range(layers_per_block):
            pairs += _vae_resnet_map(f'encoder.down.{b}.block.{l}',
                                     f'encoder.down_blocks.{b}.resnets.{l}')
        if b < num_blocks - 1:
            m[f'encoder.down.{b}.downsample.conv'] = f'encoder.down_blocks.{b}.downsamplers.0.conv'
    for side in ('encoder', 'decoder'):
        pairs += _vae_resnet_map(f'{side}.mid.block_1', f'{side}.mid_block.resnets.0')
        pairs += _vae_resnet_map(f'{side}.mid.block_2', f'{side}.mid_block.resnets.1')
    for b in range(num_blocks):
        ldm_b = num_blocks - 1 - b            # LDM's decoder.up runs the other way
        for l in range(layers_per_block + 1):
            pairs += _vae_resnet_map(f'decoder.up.{ldm_b}.block.{l}',
                                     f'decoder.up_blocks.{b}.resnets.{l}')
        if b < num_blocks - 1:
            m[f'decoder.up.{ldm_b}.upsample.conv'] = f'decoder.up_blocks.{b}.upsamplers.0.conv'
    m.update(dict(pairs))
    attn = {}
    for side in ('encoder', 'decoder'):
        a, d = f'{side}.mid.attn_1', f'{side}.mid_block.attentions.0'
        attn.update({f'{a}.norm': f'{d}.group_norm', f'{a}.q': f'{d}.to_q',
                     f'{a}.k': f'{d}.to_k', f'{a}.v': f'{d}.to_v',
                     f'{a}.proj_out': f'{d}.to_out.0'})
    return m, attn


def _convert_by_module_map(sd: Mapping[str, torch.Tensor], module_map: Dict[str, str],
                           prefix: str, reverse: bool = False) -> Dict[str, torch.Tensor]:
    """Rename '<module>.<param>' keys by the longest module prefix the map
    holds (attention blocks map as whole modules: their inner names are the
    same in both layouts); other keys are dropped. Forward: ``prefix``-ed
    LDM keys -> diffusers keys; ``reverse``: diffusers keys -> ``prefix``-ed
    LDM keys."""
    mm = {v: k for k, v in module_map.items()} if reverse else module_map
    out: Dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        if not reverse:
            if not key.startswith(prefix):
                continue
            key = key[len(prefix):]
        mod, _, param = key.rpartition('.')
        cur, rest = mod, ''
        while cur:
            if cur in mm:
                new_mod = mm[cur] + rest
                new_key = f'{new_mod}.{param}' if new_mod else param
                out[prefix + new_key if reverse else new_key] = v
                break
            cur, _, tail = cur.rpartition('.')
            rest = f'.{tail}{rest}'
    return out


def unet_ldm_to_diffusers(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return _convert_by_module_map(sd, unet_ldm_to_diffusers_map(), UNET_LDM_PREFIX)


def unet_diffusers_to_ldm(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return _convert_by_module_map(sd, unet_ldm_to_diffusers_map(), UNET_LDM_PREFIX,
                                  reverse=True)


def vae_ldm_to_diffusers(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    mod_map, attn_map = vae_ldm_to_diffusers_map()
    out = _convert_by_module_map(sd, mod_map, VAE_LDM_PREFIX)
    for lk, dk in attn_map.items():
        for suffix in ('weight', 'bias'):
            v = sd.get(f'{VAE_LDM_PREFIX}{lk}.{suffix}')
            if v is not None:
                out[f'{dk}.{suffix}'] = v[:, :, 0, 0] if v.dim() == 4 else v
    return out


def vae_diffusers_to_ldm(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    mod_map, attn_map = vae_ldm_to_diffusers_map()
    out = _convert_by_module_map(sd, mod_map, VAE_LDM_PREFIX, reverse=True)
    for lk, dk in attn_map.items():
        for suffix in ('weight', 'bias'):
            v = sd.get(f'{dk}.{suffix}')
            if v is not None:
                weight2d = suffix == 'weight' and v.dim() == 2
                out[f'{VAE_LDM_PREFIX}{lk}.{suffix}'] = v[:, :, None, None] if weight2d else v
    return out


def te_ldm_to_diffusers(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """SD1.x's CLIP: the LDM prefix stripped (transformers' names)."""
    return {k[len(TE_LDM_PREFIX):]: v for k, v in sd.items() if k.startswith(TE_LDM_PREFIX)}


def is_sd2_checkpoint(sd: Mapping[str, torch.Tensor]) -> bool:
    """SD2.x ships an open_clip text tower (fused q/k/v ``in_proj``)."""
    return any(k.startswith(TE_LDM_PREFIX_V2 + 'transformer.resblocks.') for k in sd)


def te_openclip_to_diffusers(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """SD2.x's open_clip text tower -> transformers' CLIPTextModel keys,
    ``attn.in_proj_weight``/``_bias`` split into the q, k and v
    projections. ``text_projection`` and ``logit_scale`` (the contrastive
    head, which SD2's conditioning does not use) are dropped, as in the
    JAX function."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if not k.startswith(TE_LDM_PREFIX_V2):
            continue
        k = k[len(TE_LDM_PREFIX_V2):]
        if k == 'token_embedding.weight':
            out['text_model.embeddings.token_embedding.weight'] = v
        elif k == 'positional_embedding':
            out['text_model.embeddings.position_embedding.weight'] = v
        elif k.startswith('ln_final.'):
            out['text_model.final_layer_norm.' + k.split('.', 1)[1]] = v
        elif k.startswith('transformer.resblocks.'):
            i, sub = k[len('transformer.resblocks.'):].split('.', 1)
            base = f'text_model.encoder.layers.{i}.'
            if sub.startswith('ln_1.'):
                out[base + 'layer_norm1.' + sub.split('.', 1)[1]] = v
            elif sub.startswith('ln_2.'):
                out[base + 'layer_norm2.' + sub.split('.', 1)[1]] = v
            elif sub.startswith('mlp.c_fc.'):
                out[base + 'mlp.fc1.' + sub.split('.')[-1]] = v
            elif sub.startswith('mlp.c_proj.'):
                out[base + 'mlp.fc2.' + sub.split('.')[-1]] = v
            elif sub in ('attn.in_proj_weight', 'attn.in_proj_bias'):
                kind = sub.rsplit('_', 1)[1]
                for name, part in zip(('q_proj', 'k_proj', 'v_proj'), torch.chunk(v, 3, dim=0)):
                    out[base + f'self_attn.{name}.{kind}'] = part
            elif sub.startswith('attn.out_proj.'):
                out[base + 'self_attn.out_proj.' + sub.split('.')[-1]] = v
    return out


OPENCLIP_NAMES = {'layer_norm1': 'ln_1', 'layer_norm2': 'ln_2', 'mlp.fc1': 'mlp.c_fc',
                  'mlp.fc2': 'mlp.c_proj', 'self_attn.out_proj': 'attn.out_proj'}


def te_diffusers_to_openclip(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """transformers' CLIPTextModel keys -> SD2.x's open_clip tower under
    ``cond_stage_model.model.``, q, k and v joined into ``attn.in_proj``
    (the inverse of ``te_openclip_to_diffusers`` on what it keeps: the
    file holds the layers the encoder has, and no ``text_projection`` or
    ``logit_scale``). ``position_ids`` (a buffer of 0..76) is not a
    weight and is not written; any other key raises."""
    p, out, qkv, unknown = TE_LDM_PREFIX_V2, {}, {}, []
    for k, v in sd.items():
        if k == 'text_model.embeddings.token_embedding.weight':
            out[p + 'token_embedding.weight'] = v
        elif k == 'text_model.embeddings.position_embedding.weight':
            out[p + 'positional_embedding'] = v
        elif k.startswith('text_model.final_layer_norm.'):
            out[p + 'ln_final.' + k.rsplit('.', 1)[1]] = v
        elif k.startswith('text_model.encoder.layers.'):
            i, sub = k[len('text_model.encoder.layers.'):].split('.', 1)
            module, kind = sub.rsplit('.', 1)
            base = f'{p}transformer.resblocks.{i}.'
            if module in OPENCLIP_NAMES:
                out[base + f'{OPENCLIP_NAMES[module]}.{kind}'] = v
            elif module in ('self_attn.q_proj', 'self_attn.k_proj', 'self_attn.v_proj'):
                qkv.setdefault(base + f'attn.in_proj_{kind}', {})[module[10]] = v
            else:
                unknown.append(k)
        elif k != 'text_model.embeddings.position_ids':
            unknown.append(k)
    for key, parts in qkv.items():
        if sorted(parts) != ['k', 'q', 'v']:
            unknown.append(f'{key}: only {sorted(parts)} of q, k and v')
            continue
        out[key] = torch.cat([parts['q'], parts['k'], parts['v']], dim=0)
    if unknown:
        raise ValueError(f'{len(unknown)} text-encoder weights have no open_clip name: '
                         f'{sorted(unknown)[:8]}')
    return out


def split_ldm_checkpoint(sd: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """One webui/LDM single file -> {'unet', 'vae', 'text_encoder'}
    diffusers-layout state dicts (the SD1.x or SD2.x text tower by
    ``is_sd2_checkpoint``)."""
    te = te_openclip_to_diffusers(sd) if is_sd2_checkpoint(sd) else te_ldm_to_diffusers(sd)
    return {'unet': unet_ldm_to_diffusers(sd), 'vae': vae_ldm_to_diffusers(sd),
            'text_encoder': te}


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
