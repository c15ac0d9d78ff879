"""Model factory: build the SD model families from a local diffusers-layout
directory (counterpart of ``hcpdiff_tpu/models/factory.py``).

A directory holds ``unet/``, ``vae/``, ``text_encoder/`` and, for SDXL,
``text_encoder_2/``, each with a ``config.json`` and its weights
(``*.safetensors`` first, else ``*.bin``). The configs become the port's
``UNetConfig``/``VAEConfig``/``CLIPTextConfig`` as the JAX factory reads
them; the weights go through ``ckpt/diffusers_layout.py``'s key maps into
modules built on the meta device, so no random init runs. The UNet and VAE
take ``dtype`` (the UNet's time and add-embedding MLPs stay fp32, as
``UNet2DCondition.to_compute_dtype`` keeps them), the text encoders stay
fp32, as in the JAX factory. The repo ships no CLIP vocabulary: a
directory without ``tokenizer/`` gets ``CLIPTokenizer.tiny()``, as there;
unlike there, the ids of words added to it start past the text
encoder's table (they would be table rows otherwise).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..ckpt import safetensors_io
from ..ckpt.diffusers_layout import (clip_alias_map, clip_canonical, clip_key_map, to_port,
                                     unet_alias_map, unet_key_map, vae_alias_map, vae_key_map)
from ..utils.clip_tokenizer import CLIPTokenizer
from .clip import CLIPTextConfig, CLIPTextModel
from .layers import init_flax_like
from .unet import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig

def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """A diffusers submodel directory's weights: every ``*.safetensors``
    file, else every ``*.bin`` (a plain state dict, loaded with
    ``weights_only=True``)."""
    names = sorted(os.listdir(model_dir))
    st = [f for f in names if f.endswith('.safetensors')]
    sd: Dict[str, torch.Tensor] = {}
    if st:
        for f in st:
            sd.update(safetensors_io.load_file(os.path.join(model_dir, f)))
        return sd
    bins = [f for f in names if f.endswith('.bin')]
    if not bins:
        raise FileNotFoundError(f'no weights in {model_dir}')
    for f in bins:
        sd.update(torch.load(os.path.join(model_dir, f), map_location='cpu', weights_only=True))
    return sd


def unet_cfg_from_json(d: dict) -> UNetConfig:
    heads = d.get('num_attention_heads') or d.get('attention_head_dim', 8)
    if isinstance(heads, int):
        heads = (heads,) * len(d['block_out_channels'])
    tl = d.get('transformer_layers_per_block', 1)
    if isinstance(tl, int):
        tl = (tl,) * len(d['block_out_channels'])
    return UNetConfig(
        in_channels=d.get('in_channels', 4),
        out_channels=d.get('out_channels', 4),
        block_out_channels=tuple(d['block_out_channels']),
        down_block_types=tuple(d['down_block_types']),
        up_block_types=tuple(d['up_block_types']),
        layers_per_block=d.get('layers_per_block', 2),
        transformer_layers_per_block=tuple(tl),
        num_heads=tuple(heads),
        cross_attention_dim=d.get('cross_attention_dim', 768),
        norm_num_groups=d.get('norm_num_groups', 32),
        addition_embed_type=d.get('addition_embed_type'),
        addition_time_embed_dim=d.get('addition_time_embed_dim', 256),
        projection_class_embeddings_input_dim=d.get(
            'projection_class_embeddings_input_dim', 2816),
        qkv_bias=bool(d.get('qkv_bias', False)),
    )


def vae_cfg_from_json(d: dict) -> VAEConfig:
    return VAEConfig(
        in_channels=d.get('in_channels', 3),
        out_channels=d.get('out_channels', 3),
        latent_channels=d.get('latent_channels', 4),
        block_out_channels=tuple(d['block_out_channels']),
        layers_per_block=d.get('layers_per_block', 2),
        norm_num_groups=d.get('norm_num_groups', 32),
        scaling_factor=d.get('scaling_factor', 0.18215),
    )


def clip_cfg_from_json(d: dict) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=d.get('vocab_size', 49408),
        hidden_size=d.get('hidden_size', 768),
        intermediate_size=d.get('intermediate_size', 3072),
        num_hidden_layers=d.get('num_hidden_layers', 12),
        num_attention_heads=d.get('num_attention_heads', 12),
        max_position_embeddings=d.get('max_position_embeddings', 77),
        hidden_act=d.get('hidden_act', 'quick_gelu'),
        eos_token_id=d.get('eos_token_id', 49407),
        bos_token_id=d.get('bos_token_id', 49406),
        projection_dim=(d.get('projection_dim')
                        if d.get('architectures', [''])[0].endswith('WithProjection')
                        else None),
    )


def is_sdxl_dir(path: str) -> bool:
    """SDXL: the directory has a second text encoder."""
    return os.path.isdir(os.path.join(path, 'text_encoder_2'))


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _finish(module: torch.nn.Module) -> torch.nn.Module:
    return module.to(memory_format=torch.channels_last).eval()


def load_module(cls, cfg, key_map, sd: Dict[str, torch.Tensor], dtype: torch.dtype,
                device, what: str, fp32_prefixes=()) -> torch.nn.Module:
    """``cls(cfg)`` holding a diffusers state dict: built on the meta device
    and loaded strictly, each tensor moved to ``device`` in ``dtype`` (fp32
    for names starting with ``fp32_prefixes``)."""
    port = to_port(sd, key_map, what)
    port = {k: v.to(device=device, dtype=torch.float32 if k.startswith(fp32_prefixes) else dtype)
            for k, v in port.items()}
    with torch.device('meta'):
        module = cls(cfg)
    module.load_state_dict(port, strict=True, assign=True)
    return _finish(module)


def load_unet(model_dir: str, dtype: torch.dtype, device) -> UNet2DCondition:
    cfg = unet_cfg_from_json(_read_json(os.path.join(model_dir, 'config.json')))
    return load_module(UNet2DCondition, cfg, unet_key_map(cfg), load_state_dict(model_dir),
                       dtype, device, model_dir, UNet2DCondition.FP32_CHILDREN)


def load_vae(model_dir: str, dtype: torch.dtype, device) -> AutoencoderKL:
    cfg = vae_cfg_from_json(_read_json(os.path.join(model_dir, 'config.json')))
    return load_module(AutoencoderKL, cfg, vae_key_map(cfg), load_state_dict(model_dir),
                       dtype, device, model_dir)


def load_clip(model_dir: str, device) -> CLIPTextModel:
    cfg = clip_cfg_from_json(_read_json(os.path.join(model_dir, 'config.json')))
    return load_module(CLIPTextModel, cfg, clip_key_map(cfg),
                       clip_canonical(load_state_dict(model_dir)), torch.float32, device,
                       model_dir)


def _tiny_world(name: str, dtype: torch.dtype, device, seed: int) -> Dict[str, Any]:
    """The JAX factory's self-contained tiny worlds, with seeded flax-like
    weights (no directory needed)."""
    tk = CLIPTokenizer.tiny(words=['cat', 'dog', 'photo', 'painting'])
    ids = dict(vocab_size=tk.vocab_size, eos_token_id=tk.eos_token_id,
               bos_token_id=tk.bos_token_id)
    te_cfg = CLIPTextConfig.tiny(**ids)
    out: Dict[str, Any] = {'sdxl': name == 'tiny_sdxl'}
    if out['sdxl']:
        te2_cfg = CLIPTextConfig.tiny(hidden_size=48, num_attention_heads=4,
                                      projection_dim=48, **ids)
        unet_cfg = UNetConfig.tiny_sdxl(
            cross_attention_dim=te_cfg.hidden_size + te2_cfg.hidden_size,
            projection_class_embeddings_input_dim=8 * 6 + 48)
    else:
        te2_cfg = None
        unet_cfg = UNetConfig.tiny(cross_attention_dim=te_cfg.hidden_size)
    vae_cfg = VAEConfig.tiny()
    gen = torch.Generator().manual_seed(seed)
    unet = init_flax_like(UNet2DCondition(unet_cfg), gen).to_compute_dtype(dtype)
    out.update(unet=_finish(unet.to(device)), unet_cfg=unet_cfg,
               vae=_finish(init_flax_like(AutoencoderKL(vae_cfg), gen).to(device, dtype)),
               vae_cfg=vae_cfg, te=_finish(init_flax_like(CLIPTextModel(te_cfg), gen).to(device)),
               te_cfg=te_cfg, tokenizer=tk)
    if te2_cfg is not None:
        out.update(te2=_finish(init_flax_like(CLIPTextModel(te2_cfg), gen).to(device)),
                   te2_cfg=te2_cfg)
    return out


def build_models(pretrained: Optional[str], dtype: torch.dtype = torch.bfloat16,
                 device='cuda', seed: int = 0) -> Dict[str, Any]:
    """-> {unet, unet_cfg, vae, vae_cfg, te, te_cfg, tokenizer, sdxl,
    aliases: {unet, te, vae[, te2]}[, te2, te2_cfg]}: the JAX ``world``
    with modules in place of (module, params) pairs. ``pretrained`` is a
    diffusers-layout directory, or ``'tiny'``/``'tiny_sdxl'`` for the tiny
    configs with seeded weights; a path that is not a directory raises
    (the JAX factory would build random SD1.5 weights)."""
    if pretrained in ('tiny', 'tiny_sdxl'):
        out = _tiny_world(pretrained, dtype, device, seed)
    elif pretrained and os.path.isdir(pretrained):
        out = {'sdxl': is_sdxl_dir(pretrained)}
        unet = load_unet(os.path.join(pretrained, 'unet'), dtype, device)
        vae = load_vae(os.path.join(pretrained, 'vae'), dtype, device)
        te = load_clip(os.path.join(pretrained, 'text_encoder'), device)
        tok_dir = os.path.join(pretrained, 'tokenizer')
        tokenizer = (CLIPTokenizer.from_pretrained(tok_dir) if os.path.isdir(tok_dir)
                     else CLIPTokenizer.tiny())
        # the ids of added words (emb_dir embeddings) start past the
        # encoder's table, which the byte-level fallback's vocabulary is
        # smaller than
        tokenizer.vocab_size = max(tokenizer.vocab_size, te.cfg.vocab_size)
        out.update(unet=unet, unet_cfg=unet.cfg, vae=vae, vae_cfg=vae.cfg, te=te,
                   te_cfg=te.cfg, tokenizer=tokenizer)
        if out['sdxl']:
            te2 = load_clip(os.path.join(pretrained, 'text_encoder_2'), device)
            out.update(te2=te2, te2_cfg=te2.cfg)
    else:
        raise FileNotFoundError(f'pretrained model {pretrained!r} is not a diffusers-layout '
                                "directory (nor 'tiny'/'tiny_sdxl')")
    out['aliases'] = {'unet': unet_alias_map(out['unet_cfg']), 'te': clip_alias_map(out['te_cfg']),
                      'vae': vae_alias_map(out['vae_cfg'])}
    if 'te2_cfg' in out:
        out['aliases']['te2'] = clip_alias_map(out['te2_cfg'])
    return out
