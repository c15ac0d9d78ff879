"""SDXL at full width and depth with seeded random weights, for the runs on
the card (chip_smoke.py, ``profile_txt2img --model sdxl``), beside
``random_sd15.py``: the repo ships no checkpoint and no CLIP vocabulary, so
weights follow the flax initializers (``models/layers.py:init_flax_like``)
and text goes through the byte-level tiny tokenizer, with both encoders'
BOS/EOS ids set to its own. ``sdxl_world`` gives the fp32 modules as a
``build_models`` world, which ``Trainer(cfgs, world=...)`` trains.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.compose.sdxl_te import SDXLTextEncoderFrontend
from ..models.layers import init_flax_like
from ..models.unet import UNet2DCondition, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..utils.clip_tokenizer import CLIPTokenizer


def clip_configs():
    """The byte-level tiny tokenizer, and CLIP-L (``sd15``) and bigG
    (``sdxl_big_g``) with its BOS/EOS ids."""
    tok = CLIPTokenizer.tiny()
    ids = dict(bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id)
    return tok, (dataclasses.replace(CLIPTextConfig.sd15(), **ids),
                 dataclasses.replace(CLIPTextConfig.sdxl_big_g(), **ids))


def to_bf16(m):
    """bf16 (a UNet through ``to_compute_dtype``, which keeps its fp32
    MLPs), channels_last and eval mode."""
    m = m.to_compute_dtype(torch.bfloat16) if isinstance(m, UNet2DCondition) else m.to(
        torch.bfloat16)
    return m.to(memory_format=torch.channels_last).eval()


def build_model(cls, cfg, device, gen: torch.Generator):
    """One model from the flax-like init on ``device``, then ``to_bf16``;
    the fp32 init is freed before the next model is made."""
    with device:
        return to_bf16(init_flax_like(cls(cfg), gen))


def sdxl_modules(device, seed: int):
    """The fp32 modules UNetConfig.sdxl(), VAEConfig.sdxl(), CLIP-L and
    bigG, each made from one generator seeded with ``seed`` on ``device``,
    yielded in that order, one at a time."""
    _, (cfg_l, cfg_g) = clip_configs()
    gen = torch.Generator(device=device).manual_seed(seed)
    for cls, cfg in ((UNet2DCondition, UNetConfig.sdxl()), (AutoencoderKL, VAEConfig.sdxl()),
                     (CLIPTextModel, cfg_l), (CLIPTextModel, cfg_g)):
        with device:
            yield init_flax_like(cls(cfg), gen)


def build_sdxl(device, seed: int):
    """(unet, vae, SDXL text frontend): ``sdxl_modules`` through
    ``to_bf16``, on ``device``."""
    unet, vae, te1, te2 = (to_bf16(m) for m in sdxl_modules(device, seed))
    return unet, vae, SDXLTextEncoderFrontend(clip_configs()[0], te1, te2)


def sdxl_world(device, seed: int) -> dict:
    """``sdxl_modules`` (fp32, channels_last, eval mode) as the world
    ``models/factory.py:build_models`` returns for an SDXL directory: the
    tiny tokenizer, its ``vocab_size`` lifted to the encoders' table (added
    words' ids start past it), the configs and the alias maps."""
    from ..ckpt.diffusers_layout import clip_alias_map, unet_alias_map, vae_alias_map
    tok = clip_configs()[0]
    unet, vae, te, te2 = (m.to(memory_format=torch.channels_last).eval()
                          for m in sdxl_modules(device, seed))
    tok.vocab_size = max(tok.vocab_size, te.cfg.vocab_size)
    return {'sdxl': True, 'unet': unet, 'unet_cfg': unet.cfg, 'vae': vae, 'vae_cfg': vae.cfg,
            'te': te, 'te_cfg': te.cfg, 'te2': te2, 'te2_cfg': te2.cfg, 'tokenizer': tok,
            'aliases': {'unet': unet_alias_map(unet.cfg), 'te': clip_alias_map(te.cfg),
                        'te2': clip_alias_map(te2.cfg), 'vae': vae_alias_map(vae.cfg)}}
