"""SD1.5 at full width with seeded random weights, for the runs on the card
(chip_smoke.py, ``profile_txt2img``): the repo ships no checkpoint and no
CLIP vocabulary, so weights follow the flax initializers
(``models/layers.py:init_flax_like``) and text goes through the byte-level
tiny tokenizer with CLIP's BOS/EOS ids set to its own.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.layers import init_flax_like
from ..models.text_frontend import TextEncoderFrontend
from ..models.unet import UNet2DCondition, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..utils.clip_tokenizer import CLIPTokenizer


def clip_config():
    """The byte-level tiny tokenizer and CLIPTextConfig.sd15() with its
    BOS/EOS ids."""
    tok = CLIPTokenizer.tiny()
    return tok, dataclasses.replace(CLIPTextConfig.sd15(), bos_token_id=tok.bos_token_id,
                                    eos_token_id=tok.eos_token_id)


def sd15_modules(device, seed: int):
    """The fp32 modules UNetConfig.sd15(), VAEConfig.sd() and CLIP, each
    made from one generator seeded with ``seed`` on ``device``, yielded in
    that order, one at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for cls, cfg in ((UNet2DCondition, UNetConfig.sd15()), (AutoencoderKL, VAEConfig.sd()),
                     (CLIPTextModel, clip_config()[1])):
        with device:
            yield init_flax_like(cls(cfg), gen)


def build_sd15(device, seed: int):
    """(unet, vae, text frontend): ``sd15_modules`` in bf16, channels_last,
    in eval mode, on ``device``."""
    unet, vae, clip = (m.to(torch.bfloat16).to(memory_format=torch.channels_last).eval()
                       for m in sd15_modules(device, seed))
    return unet, vae, TextEncoderFrontend(clip_config()[0], clip)


def fused_copy(unet: UNet2DCondition, device) -> UNet2DCondition:
    """A ``fused_sublayers=True`` UNet of ``unet``'s config holding its
    weights (the parameter names are the same in both configurations)."""
    with device:
        fused = UNet2DCondition(unet.cfg, fused_sublayers=True)
    fused = fused.to(torch.bfloat16).to(memory_format=torch.channels_last).eval()
    fused.load_state_dict(unet.state_dict(), strict=True)
    return fused
