"""SD2.1 (768-v) at full width with seeded random weights, for the runs on
the card (chip_smoke.py), beside ``random_sd15.py``: UNetConfig.sd21()
(heads 5/10/20/20, so every head has D = 64; cross-attention over 1024
wide text), VAEConfig.sd() and CLIPTextConfig.sd2() (OpenCLIP-H's 23
layers, ``gelu``, hidden 1024), with the byte-level tiny tokenizer's
BOS/EOS ids (the repo ships no checkpoint and no CLIP vocabulary). The
weights follow the flax initializers (``models/layers.py:init_flax_like``).
SD2.1 predicts v: its requests and training take ``prediction_type:
v_prediction``.
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
    """The byte-level tiny tokenizer and CLIPTextConfig.sd2() with its
    BOS/EOS ids."""
    tok = CLIPTokenizer.tiny()
    return tok, dataclasses.replace(CLIPTextConfig.sd2(), bos_token_id=tok.bos_token_id,
                                    eos_token_id=tok.eos_token_id)


def sd21_modules(device, seed: int):
    """The fp32 modules UNetConfig.sd21(), VAEConfig.sd() and CLIP, each
    made from one generator seeded with ``seed`` on ``device``, yielded in
    that order, one at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for cls, cfg in ((UNet2DCondition, UNetConfig.sd21()), (AutoencoderKL, VAEConfig.sd()),
                     (CLIPTextModel, clip_config()[1])):
        with device:
            yield init_flax_like(cls(cfg), gen)


def build_sd21(device, seed: int):
    """(unet, vae, text frontend): ``sd21_modules`` in bf16, channels_last,
    in eval mode, on ``device``."""
    unet, vae, clip = (m.to(torch.bfloat16).to(memory_format=torch.channels_last).eval()
                       for m in sd21_modules(device, seed))
    return unet, vae, TextEncoderFrontend(clip_config()[0], clip)
