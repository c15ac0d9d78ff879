"""Inference pipeline: the CFG denoise loop and txt2img (counterpart of
``hcpdiff_tpu/infer/pipeline.py``).

The JAX package compiles the whole loop into one ``lax.scan``; here it is
an eager Python loop of UNet calls and sampler steps, with classifier-free
guidance run as one doubled batch (negative prompts first). Latents are
fp32 NHWC tensors on the models' device. When the UNet's
``addition_embed_type`` is ``'text_time'`` (SDXL) every UNet call also
takes the pooled text embedding and the size/crop ``time_ids``,
CFG-doubled as the context.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diffusion.samplers import BaseSampler, make_sampler
from ..diffusion.schedules import NoiseSchedule
from ..models.compose.sdxl_te import make_sdxl_time_ids
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL


class DenoiseLoop:
    """CFG denoise loop for one sampler setting."""

    def __init__(self, unet: UNet2DCondition, sampler: BaseSampler, return_x0: bool = False):
        self.unet = unet
        self.sampler = sampler
        self.return_x0 = return_x0

    def step(self, i: int, latents: torch.Tensor, state, ctx: torch.Tensor,
             guidance_scale: float, cfg_batch: bool = True,
             extra_cond: Optional[Dict[str, torch.Tensor]] = None):
        """One step: (latents, state) -> (latents, state, x0 prediction).
        ``ctx`` is [2B, S, D] (negative then positive) when ``cfg_batch``;
        ``extra_cond`` holds further UNet keyword arguments, CFG-doubled
        as ``ctx`` (SDXL's pooled_text_emb and time_ids)."""
        sampler = self.sampler
        x_in = sampler.scale_model_input(state, latents, i)
        if cfg_batch:
            x_in = torch.cat([x_in, x_in])
        t = torch.full((x_in.shape[0],), int(sampler.timesteps[i]), device=latents.device)
        out = self.unet(x_in, t, ctx, **(extra_cond or {}))
        if cfg_batch:
            e_neg, e_pos = out.chunk(2)
            out = e_neg + guidance_scale * (e_pos - e_neg)
        return sampler.step(state, out, i, latents)

    @torch.inference_mode()
    def __call__(self, latents: torch.Tensor, ctx: torch.Tensor, guidance_scale: float,
                 cfg_batch: bool = True, extra_cond: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns the final latents and, when ``return_x0``, the x0
        prediction of every step stacked as [steps, B, h, w, C]."""
        latents = latents.float() * self.sampler.init_noise_sigma
        state = self.sampler.init_state(latents.shape)
        x0s = []
        for i in range(self.sampler.num_steps):
            latents, state, x0 = self.step(i, latents, state, ctx, guidance_scale, cfg_batch,
                                           extra_cond)
            if self.return_x0:
                x0s.append(x0)
        return latents, (torch.stack(x0s) if x0s else None)


class DiffusionPipeline:
    """txt2img over (unet, vae, text frontend). The frontend's ``encode``
    returns (hidden, pooled): ``models.text_frontend.TextEncoderFrontend``,
    or, for a ``text_time`` UNet, SDXL's
    ``models.compose.sdxl_te.SDXLTextEncoderFrontend``."""

    def __init__(self, unet: UNet2DCondition, vae: AutoencoderKL, te_frontend,
                 schedule: Optional[NoiseSchedule] = None):
        self.text_time = unet.cfg.addition_embed_type == 'text_time'
        self.unet = unet
        self.vae = vae
        self.te = te_frontend
        self.schedule = schedule or NoiseSchedule.make()

    def encode_prompts(self, prompts: Sequence[str], negative_prompts: Sequence[str]):
        """One text-encoder pass for negative + positive prompts."""
        return self.te.encode(list(negative_prompts) + list(prompts))

    @torch.inference_mode()
    def txt2img(self, prompt, negative_prompt='', width: int = 512, height: int = 512,
                num_steps: int = 20, guidance_scale: float = 7.5, sampler: str = 'dpm++_2m',
                seed: int = 0, batch_size: int = 1, sampler_kwargs: Optional[dict] = None,
                return_latents: bool = False):
        """Returns images as a float32 numpy array [B, height, width, 3] in
        [0, 1], or the final latents when ``return_latents``. The initial
        noise is drawn on the CPU from ``seed``, so it does not depend on
        the device. For a ``text_time`` UNet every UNet call also gets the
        pooled embeddings and ``time_ids = [height, width, 0, 0, height,
        width]``, in the context's rows."""
        prompts = [prompt] * batch_size if isinstance(prompt, str) else list(prompt)
        negs = ([negative_prompt] * len(prompts) if isinstance(negative_prompt, str)
                else list(negative_prompt))
        B = len(prompts)
        use_cfg = float(guidance_scale) > 1.0
        ctx, pooled = self.encode_prompts(prompts, negs if use_cfg else [])
        device = next(self.unet.parameters()).device
        extra_cond = None
        if self.text_time:
            tid = torch.from_numpy(make_sdxl_time_ids((width, height), (0, 0),
                                                      (width, height))).to(device)
            extra_cond = {'pooled_text_emb': pooled, 'time_ids': tid.repeat(ctx.shape[0], 1)}
        vae_scale = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        gen = torch.Generator().manual_seed(int(seed))
        latents = torch.randn((B, height // vae_scale, width // vae_scale,
                               self.vae.cfg.latent_channels), generator=gen)
        loop = DenoiseLoop(self.unet, make_sampler(sampler, self.schedule, num_steps,
                                                   **(sampler_kwargs or {})))
        latents, _ = loop(latents.to(device), ctx, float(guidance_scale), cfg_batch=use_cfg,
                          extra_cond=extra_cond)
        if return_latents:
            return latents
        return self.decode(latents)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> np.ndarray:
        img = self.vae.decode(latents / self.vae.cfg.scaling_factor)
        return (img * 0.5 + 0.5).clamp(0, 1).cpu().numpy()
