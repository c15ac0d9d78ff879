"""Inference pipeline: the CFG denoise loop, txt2img, img2img, inpaint and
the VAE codecs (counterpart of ``hcpdiff_tpu/infer/pipeline.py``).

The JAX package compiles the whole loop into one ``lax.scan``; here it is
an eager Python loop of UNet calls and sampler steps, with classifier-free
guidance run as one doubled batch (negative prompts first). Latents are
fp32 NHWC tensors on the models' device. When the UNet's
``addition_embed_type`` is ``'text_time'`` (SDXL) every UNet call also
takes the pooled text embedding and the size/crop ``time_ids``,
CFG-doubled as the context. All random numbers (initial latents, the
img2img noise, the stochastic samplers' noise) come from one CPU
``torch.Generator`` seeded with the request's seed, so one seed gives one
image on any device; they differ from the JAX package's ``jax.random``
draws.

DreamArtist's negative branch (``DiffusionPipeline.unet_params_neg``, a
dict of the weights that differ from the UNet's own) runs the txt2img
loop's negative half through ``torch.func.functional_call`` with those
weights and the positive half with the UNet's: two UNet calls of batch B
a step in place of one of 2B. ``emb_ext`` (prompt-tuning rows) reaches
the text encoders.

ControlNet plugins (``DiffusionPipeline.plugins``, (ControlNet, scale)
pairs) run beside every UNet call that gets a condition image: txt2img's,
img2img's (and so the legacy inpaint's) and both of DreamArtist's; each
plugin's residuals, times its scale, are summed into the UNet's
``down_residuals`` and ``mid_residual`` (the JAX Visualizer's UNet
callable). ``cond`` [B, H, W, 3] in [0, 1] is CFG-doubled as the context.

``deep_cache_interval`` N > 1 (txt2img) is DeepCache: at step i a full
UNet call that also returns the deep feature when i % N == 0, else a call
that reuses the cached one and runs only the UNet's first down level and
last up level (the JAX ``lax.cond`` of ``hcpdiff_tpu/infer/pipeline.py``,
made eager). It changes the output (slightly), and refuses a negative
branch. ``use_encoder_attention_mask`` gives txt2img's UNet calls the
prompts' padding mask (``encoder_attention_mask``), CFG-doubled as the
context, where the text frontend has ``attention_mask``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torch.func import functional_call

from ..diffusion.samplers import BaseSampler, make_sampler
from ..diffusion.schedules import NoiseSchedule
from ..models.compose.sdxl_te import make_sdxl_time_ids
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL


def _half(extra_cond: Optional[Dict[str, torch.Tensor]], B: int, idx: int):
    """One CFG half of CFG-doubled conditioning: the tensors of 2B rows
    split, the rest as they are."""
    return {k: (v.chunk(2)[idx] if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == 2 * B
                else v) for k, v in (extra_cond or {}).items()}


class DenoiseLoop:
    """CFG denoise loop for one sampler setting. ``unet`` is the UNet or
    any callable ``(x, t, ctx, **extra_cond) -> out`` (the 9-channel
    inpaint UNet's channel join); ``unet_neg``, a callable alike, runs the
    negative half of a CFG step (DreamArtist's negative branch) while
    ``unet`` runs the positive half. ``deep_cache_interval`` N > 1: every
    Nth step (from step 0) is a full UNet call that also returns its deep
    feature (``return_deep``), the others reuse it (``deep_cache``); the
    feature is kept in the UNet's compute dtype, as it returns it."""

    def __init__(self, unet: Callable, sampler: BaseSampler, return_x0: bool = False,
                 unet_neg: Optional[Callable] = None, deep_cache_interval: int = 0):
        self.unet = unet
        self.sampler = sampler
        self.return_x0 = return_x0
        self.unet_neg = unet_neg
        self.deep_cache_interval = int(deep_cache_interval)
        if self.deep_cache_interval > 1 and unet_neg is not None:
            raise ValueError('deep_cache_interval is incompatible with the DreamArtist '
                             'dual-branch loop')
        self._deep: Optional[torch.Tensor] = None

    def _model(self, i: int, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
               extra: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One UNet call of step ``i``: exact, or DeepCache's full or reuse call."""
        n = self.deep_cache_interval
        if n <= 1:
            return self.unet(x, t, ctx, **extra)
        if i % n == 0:
            out, self._deep = self.unet(x, t, ctx, return_deep=True, **extra)
            return out
        if self._deep is None:
            raise ValueError(f'DeepCache step {i} has no cached feature: the loop starts '
                             f'at a step divisible by {n}')
        return self.unet(x, t, ctx, deep_cache=self._deep, **extra)

    def step(self, i: int, latents: torch.Tensor, state, ctx: torch.Tensor,
             guidance_scale: float, cfg_batch: bool = True,
             extra_cond: Optional[Dict[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None):
        """One step: (latents, state) -> (latents, state, x0 prediction).
        ``ctx`` is [2B, S, D] (negative then positive) when ``cfg_batch``;
        ``extra_cond`` holds further UNet keyword arguments, CFG-doubled
        as ``ctx`` (SDXL's pooled_text_emb and time_ids); ``generator``
        feeds a stochastic sampler's noise."""
        sampler = self.sampler
        x_in = sampler.scale_model_input(state, latents, i)
        B = x_in.shape[0]
        ts = int(sampler.timesteps[i])
        if cfg_batch and self.unet_neg is not None:
            ctx_n, ctx_p = ctx.chunk(2)
            t = torch.full((B,), ts, device=latents.device)
            e_neg = self.unet_neg(x_in, t, ctx_n, **_half(extra_cond, B, 0))
            e_pos = self.unet(x_in, t, ctx_p, **_half(extra_cond, B, 1))
            out = e_neg + guidance_scale * (e_pos - e_neg)
            return sampler.step(state, out, i, latents, generator)
        if cfg_batch:
            x_in = torch.cat([x_in, x_in])
        t = torch.full((x_in.shape[0],), ts, device=latents.device)
        out = self._model(i, x_in, t, ctx, extra_cond or {})
        if cfg_batch:
            e_neg, e_pos = out.chunk(2)
            out = e_neg + guidance_scale * (e_pos - e_neg)
        return sampler.step(state, out, i, latents, generator)

    @torch.inference_mode()
    def __call__(self, latents: torch.Tensor, ctx: torch.Tensor, guidance_scale: float,
                 cfg_batch: bool = True, extra_cond: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns the final latents and, when ``return_x0``, the x0
        prediction of every step stacked as [steps, B, h, w, C]. The
        latents are scaled by the sampler's ``init_noise_sigma`` first."""
        latents = latents.float() * self.sampler.init_noise_sigma
        state = self.sampler.init_state(latents.shape)
        self._deep = None
        x0s = []
        for i in range(self.sampler.num_steps):
            latents, state, x0 = self.step(i, latents, state, ctx, guidance_scale, cfg_batch,
                                           extra_cond, generator)
            if self.return_x0:
                x0s.append(x0)
        self._deep = None
        return latents, (torch.stack(x0s) if x0s else None)


def _batch(prompt, negative_prompt, batch_size: int) -> Tuple[list, list]:
    prompts = [prompt] * batch_size if isinstance(prompt, str) else list(prompt)
    negs = ([negative_prompt] * len(prompts) if isinstance(negative_prompt, str)
            else list(negative_prompt))
    return prompts, negs


class DiffusionPipeline:
    """txt2img, img2img and inpaint over (unet, vae, text frontend). The
    frontend's ``encode`` returns (hidden, pooled):
    ``models.text_frontend.TextEncoderFrontend``, or, for a ``text_time``
    UNet, SDXL's ``models.compose.sdxl_te.SDXLTextEncoderFrontend``."""

    def __init__(self, unet: UNet2DCondition, vae: AutoencoderKL, te_frontend,
                 schedule: Optional[NoiseSchedule] = None):
        self.text_time = unet.cfg.addition_embed_type == 'text_time'
        self.unet = unet
        self.vae = vae
        self.te = te_frontend
        self.schedule = schedule or NoiseSchedule.make()
        # DreamArtist's negative branch: {state-dict name: tensor} in place
        # of the UNet's own for the negative half of txt2img's CFG
        self.unet_params_neg: Optional[Dict[str, torch.Tensor]] = None
        # txt2img's UNet calls take the prompts' padding mask
        self.use_encoder_attention_mask = False
        # ControlNet plugins: (module, scale), run where a call has ``cond``
        self.plugins: List[Tuple[torch.nn.Module, float]] = []

    def _with_taps(self, unet: Callable) -> Callable:
        """``unet`` taking ``cond``: with plugins, each ControlNet runs on
        the call's (x, t, ctx, cond) and the sums of their scaled residuals
        go in as the UNet's taps; without, ``cond`` is dropped."""
        def call(x, t, ctx, cond=None, **e):
            if cond is not None and self.plugins:
                down, mid = None, None
                for net, scale in self.plugins:
                    d, m = net(x, t, ctx, cond, conditioning_scale=scale)
                    down = d if down is None else [a + b for a, b in zip(down, d)]
                    mid = m if mid is None else mid + m
                e = dict(e, down_residuals=down, mid_residual=mid)
            return unet(x, t, ctx, **e)
        return call

    def _unet_neg(self) -> Optional[Callable]:
        if self.unet_params_neg is None:
            return None
        return self._with_taps(lambda x, t, ctx, **e: functional_call(
            self.unet, self.unet_params_neg, (x, t, ctx), e))

    def _cond(self, extra_cond, cond: Optional[torch.Tensor], rows: int):
        """``extra_cond`` with the condition image repeated to ``rows``
        (the context's rows: CFG-doubled)."""
        if cond is None:
            return extra_cond
        cond = torch.as_tensor(cond, dtype=torch.float32).to(self.device)
        return dict(extra_cond or {}, cond=cond.repeat(rows // cond.shape[0], 1, 1, 1))

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @property
    def vae_scale(self) -> int:
        return 2 ** (len(self.vae.cfg.block_out_channels) - 1)

    def encode_prompts(self, prompts: Sequence[str], negative_prompts: Sequence[str],
                       emb_ext=None):
        """One text-encoder pass for negative + positive prompts."""
        return self.te.encode(list(negative_prompts) + list(prompts), emb_ext=emb_ext)

    def _ctx_mask(self, texts: Sequence[str]) -> Optional[torch.Tensor]:
        """The padding mask of ``texts`` (in the context's row order) when
        ``use_encoder_attention_mask`` and the frontend gives one."""
        if not (self.use_encoder_attention_mask and hasattr(self.te, 'attention_mask')):
            return None
        ids, _ = self.te.tokenize_batch(list(texts))
        return torch.from_numpy(self.te.attention_mask(ids)).to(self.device)

    def _extra_cond(self, pooled: torch.Tensor, rows: int, width: int, height: int):
        """A text_time UNet's conditioning for ``rows`` UNet rows; None for
        other UNets."""
        if not self.text_time:
            return None
        tid = torch.from_numpy(make_sdxl_time_ids((width, height), (0, 0), (width, height)))
        return {'pooled_text_emb': pooled, 'time_ids': tid.to(self.device).repeat(rows, 1)}

    @torch.inference_mode()
    def txt2img(self, prompt, negative_prompt='', width: int = 512, height: int = 512,
                num_steps: int = 20, guidance_scale: float = 7.5, sampler: str = 'dpm++_2m',
                seed: int = 0, batch_size: int = 1, sampler_kwargs: Optional[dict] = None,
                return_latents: bool = False, return_x0_history: bool = False,
                emb_ext=None, deep_cache_interval: int = 0,
                cond: Optional[torch.Tensor] = None):
        """Returns images as a float32 numpy array [B, height, width, 3] in
        [0, 1], or the final latents when ``return_latents``; with
        ``return_x0_history`` a pair whose second item is every step's x0
        prediction [steps, B, h, w, C]. The initial noise is drawn on the
        CPU from ``seed``, so it does not depend on the device. For a
        ``text_time`` UNet every UNet call also gets the pooled embeddings
        and ``time_ids = [height, width, 0, 0, height, width]``, in the
        context's rows. CFG runs whenever ``guidance_scale`` > 1 or a
        negative branch is set. ``deep_cache_interval`` > 1 runs DeepCache
        (``DenoiseLoop``). ``cond``: the plugins' condition image."""
        prompts, negs = _batch(prompt, negative_prompt, batch_size)
        B = len(prompts)
        use_cfg = float(guidance_scale) > 1.0 or self.unet_params_neg is not None
        negs = negs if use_cfg else []
        ctx, pooled = self.encode_prompts(prompts, negs, emb_ext)
        extra_cond = self._extra_cond(pooled, ctx.shape[0], width, height)
        mask = self._ctx_mask(negs + prompts)
        if mask is not None:
            extra_cond = dict(extra_cond or {}, encoder_attention_mask=mask)
        extra_cond = self._cond(extra_cond, cond, ctx.shape[0])
        gen = torch.Generator().manual_seed(int(seed))
        latents = torch.randn((B, height // self.vae_scale, width // self.vae_scale,
                               self.vae.cfg.latent_channels), generator=gen)
        loop = DenoiseLoop(self._with_taps(self.unet),
                           make_sampler(sampler, self.schedule, num_steps,
                                                   **(sampler_kwargs or {})),
                           return_x0=return_x0_history, unet_neg=self._unet_neg(),
                           deep_cache_interval=deep_cache_interval)
        latents, x0s = loop(latents.to(self.device), ctx, float(guidance_scale),
                            cfg_batch=use_cfg, extra_cond=extra_cond, generator=gen)
        out = latents if return_latents else self.decode(latents)
        return (out, x0s) if return_x0_history else out

    @torch.inference_mode()
    def img2img(self, init_latents: torch.Tensor, prompt, negative_prompt='',
                strength: float = 0.75, num_steps: int = 20, guidance_scale: float = 7.5,
                sampler: str = 'dpm++_2m', seed: int = 0, return_latents: bool = False,
                sampler_kwargs: Optional[dict] = None, noise: Optional[torch.Tensor] = None,
                emb_ext=None, cond: Optional[torch.Tensor] = None):
        """``init_latents``: [B, h, w, C] scaled latents (``encode`` makes
        them). The plan is cut at ``t_start = steps - int(steps * strength)``
        (``slice_for_partial``), the latents are noised to the cut's first
        timestep with ``noise`` (drawn from ``seed`` when None) and the
        partial loop runs with CFG (without a negative branch, as in the JAX
        package), the plugins taking ``cond``. No further scaling: the
        loop's ``init_noise_sigma`` is the VP to k-space change of
        variables."""
        init_latents = torch.as_tensor(init_latents).to(self.device, torch.float32)
        B, h, w, _ = init_latents.shape
        prompts, negs = _batch(prompt, negative_prompt, B)
        ctx, pooled = self.encode_prompts(prompts, negs, emb_ext)
        extra_cond = self._extra_cond(pooled, ctx.shape[0], w * self.vae_scale,
                                      h * self.vae_scale)
        t_start = max(num_steps - int(num_steps * strength), 0)
        sampler_obj = make_sampler(sampler, self.schedule, num_steps, **(sampler_kwargs or {}))
        t0 = sampler_obj.slice_for_partial(t_start)
        gen = torch.Generator().manual_seed(int(seed))
        if noise is None:
            noise = torch.randn(tuple(init_latents.shape), generator=gen)
        noised = self.schedule.add_noise(init_latents, noise.to(init_latents),
                                         torch.full((B,), t0, dtype=torch.long))
        extra_cond = self._cond(extra_cond, cond, ctx.shape[0])
        latents, _ = DenoiseLoop(self._with_taps(self.unet), sampler_obj)(
            noised, ctx, float(guidance_scale), extra_cond=extra_cond, generator=gen)
        return latents if return_latents else self.decode(latents)

    @torch.inference_mode()
    def inpaint(self, init_latents: torch.Tensor, mask_latent: torch.Tensor, prompt,
                negative_prompt='', strength: float = 0.75, inpaint_model: bool = False,
                num_steps: int = 20, guidance_scale: float = 7.5, sampler: str = 'dpm++_2m',
                seed: int = 0, sampler_kwargs: Optional[dict] = None,
                noise: Optional[torch.Tensor] = None, emb_ext=None,
                cond: Optional[torch.Tensor] = None) -> np.ndarray:
        """Inpainting; ``mask_latent`` [B, h, w, 1], 1 = the region to paint.

        - ``inpaint_model``: a 9-channel inpaint UNet runs the whole plan
          from noise (``noise``, drawn from ``seed`` when None) with
          [mask, masked latents] joined to its input channels, CFG-doubled;
          ``strength`` and ``sampler_kwargs`` are not used, as in the JAX
          package;
        - otherwise: img2img on the full latents (``noise`` is its noise,
          ``cond`` its plugins' condition), then the kept region is blended
          back before decoding; the inpaint model's loop takes no
          ``cond``, as in the JAX package."""
        init_latents = torch.as_tensor(init_latents).to(self.device, torch.float32)
        mask_latent = torch.as_tensor(mask_latent).to(self.device, torch.float32)
        if not inpaint_model:
            out = self.img2img(init_latents, prompt, negative_prompt, strength=strength,
                               num_steps=num_steps, guidance_scale=guidance_scale,
                               sampler=sampler, seed=seed, return_latents=True,
                               sampler_kwargs=sampler_kwargs, noise=noise, emb_ext=emb_ext,
                               cond=cond)
            return self.decode(mask_latent * out + (1 - mask_latent) * init_latents)
        B = init_latents.shape[0]
        extra = torch.cat([mask_latent, init_latents * (1 - mask_latent)], dim=-1)
        extra2 = torch.cat([extra, extra])                   # CFG-doubled

        def unet_with_cond(x, t, ctx, **e):
            n = extra2 if x.shape[0] == 2 * B else extra
            return self.unet(torch.cat([x, n.to(x.dtype)], dim=-1), t, ctx, **e)

        prompts, negs = _batch(prompt, negative_prompt, B)
        ctx, pooled = self.encode_prompts(prompts, negs, emb_ext)
        h, w = init_latents.shape[1:3]
        extra_cond = self._extra_cond(pooled, ctx.shape[0], w * self.vae_scale,
                                      h * self.vae_scale)
        gen = torch.Generator().manual_seed(int(seed))
        if noise is None:
            noise = torch.randn(tuple(init_latents.shape), generator=gen)
        loop = DenoiseLoop(unet_with_cond, make_sampler(sampler, self.schedule, num_steps))
        out, _ = loop(noise.to(init_latents), ctx, float(guidance_scale),
                      extra_cond=extra_cond, generator=gen)
        return self.decode(out)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> np.ndarray:
        img = self.vae.decode(latents / self.vae.cfg.scaling_factor)
        return (img * 0.5 + 0.5).clamp(0, 1).cpu().numpy()

    @torch.inference_mode()
    def encode(self, images, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images [B, H, W, 3] in [-1, 1] -> scaled latents [B, H/8, W/8, C]
        on the VAE's device: the posterior's mean, or a sample of it drawn
        on the CPU from ``generator``."""
        images = torch.as_tensor(images).to(self.device)
        mean, logvar = self.vae.encode(images)
        z = mean
        if generator is not None:
            eps = torch.randn(tuple(mean.shape), generator=generator).to(mean.device)
            z = mean + torch.exp(0.5 * logvar) * eps
        return z * self.vae.cfg.scaling_factor
