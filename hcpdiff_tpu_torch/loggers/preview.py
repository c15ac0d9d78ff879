"""The training-time image previewer (counterpart of
``hcpdiff_tpu/loggers/preview.py``): every ``image_log_step`` steps the
Trainer samples an image from the live weights and hands it to the
loggers' ``log_image``.

``preview_dict`` assembles the pack over the frozen base as the train
step does (``trainer/assemble.py``: the UNet LoRA and ``unet_ft``, the
text-encoder LoRA and ``te_ft``, the words' rows as ``emb_ext``), casts
the assembled weights to the modules' compute dtype once, and runs
``DiffusionPipeline.txt2img`` over the trainer's modules with them in
place of the modules' own (``functional_call``) and the trainer's
``NoiseSchedule``, under ``torch.inference_mode``. Its noise comes from
the pipeline's own generator seeded by ``seed``, never from the trainer's.
The pack, the optimizer state, the modules' weights and flags and the
remat policy are left as they were; the assembled weights are freed when
it returns.

As in the JAX package, the preview takes the positive branch only
(DreamArtist's negative branch is not used) and runs no ControlNet
plugin. An SDXL (``text_time``) UNet cannot preview: the JAX previewer
gives its UNet no pooled embedding or ``time_ids`` and fails at its first
preview; this one raises when it is built.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from ..infer.pipeline import DiffusionPipeline
from ..trainer.assemble import assemble, assemble_te, make_te_apply


class _Assembled(nn.Module):
    """The UNet run with ``params`` (compute dtype) in place of its own."""

    def __init__(self, unet: nn.Module, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.unet = unet
        self.cfg = unet.cfg
        self.params = dict(params)

    def forward(self, x, t, ctx, **extra):
        return functional_call(self.unet, self.params, (x, t, ctx), extra)


class _AssembledText:
    """The trainer's text frontend with the assembled weights."""

    def __init__(self, frontend, params: Mapping[str, torch.Tensor]):
        self.frontend = frontend
        self.apply = make_te_apply(frontend)
        self.params = params

    def encode(self, texts, emb_ext=None):
        ids, mult = self.frontend.tokenize_batch(list(texts))
        device = self.frontend.model.token_embedding.device
        return self.apply(self.params, torch.from_numpy(ids).to(device),
                          torch.from_numpy(mult).to(device), emb_ext=emb_ext)


class ImagePreviewer:
    def __init__(self, trainer, prompt: str = '', negative_prompt: str = '',
                 width: int = 256, height: int = 256, num_steps: int = 20,
                 guidance_scale: float = 7.5, sampler: str = 'ddim', seed: int = 42, **kw):
        if trainer.unet.cfg.addition_embed_type == 'text_time':
            raise ValueError('the previewer cannot sample from an SDXL (text_time) UNet: its '
                             'pipeline passes no pooled text embedding or time_ids, and the JAX '
                             "package's previewer fails at its first preview the same way")
        self.trainer = trainer
        self.prompt = prompt or (trainer.cfgs.get('vis_info') or {}).get('prompt') or 'a photo'
        self.negative_prompt = negative_prompt
        self.width, self.height = int(width), int(height)
        self.num_steps = int(num_steps)
        self.guidance_scale = float(guidance_scale)
        self.sampler = sampler
        self.seed = int(seed)

    @torch.inference_mode()
    def preview_dict(self) -> Dict[str, np.ndarray]:
        """{'preview': float32 [height, width, 3] in [0, 1]}."""
        t = self.trainer
        pack = t.state.pack
        dtypes = {n: p.dtype for n, p in t.unet.named_parameters()}
        unet_p = {n: w.to(dtypes[n]) for n, w in
                  assemble(t.frozen['unet'], pack, t.lora_scales).items()}
        te_p = assemble_te(t.frozen['te'], pack, t.lora_scales)
        pipe = DiffusionPipeline(_Assembled(t.unet, unet_p), t.vae,
                                 _AssembledText(t.frontend, te_p), schedule=t.noise_schedule)
        img = pipe.txt2img(self.prompt, self.negative_prompt, width=self.width,
                           height=self.height, num_steps=self.num_steps,
                           guidance_scale=self.guidance_scale, sampler=self.sampler,
                           seed=self.seed, emb_ext=pack.get('emb'))
        return {'preview': img[0]}
