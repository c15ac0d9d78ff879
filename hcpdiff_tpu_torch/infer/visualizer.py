"""Config-driven inference: the ``Visualizer`` entry point (counterpart of
``hcpdiff_tpu/infer/visualizer.py``).

    python -m hcpdiff_tpu_torch.visualizer --cfg cfgs/infer/text2img.yaml \\
        pretrained_model=DIR [key=value ...]

A config (``_base_`` chains, dotlist overrides, ``${...}``) names a local
diffusers-layout directory, the sampler (or a diffusers scheduler class
under ``new_components.scheduler``, mapped by name), the mode (t2i, i2i,
inpaint) and the interfaces that write the images. It runs on the card
unless the config says ``device: cpu``; with no card it raises. ``dtype``
fp16, bf16 and amp mean bf16 (the kernels take bf16 and fp32), anything
else fp32.

The configs' class names (``hcpdiff_tpu.infer.interfaces.DiskInterface``,
``diffusers.EulerAncestralDiscreteScheduler``) are read as names, never
imported. What the JAX Visualizer does beyond this is not ported yet and
raises ``NotImplementedError`` rather than being ignored: a ``merge``
block (LoRA and part merges, DreamArtist's negative branch, plugins), an
``emb_dir`` holding ``.pt`` embeddings, DeepCache, ControlNet conditions
(``ex_input.cond``), ``encoder_attention_mask``, ``save_model``, and
SDXL text-encoder settings other than SDXL's own.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Cfg, load, to_plain
from ..config.legacy import InferCFGConverter
from ..diffusion.schedules import NoiseSchedule
from ..models.compose.sdxl_te import SDXLTextEncoderFrontend
from ..models.factory import build_models, load_vae
from ..models.text_frontend import TextEncoderFrontend
from ..utils.images import load_image, load_mask
from .interfaces import (BaseInterface, DiskAnimInterface, DiskInterface,
                         WebUIInterface)
from .pipeline import DiffusionPipeline

ROADMAP = 'ROADMAP.md queue 1 item 5'


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f'{what} is not ported to the PyTorch package yet ({ROADMAP})')


def _refuse_unported(cfgs: Cfg) -> None:
    """Raise on every config feature of the JAX Visualizer that the port
    does not run yet."""
    mcfg = cfgs.get('model') or Cfg()
    if cfgs.get('merge'):
        raise _unported('the merge block (LoRA/part merges, DreamArtist, plugins)')
    emb_dir = cfgs.get('emb_dir') or mcfg.get('emb_dir')
    if emb_dir and os.path.isdir(emb_dir) and any(f.endswith('.pt')
                                                   for f in os.listdir(emb_dir)):
        raise _unported(f'loading embeddings from emb_dir {emb_dir!r}')
    if (cfgs.get('infer_args') or {}).get('deep_cache_interval'):
        raise _unported('infer_args.deep_cache_interval (DeepCache)')
    if (cfgs.get('ex_input') or {}).get('cond') is not None:
        raise _unported('ex_input.cond (ControlNet)')
    if cfgs.get('encoder_attention_mask'):
        raise _unported('encoder_attention_mask')
    if cfgs.get('save_model'):
        raise _unported('save_model')


class Visualizer:
    # diffusers scheduler class -> sampler name; longer, more specific
    # fragments first (kdpm2ancestral before kdpm2, dpmsolversde before
    # dpmsolver...)
    _SCHED_MAP = {'eulerancestral': 'euler_a', 'eulerdiscrete': 'euler',
                  'dpmsolversde': 'dpm++_sde',
                  'dpmsolversinglestep': 'dpm++_sde',
                  'dpmsolvermultistep': 'dpm++_2m', 'unipcmultistep': 'unipc',
                  'kdpm2ancestral': 'dpm2_a', 'kdpm2': 'dpm2',
                  'heun': 'heun', 'lms': 'lms', 'deis': 'deis',
                  'pndm': 'pndm', 'ddim': 'ddim', 'ddpm': 'ddpm'}

    def __init__(self, cfgs: Cfg):
        cfgs = InferCFGConverter().convert(cfgs)
        self.cfgs = cfgs
        _refuse_unported(cfgs)
        mcfg = cfgs.get('model') or Cfg()
        self.device = torch.device(str(cfgs.get('device', 'cuda')))
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('the Visualizer runs on a CUDA card and none is present; '
                               'ask for the CPU with device=cpu')
        self.dtype = (torch.bfloat16 if str(cfgs.get('dtype', 'bf16')) in ('fp16', 'bf16', 'amp')
                      else torch.float32)
        world = build_models(cfgs.get('pretrained_model')
                             or mcfg.get('pretrained_model_name_or_path'),
                             dtype=self.dtype, device=self.device)
        self.world = world
        self.schedule = NoiseSchedule.make()
        self._apply_new_components(cfgs.get('new_components'))

        self.sdxl = bool(world['sdxl'])
        if self.sdxl:
            asked = (int(mcfg.get('tokenizer_repeats', 1)), int(mcfg.get('clip_skip', 1)),
                     bool(mcfg.get('clip_final_norm', False)))
            if asked != (1, 1, False):
                raise _unported(f'SDXL text encoding with (tokenizer_repeats, clip_skip, '
                                f'clip_final_norm) = {asked} (SDXL runs (1, 1, False))')
            self.frontend = SDXLTextEncoderFrontend(world['tokenizer'], world['te'],
                                                    world['te2'])
        else:
            self.frontend = TextEncoderFrontend(
                world['tokenizer'], world['te'],
                n_repeats=int(mcfg.get('tokenizer_repeats', 1)),
                clip_skip=int(mcfg.get('clip_skip', 0)),
                clip_final_norm=bool(mcfg.get('clip_final_norm', True)))
        self.pipe = DiffusionPipeline(world['unet'], world['vae'], self.frontend,
                                      schedule=self.schedule)
        self.last_latents: Optional[torch.Tensor] = None
        self.interfaces: List[BaseInterface] = [self._interface(item)
                                                for item in (cfgs.get('interface') or [])]
        if not self.interfaces:
            self.interfaces = [DiskInterface(cfgs.get('output_dir', 'output/'))]

    @staticmethod
    def _interface(item) -> BaseInterface:
        """An interface chosen by a substring of its ``_target_``, as the JAX
        Visualizer chooses it (the class is not imported)."""
        spec = dict(item)
        tgt = str(spec.pop('_target_', 'disk')).lower()
        kwargs = dict(save_root=spec.get('save_root', 'output/'),
                      image_type=spec.get('image_type', 'png'))
        if 'anim' in tgt or spec.get('show_steps'):
            return DiskAnimInterface(**kwargs)
        if 'webui' in tgt:
            return WebUIInterface()
        if 'disk' in tgt:
            return DiskInterface(**kwargs)
        raise _unported(f'the interface {item.get("_target_")!r}')

    def _apply_new_components(self, nc) -> None:
        """The ``new_components`` block: a diffusers scheduler class becomes
        a sampler name (and its beta and prediction settings a schedule),
        a ``vae`` directory replaces the VAE."""
        if not nc:
            return
        sch = nc.get('scheduler')
        if sch:
            tgt = str(sch.get('_target_', '')).lower().replace('discretescheduler', 'discrete')
            for key, name in self._SCHED_MAP.items():
                if key in tgt or key.replace('discrete', '') in tgt:
                    # DPMSolverMultistep with algorithm_type sde-dpmsolver++
                    # is the 'DPM++ 2M SDE' sampler
                    if name == 'dpm++_2m' and 'sde' in str(
                            sch.get('algorithm_type', '')).lower():
                        name = 'dpm++_2m_sde'
                    ia = self.cfgs.get('infer_args') or Cfg()
                    ia['sampler'] = name
                    if key == 'dpmsolversinglestep':
                        # deterministic singlestep 2S = DPM++ SDE at eta=0
                        ia['sampler_kwargs'] = dict(ia.get('sampler_kwargs') or {}, eta=0.0)
                    if sch.get('use_karras_sigmas'):
                        ia['sampler_kwargs'] = dict(ia.get('sampler_kwargs') or {},
                                                    use_karras_sigmas=True)
                    self.cfgs['infer_args'] = ia
                    break
            else:
                raise ValueError(
                    f'new_components.scheduler {sch.get("_target_")!r} has '
                    'no sampler mapping; supported: '
                    + ', '.join(sorted(set(self._SCHED_MAP.values()))))
            kw = {k: sch[k] for k in ('beta_start', 'beta_end', 'beta_schedule',
                                      'prediction_type') if k in sch}
            if kw:
                self.schedule = NoiseSchedule.make(**kw)
        vae_cfg = nc.get('vae')
        if vae_cfg:
            path = vae_cfg.get('pretrained_model_name_or_path')
            if not (path and os.path.isdir(path)):
                raise FileNotFoundError(f'new_components.vae: {path!r} is not a directory')
            sub = os.path.join(path, 'vae') if os.path.isdir(os.path.join(path, 'vae')) else path
            vae = load_vae(sub, self.dtype, self.device)
            self.world.update(vae=vae, vae_cfg=vae.cfg)

    def vis_images(self, prompt, negative_prompt='', **kw):
        """One request under ``infer_args`` (``kw`` overrides them) ->
        images float32 [B, H, W, 3] in [0, 1] (and, for txt2img with
        ``return_x0_history``, every step's x0 prediction)."""
        ia = dict(self.cfgs.get('infer_args') or {})
        ia.update(kw)
        seed = ia.pop('seed', self.cfgs.get('seed'))
        if seed is None:
            seed = int(time.time()) % (1 << 31)
        mode = str(self.cfgs.get('mode', 't2i')).lower()
        want_hist = bool(ia.pop('return_x0_history', False))
        width, height = int(ia.get('width', 512)), int(ia.get('height', 512))
        common = dict(num_steps=int(ia.get('inference_steps', ia.get('num_steps', 20))),
                      guidance_scale=float(ia.get('guidance_scale', 7.5)),
                      sampler=str(ia.get('sampler', 'dpm++_2m')), seed=int(seed))
        skw = dict(ia.get('sampler_kwargs') or {})
        if ia.get('karras') or ia.get('use_karras_sigmas'):
            skw['use_karras_sigmas'] = True
        if skw:
            common['sampler_kwargs'] = skw
        if mode in ('i2i', 'img2img', 'inpaint') and self.cfgs.get('init_image'):
            init_lat = self.pipe.encode(load_image(self.cfgs['init_image'], width, height))
            strength = float(ia.get('strength', 0.75))
            if mode == 'inpaint' and self.cfgs.get('mask_image'):
                mask = load_mask(self.cfgs['mask_image'], init_lat.shape[2], init_lat.shape[1])
                return self.pipe.inpaint(init_lat, torch.from_numpy(mask), prompt,
                                         negative_prompt, strength=strength,
                                         inpaint_model=self.world['unet_cfg'].in_channels == 9,
                                         **common)
            return self.pipe.img2img(init_lat, prompt, negative_prompt, strength=strength,
                                     **common)
        out = self.pipe.txt2img(prompt, negative_prompt, width=width, height=height,
                                batch_size=int(self.cfgs.get('bs', 1)), return_latents=True,
                                return_x0_history=want_hist, **common)
        latents, x0s = out if want_hist else (out, None)
        self.last_latents = latents
        images = self.pipe.decode(latents)
        return (images, x0s) if want_hist else images

    def vis_to_dir(self, prompt=None, negative_prompt=None, num: int = 1, **kw) -> np.ndarray:
        """``num`` requests at seeds ``seed``, ``seed + 1``, ... (a seed
        from the clock when the config has none), each handed to every
        interface with its reproduction info; returns all images."""
        prompt = prompt if prompt is not None else self.cfgs.get('prompt', '')
        negative_prompt = (negative_prompt if negative_prompt is not None
                           else self.cfgs.get('neg_prompt', ''))
        base_seed = self.cfgs.get('seed')
        if base_seed is None:
            base_seed = int(time.time()) % (1 << 31)
        all_imgs = []
        for i in range(num):
            seed = int(base_seed) + i
            imgs = self.vis_images(prompt, negative_prompt, **dict(kw, seed=seed))
            info = {'prompt': prompt, 'negative_prompt': negative_prompt, 'seed': seed,
                    **to_plain(self.cfgs.get('infer_args') or {})}
            for itf in self.interfaces:
                itf.on_infer_finish(imgs, info)
            all_imgs.append(imgs)
        return np.concatenate(all_imgs, axis=0)

    def save_model(self, path: str):
        raise _unported('save_model')


def main(argv=None) -> Tuple[Visualizer, np.ndarray]:
    """``--cfg FILE`` and ``key=value`` overrides; answers the config's
    ``num`` requests and returns the Visualizer and the images."""
    p = argparse.ArgumentParser(description='Config-driven inference on the PyTorch port')
    p.add_argument('--cfg', required=True)
    args, unknown = p.parse_known_args(argv)
    cfgs = load(args.cfg, unknown)
    viser = Visualizer(cfgs)
    return viser, viser.vis_to_dir(num=int(cfgs.get('num', 1)))
