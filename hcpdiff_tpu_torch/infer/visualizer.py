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

The ``merge`` block is a recipe over the directory's weights,
``base * a + sum(lora_i * scale_i) + sum(part_k)`` (``ModelMerger``):
groups by ``type`` ('unet' in it, else the text encoder), LoRA files with
``alpha``, ``layers`` and the block's ``load_ema``, ``part`` files blended
with the group's ``base_model_alpha``, DreamArtist's negative branch
(``branch: n``, or a ``mask`` of [0, 0.5]), and a UNet rebuilt with q/k/v
biases for pre-0.9 biased LoRAs. The directory loads in fp32 and stays
on the device as the recipe's base (``Visualizer.base``): the merge runs
in fp32 and each merged tensor is cast to the compute dtype as it is
written into its module, so a reload of the recipe
(``infer/reloadable.py``) merges again without reading the directory.
``emb_dir`` adds its ``.pt`` embeddings' words to the tokenizer, and
``save_model`` writes the merged modules as a diffusers-layout directory.

The configs' class names (``hcpdiff_tpu.infer.interfaces.DiskInterface``,
``diffusers.EulerAncestralDiscreteScheduler``) are read as names, never
imported. ``infer_args.deep_cache_interval`` runs txt2img under DeepCache
(dropped with a warning beside DreamArtist's negative branch or a
ControlNet condition, as the JAX Visualizer drops it), and
``encoder_attention_mask: true`` gives the UNet the prompts' padding mask.
What the JAX Visualizer does beyond this is not ported yet and raises
``NotImplementedError`` rather than being ignored: plugins in the
``merge`` block (ControlNet), ControlNet conditions (``ex_input.cond``),
and SDXL text-encoder settings other than SDXL's own.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..adapt.overlay import (attach_host_biases, get_match_layers, merge_overlays,
                             module_paths, overlay_bias_paths)
from ..ckpt.formats import load_webui_embedding
from ..ckpt.manager import CkptManagerDiffusers, auto_manager
from ..config import Cfg, load, to_plain
from ..config.legacy import InferCFGConverter
from ..diffusion.schedules import NoiseSchedule
from ..models.compose.sdxl_te import SDXLTextEncoderFrontend, split_sdxl_embedding
from ..models.factory import build_models, load_vae
from ..models.text_frontend import TextEncoderFrontend
from ..models.unet import UNet2DCondition
from ..utils.images import load_image, load_mask
from .interfaces import (BaseInterface, DiskAnimInterface, DiskInterface,
                         WebUIInterface)
from .pipeline import DiffusionPipeline


def _unported(what: str, item: int = 5) -> NotImplementedError:
    return NotImplementedError(f'{what} is not ported to the PyTorch package yet '
                               f'(ROADMAP.md queue 1 item {item})')


def _refuse_unported(cfgs: Cfg) -> None:
    """Raise on every config feature of the JAX Visualizer that the port
    does not run yet."""
    for name, group in (cfgs.get('merge') or {}).items():
        if isinstance(group, dict) and name != 'plugin_cfg' and group.get('plugin'):
            raise _unported(f'the plugin entries of merge.{name} (ControlNet)', 7)
    if (cfgs.get('ex_input') or {}).get('cond') is not None:
        raise _unported('ex_input.cond (ControlNet)', 7)


def _within(path: str, selected: Optional[set]) -> bool:
    return selected is None or any(path == s or path.startswith(s + '.') for s in selected)


class ModelMerger:
    """One model's recipe over its fp32 weights ({state-dict name: tensor}):
    ``load_part`` blends a fine-tuned subset into them at once, ``load_lora``
    queues a LoRA, ``merged`` adds the queued LoRAs' deltas (the JAX
    ``ModelMerger``, with the reference's ``layers`` filter and
    ``load_ema``). The weights given are never written in place."""

    def __init__(self, params: Mapping[str, torch.Tensor], module: nn.Module,
                 aliases: Dict[str, str]):
        self.params = dict(params)
        self.module = module
        self.aliases = aliases
        self.overlays: List[dict] = []
        self.scales: List[dict] = []
        self.blended: set = set()

    def _selected(self, layers) -> Optional[set]:
        """The selected module paths, or None for all."""
        if layers is None or layers == 'all':
            return None
        return set(get_match_layers(layers, module_paths(self.module), self.aliases))

    def load_part(self, ckpt_path: str, alpha: float = 1.0, layers='all',
                  load_ema: bool = False, base_alpha: Optional[float] = None) -> 'ModelMerger':
        """w = base_alpha * w + alpha * part; ``base_alpha`` defaults to
        1 - alpha (a convex blend). Names the model lacks are skipped."""
        ck = auto_manager(ckpt_path).load_ckpt(ckpt_path)
        part = (ck.get('base_ema') if load_ema else None) or ck.get('base')
        ba = (1 - alpha) if base_alpha is None else float(base_alpha)
        sel = self._selected(layers) if part else None
        for name, value in (part or {}).items():
            w = self.params.get(name)
            if w is None or not _within(name.rsplit('.', 1)[0], sel):
                continue
            self.params[name] = w * ba + value.to(w) * alpha
            self.blended.add(name)
        return self

    def load_lora(self, ckpt_path: str, alpha: float = 1.0, layers='all',
                  load_ema: bool = False) -> 'ModelMerger':
        ck = auto_manager(ckpt_path).load_ckpt(ckpt_path, aliases=self.aliases)
        overlay = (ck.get('lora_ema') if load_ema else None) or ck.get('lora')
        if overlay:
            sel = self._selected(layers)
            device = next(iter(self.params.values())).device
            overlay = {p: {k: v.to(device) for k, v in e.items()}
                       for p, e in overlay.items() if _within(p, sel)}
        if overlay:
            self.overlays.append(overlay)
            self.scales.append({p: alpha for p in overlay})
        return self

    def touched(self) -> set:
        """The names whose merged value differs from the weights given."""
        out = set(self.blended)
        for ov in self.overlays:
            for path, entry in ov.items():
                out.add(f'{path}.weight')
                if 'bias' in entry:
                    out.add(f'{path}.bias')
        return out

    def merged(self) -> Dict[str, torch.Tensor]:
        return dict(self.items(list(self.params)))

    def items(self, names) -> Iterator[Tuple[str, torch.Tensor]]:
        """(name, merged weight) for each of ``names``, merged one layer at
        a time, so the merged weights are never held all at once."""
        entries: Dict[str, List[Tuple[dict, float]]] = {}
        for ov, sc in zip(self.overlays, self.scales):
            for path, e in ov.items():
                entries.setdefault(path, []).append((e, sc.get(path, 1.0)))
        for name in names:
            path = name.rsplit('.', 1)[0]
            if path not in entries:
                yield name, self.params[name]
                continue
            layer = {n: self.params[n] for n in (f'{path}.weight', f'{path}.bias')
                     if n in self.params}
            yield name, merge_overlays(layer, [{path: e} for e, _ in entries[path]],
                                       [{path: s} for _, s in entries[path]])[name]


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
                             dtype=torch.float32, device=self.device)
        self.world = world
        self.tokenizer = world['tokenizer']
        # the recipe's base: the fp32 weights the merges start from, kept
        # on the device (shared with the modules until a merge or the
        # compute-dtype cast writes the modules' own)
        self.base = {key: {n: p.detach() for n, p in world[key].named_parameters()}
                     for key in ('unet', 'te')}
        self._written: Dict[str, Optional[set]] = {'unet': None, 'te': None}
        self._emb_vectors: Dict[str, np.ndarray] = {}
        world['vae'].to(self.dtype)
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
        self.pipe.use_encoder_attention_mask = bool(cfgs.get('encoder_attention_mask', False))
        self._build_merged()
        self.last_latents: Optional[torch.Tensor] = None
        self._build_interfaces()

    def _build_interfaces(self) -> None:
        self.interfaces: List[BaseInterface] = [self._interface(item)
                                                for item in (self.cfgs.get('interface') or [])]
        if not self.interfaces:
            self.interfaces = [DiskInterface(self.cfgs.get('output_dir', 'output/'))]

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

    # ----------------------------------------------------------- merge ----
    def _dtype_of(self, key: str, name: str) -> torch.dtype:
        """The dtype a module holds a weight in: the UNet's in the compute
        dtype but its time/add-embedding MLPs, the text encoder's fp32."""
        if key == 'unet' and not name.startswith(UNet2DCondition.FP32_CHILDREN):
            return self.dtype
        return torch.float32

    def _held(self, key: str, value: torch.Tensor, name: str) -> torch.Tensor:
        value = value.to(self._dtype_of(key, name))
        return value.contiguous(memory_format=torch.channels_last) if value.dim() == 4 else value

    def _write(self, key: str, merger: ModelMerger) -> None:
        """Put the merged weights into the module one at a time, each cast
        as it is written, so no second whole copy is made; the names written
        before and not now go back to the base. The first write (after a
        load or a rebuild, ``_written`` None) writes every name."""
        module, before, touched = self.world[key], self._written[key], merger.touched()
        if before is None:
            names = [n for n, _ in module.named_parameters()]
        else:
            names = sorted(before | touched)
        held = ((n, self._held(key, v, n)) for n, v in merger.items(names))
        if before is None:          # a loaded or meta-device module: its every tensor
            module.load_state_dict(dict(held), strict=True, assign=True)
        else:
            params = dict(module.named_parameters())
            for n, v in held:
                params[n].data = v
        self._written[key] = touched

    def _add_qkv_bias(self, mergers: List[ModelMerger]) -> None:
        """Rebuild the UNet with biased q/k/v (``UNetConfig.qkv_bias``) and
        give the base and the mergers zero biases there: the reference
        creates the host bias when it folds a biased LoRA into a bias-free
        layer."""
        old = self.world['unet']
        cfg = dataclasses.replace(old.cfg, qkv_bias=True)
        with torch.device('meta'):
            unet = UNet2DCondition(cfg, fused_sublayers=old.fused_sublayers).eval()
        qkv = [p for p in module_paths(unet) if p.rsplit('.', 1)[-1] in ('to_q', 'to_k', 'to_v')]
        self.base['unet'] = attach_host_biases(self.base['unet'], qkv)
        for m in mergers:
            m.params, m.module = attach_host_biases(m.params, qkv), unet
        self.world.update(unet=unet, unet_cfg=cfg)
        self.pipe.unet = unet
        self._written['unet'] = None
        del old

    def _build_merged(self) -> None:
        """Run the merge recipe and the embeddings directory from the kept
        base; shared by ``__init__`` and ``VisualizerReloadable``, so a
        reload keeps the negative branch, the casts and the embedding
        table in step."""
        t0 = time.perf_counter()
        cfgs, world = self.cfgs, self.world
        unet_m = ModelMerger(self.base['unet'], world['unet'], world['aliases']['unet'])
        te_m = ModelMerger(self.base['te'], world['te'], world['aliases']['te'])
        neg_m = ModelMerger(self.base['unet'], world['unet'], world['aliases']['unet'])
        has_neg = False
        merge_cfg = cfgs.get('merge') or {}
        load_ema = bool(merge_cfg.get('load_ema', False))
        for name, group in merge_cfg.items():
            if not isinstance(group, dict) or name == 'plugin_cfg':
                continue
            unet = 'unet' in str(group.get('type', 'unet'))
            for item in group.get('lora') or []:
                kw = dict(alpha=float(item.get('alpha', 1.0)), layers=item.get('layers', 'all'),
                          load_ema=load_ema)
                # DreamArtist: 'branch: n' LoRAs go to the negative half;
                # the reference's configs say so by a batch mask of [0, 0.5]
                mask = item.get('mask')
                neg = item.get('branch', 'p') == 'n' or (
                    mask is not None and float(mask[0]) == 0.0 and float(mask[-1]) <= 0.5)
                if unet and neg:
                    neg_m.load_lora(item['path'], **kw)
                    has_neg = True
                else:
                    (unet_m if unet else te_m).load_lora(item['path'], **kw)
            # base_model_alpha weighs the base under part entries only, as
            # in the JAX package (load_unet_part.yaml's TE group leans on it)
            for item in group.get('part') or []:
                (unet_m if unet else te_m).load_part(
                    item['path'], alpha=float(item.get('alpha', 1.0)),
                    layers=item.get('layers', 'all'), load_ema=load_ema,
                    base_alpha=group.get('base_model_alpha'))
        need_bias = overlay_bias_paths(unet_m.overlays + neg_m.overlays, self.base['unet'])
        if need_bias:
            not_qkv = [p for p in need_bias
                       if p.rsplit('.', 1)[-1] not in ('to_q', 'to_k', 'to_v')]
            if not_qkv:
                raise ValueError(f'LoRA bias deltas target bias-free layers {not_qkv[:3]} that '
                                 'are not attention q/k/v: no host rebuild is available for '
                                 'them; strip them with adapt.overlay.strip_overlay_bias')
            self._add_qkv_bias([unet_m, neg_m])
        self._write('unet', unet_m)
        self._write('te', te_m)
        self.unet_params_neg = None
        if has_neg:
            # the negative half's weights wherever either half differs
            # from the base (no part blends: those are the positive half's)
            names = sorted(unet_m.touched() | neg_m.touched())
            self.unet_params_neg = {n: self._held('unet', v, n) for n, v in neg_m.items(names)}
        self.pipe.unet_params_neg = self.unet_params_neg
        self._load_embeddings()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.merge_seconds = time.perf_counter() - t0

    def _load_embeddings(self) -> None:
        """``emb_dir``'s ``.pt`` files: each word registered with the
        tokenizer (a word already there keeps its ids) and the rows of the
        ids past the vocabulary (``emb_ext``) built in id order; a word
        whose file has gone keeps the vectors it was loaded with. SDXL's
        rows are split between the two encoders."""
        mcfg = self.cfgs.get('model') or Cfg()
        emb_dir = self.cfgs.get('emb_dir') or mcfg.get('emb_dir')
        tk = self.tokenizer
        if emb_dir and os.path.isdir(emb_dir):
            for f in sorted(os.listdir(emb_dir)):
                if f.endswith('.pt'):
                    word, vecs = load_webui_embedding(os.path.join(emb_dir, f))
                    ids = tk.add_word(word, n_vectors=vecs.shape[0])
                    if len(ids) != vecs.shape[0]:
                        raise ValueError(f'{f}: {vecs.shape[0]} vectors for {word!r}, which '
                                         f'holds {len(ids)} ids since an earlier load')
                    self._emb_vectors[word] = vecs
        self.emb_ext = None
        if not self._emb_vectors:
            return
        n = max(i for ids in tk.added_tokens.values() for i in ids) + 1 - tk.vocab_size
        dim = next(iter(self._emb_vectors.values())).shape[1]
        rows = np.zeros((n, dim), np.float32)
        for word, vecs in self._emb_vectors.items():
            start = tk.added_tokens[word][0] - tk.vocab_size
            rows[start:start + len(vecs)] = vecs
        if self.sdxl:
            parts = split_sdxl_embedding(rows, dim_l=self.world['te_cfg'].hidden_size)
            self.emb_ext = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                            for k, v in parts.items()}
        else:
            self.emb_ext = torch.from_numpy(rows).to(self.device)

    # ------------------------------------------------------------- run ----
    def vis_images(self, prompt, negative_prompt='', **kw):
        """One request under ``infer_args`` (``kw`` overrides them, and
        ``bs`` the config's batch) -> images float32 [B, H, W, 3] in
        [0, 1] (and, for txt2img with ``return_x0_history``, every step's
        x0 prediction)."""
        ia = dict(self.cfgs.get('infer_args') or {})
        ia.update(kw)
        seed = ia.pop('seed', self.cfgs.get('seed'))
        if seed is None:
            seed = int(time.time()) % (1 << 31)
        mode = str(self.cfgs.get('mode', 't2i')).lower()
        want_hist = bool(ia.pop('return_x0_history', False))
        batch_size = int(ia.pop('bs', self.cfgs.get('bs', 1)))
        width, height = int(ia.get('width', 512)), int(ia.get('height', 512))
        common = dict(num_steps=int(ia.get('inference_steps', ia.get('num_steps', 20))),
                      guidance_scale=float(ia.get('guidance_scale', 7.5)),
                      sampler=str(ia.get('sampler', 'dpm++_2m')), seed=int(seed),
                      emb_ext=self.emb_ext)
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
                                batch_size=batch_size, return_latents=True,
                                return_x0_history=want_hist,
                                deep_cache_interval=self._deep_cache_interval(ia), **common)
        latents, x0s = out if want_hist else (out, None)
        self.last_latents = latents
        images = self.pipe.decode(latents)
        return (images, x0s) if want_hist else images

    def _deep_cache_interval(self, ia: Mapping) -> int:
        """``infer_args.deep_cache_interval``, or 0 with a warning where
        DeepCache cannot run: DreamArtist's negative branch, a ControlNet
        condition."""
        n = int(ia.get('deep_cache_interval') or 0)
        if n and (self.pipe.unet_params_neg is not None
                  or (self.cfgs.get('ex_input') or {}).get('cond') is not None):
            logging.getLogger('hcpdiff_tpu_torch').warning(
                'deep_cache_interval ignored: incompatible with DreamArtist/ControlNet generation')
            return 0
        return n

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

    def save_model(self, path: str) -> None:
        """The merged modules (and the tokenizer, without added words) as a
        diffusers-layout directory, each weight in the dtype it is held in;
        DreamArtist's negative branch is not a part of it."""
        w = self.world
        CkptManagerDiffusers().save_pipeline(path, w['unet'], w['vae'], w['te'], w.get('te2'),
                                             tokenizer=self.tokenizer)


def main(argv=None) -> Tuple[Visualizer, np.ndarray]:
    """``--cfg FILE`` and ``key=value`` overrides; answers the config's
    ``num`` requests, then writes the merged model where ``save_model.path``
    says, and returns the Visualizer and the images."""
    p = argparse.ArgumentParser(description='Config-driven inference on the PyTorch port')
    p.add_argument('--cfg', required=True)
    args, unknown = p.parse_known_args(argv)
    cfgs = load(args.cfg, unknown)
    viser = Visualizer(cfgs)
    images = viser.vis_to_dir(num=int(cfgs.get('num', 1)))
    save = cfgs.get('save_model')
    if save:
        viser.save_model(save.get('path') if isinstance(save, dict) else str(save))
    return viser, images
