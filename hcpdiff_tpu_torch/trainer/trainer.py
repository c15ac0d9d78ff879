"""The config-driven Trainer (counterpart of ``hcpdiff_tpu/trainer/trainer.py``).

    python -m hcpdiff_tpu_torch.train --cfg cfgs/train/examples/X.yaml [key=value ...]

Lifecycle, as in the JAX package: config -> exp_dir and its frozen
``cfg.yaml`` -> loggers -> models (a diffusers-layout directory,
``models/factory.py``; SDXL with its second text encoder) -> prompt-tuning
words (``tokenizer_pt.emb_dir``'s ``.pt`` files) -> datasets and buckets
(and the latent cache; DreamArtist's [neg, pos] prompts, SDXL's crop-info
``time_ids``) -> the trainable pack (LoRA on the UNet and the text
encoders, DreamArtist's negative branch, layer-wise fine-tuning, the
words' rows) -> per-group optimizer and lr schedules, and the
prompt-embedding optimizer -> the train step -> the loop, which logs,
saves reference-format checkpoints (``ckpts/unet-<step>.safetensors``,
``text_encoder-<step>...``, ``text_encoder_2-<step>...``, ``<word>-<step>.pt``)
and the full state (``state/``, for ``train.resume.auto``);
``save_merged`` exports the merged weights as a diffusers-layout
directory.

It runs on the card unless the config says ``device: cpu``; with no card
it raises. ``mixed_precision`` fp16, bf16 or unset compute in bf16, fp32
and ``no`` in fp32. The models load in fp32: the weights the pack merges
into or trains stay fp32 (the pack and the frozen base copies), then the
UNet and VAE are cast to the compute dtype; the text encoder stays fp32
(``model.frozen_base_dtype: bf16`` casts it and the frozen copies).
Noise and timesteps come from one ``torch.Generator`` on the device,
seeded from ``seed``; the data order and crops from the JAX package's
numpy seeds.

Added words get ids past the text encoder's table (the factory's
convention, PR 15's at inference): their rows are ``pack['emb']`` (SDXL: one
table an encoder, split from the files' joined [n, 768 + 1280] vectors),
all of them updated by the prompt-embedding optimizer when
``tokenizer_pt.train`` names any, as in the JAX package.

What the JAX Trainer does beyond this raises ``NotImplementedError``
naming its ROADMAP.md queue 1 item, never ignored: the previewer, the
optimizers other than AdamW/Adam/SGD, TensorBoard/W&B loggers (item 6);
ControlNet plugins and data (item 7); fsdp, ZeRO and multi-host (item 8).

v-prediction (``noise_scheduler.prediction_type: v_prediction``, SD2.x-v)
trains against ``NoiseSchedule.target``; Min-SNR weighs it by the same
min(gamma / SNR, 1) as epsilon, as the JAX loss does. Under
``model.gradient_checkpointing`` (default on) the UNet recomputes its
blocks under ``HCP_REMAT_POLICY`` (``flash`` by default: kernel A's o and
lse are kept, so the recompute launches no A; ``full``), as the JAX
trainer does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..adapt.overlay import make_lora_overlay, trainable_mask
from ..ckpt.formats import load_webui_embedding
from ..ckpt.manager import CkptManagerDiffusers, CkptManagerPKL, CkptManagerSafe, StateManager
from ..config import Cfg, instantiate, load, save_config
from ..config.legacy import TrainCFGConverter
from ..data.buckets import FixedBucket, LongEdgeBucket, RatioBucket, SizeBucket
from ..data.dataset import DataGroup, TextImagePairDataset
from ..data.sources import (ComposeDataSource, T2IFolderClassSource, Text2ImageAttMapSource,
                            Text2ImageCondSource, Text2ImageSource)
from ..data.transforms import Compose, TemplateFill
from ..diffusion.losses import LOSSES
from ..diffusion.schedules import NoiseSchedule
from ..loggers import build_loggers
from ..models.compose.sdxl_te import (SDXLTextEncoderFrontend, concat_sdxl_embedding,
                                      split_sdxl_embedding)
from ..models.factory import build_models
from ..models.text_frontend import TextEncoderFrontend
from ..models.unet import resolve_remat_policy
from ..utils.cfg_parse import get_cfg_range
from .assemble import (assemble, assemble_te, base_weights, lora_base_weights, make_te_apply,
                       make_unet_apply)
from .optimizers import make_optimizer, make_pt_optimizer, make_schedule, resolve_optimizer
from .preemption import PreemptionGuard, resolve_preemption_cfg
from .step import StepConfig, build_train_step, init_train_state, pack_leaves

DTYPES = {'fp16': torch.bfloat16, 'bf16': torch.bfloat16, None: torch.bfloat16,
          'fp32': torch.float32, 'no': torch.float32}


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f'{what} is not ported to the PyTorch package yet '
                               f'(ROADMAP.md queue 1 item {item})')


def refuse_unported(cfgs: Cfg) -> None:
    """Raise on every feature of the JAX Trainer's configs that the port
    does not train yet, before anything is built."""
    tcfg = cfgs.get('train') or {}
    if cfgs.get('plugin_unet') or cfgs.get('plugin_TE'):
        raise _unported('plugins (plugin_unet/plugin_TE: ControlNet)', 7)
    if cfgs.get('previewer'):
        raise _unported('the training previewer (previewer:)', 6)
    if (int(cfgs.get('fsdp', 1) or 1) > 1 or tcfg.get('zero') or tcfg.get('zero1')
            or cfgs.get('multi_host')):
        raise _unported('sharded or multi-host training (fsdp, train.zero, multi_host)', 8)
    for ds in (cfgs.get('data') or {}).values():
        if 'Cond' in str((ds or {}).get('_target_', '')):
            raise _unported('ControlNet datasets (TextImageCondPairDataset)', 7)
    resolve_optimizer(tcfg.get('optimizer'))
    resolve_optimizer(tcfg.get('optimizer_pt'))


class Trainer:
    def __init__(self, cfgs: Cfg, world: Optional[Dict[str, Any]] = None):
        """``world``: a ``build_models`` dict to train in place of the
        config's model directory (the modules in fp32 on ``device``)."""
        cfgs = TrainCFGConverter().convert(cfgs)
        refuse_unported(cfgs)
        self.cfgs = cfgs
        self.device = torch.device(str(cfgs.get('device', 'cuda')))
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('the Trainer runs on a CUDA card and none is present; ask for '
                               'the CPU with device=cpu')
        self.exp_dir = cfgs.get('exp_dir') or f'exps/{time.strftime("%Y-%m-%d-%H-%M-%S")}'
        os.makedirs(os.path.join(self.exp_dir, 'ckpts'), exist_ok=True)
        save_config(cfgs, os.path.join(self.exp_dir, 'cfg.yaml'))
        self.loggers = build_loggers(cfgs.get('logger'), self.exp_dir)
        self.seed = int(cfgs.get('seed', 42))

        tcfg = cfgs.get('train') or Cfg()
        self.grad_accum = int(tcfg.get('gradient_accumulation_steps', 1))
        self.build_model(world)
        self.make_hooks()
        self.build_dataset()
        self.build_trainables()
        self.build_optimizer_scheduler()
        self.build_ckpt_manager()
        self.load_resume()

        epochs = tcfg.get('train_epochs')
        if epochs and not tcfg.get('train_steps'):
            # epochs -> steps over the shortest dataset
            self.train_steps = int(epochs) * max(min(len(d) for d in self.datasets), 1)
        else:
            self.train_steps = int(tcfg.get('train_steps') or 1000)
        self.save_step = int(tcfg.get('save_step', 100))
        self.make_train_step()
        self.restore_full_state()

    # ------------------------------------------------------------ build ----
    def build_model(self, world):
        mcfg = self.cfgs.get('model') or Cfg()
        self.dtype = DTYPES.get(self.cfgs.get('mixed_precision'), torch.bfloat16)
        t0 = time.perf_counter()
        if world is None:
            world = build_models(mcfg.get('pretrained_model_name_or_path'), dtype=torch.float32,
                                 device=self.device, seed=self.seed)
        self.seconds = {'model load': time.perf_counter() - t0, 'latent cache': 0.0}
        self.world = world
        self.sdxl = bool(world['sdxl'])
        self.unet, self.te, self.vae = world['unet'], world['te'], world['vae']
        self.te2 = world.get('te2')
        for m in (self.unet, self.te, self.vae, self.te2):
            if m is not None:
                m.requires_grad_(False)
        self.unet.remat = bool(mcfg.get('gradient_checkpointing', True))
        self.unet.remat_policy = resolve_remat_policy()
        self.aliases = world['aliases']

        # noise scheduler: Pyramid and ZeroTerminal wrappers and
        # NoiseSchedule/DDPMScheduler kwargs
        ns = mcfg.get('noise_scheduler')
        sched_kw = {}
        self.noise_kind, self.pyramid_discount = 'gaussian', 0.9
        while isinstance(ns, dict):
            tgt = str(ns.get('_target_', ''))
            if 'Pyramid' in tgt:
                self.noise_kind, self.pyramid_discount = 'pyramid', float(ns.get('discount', 0.9))
                ns = ns.get('base_scheduler') or ns.get('scheduler')
            elif 'ZeroTerminal' in tgt:
                sched_kw['zero_terminal_snr'] = True
                ns = ns.get('base_scheduler') or ns.get('scheduler')
            elif 'NoiseSchedule' in tgt or 'DDPMScheduler' in tgt:
                sched_kw.update({k: ns[k] for k in ('beta_start', 'beta_end', 'beta_schedule',
                                                    'prediction_type', 'num_train_timesteps')
                                 if k in ns})
                ns = None
            else:
                ns = None
        self.noise_schedule = NoiseSchedule.make(**sched_kw)
        self.tokenizer = world['tokenizer']
        text = dict(n_repeats=int(mcfg.get('tokenizer_repeats', 1)))
        if self.sdxl:
            # SDXL's convention: the penultimate layer, no final norm
            self.frontend = SDXLTextEncoderFrontend(
                self.tokenizer, self.te, self.te2, clip_skip=int(mcfg.get('clip_skip', 1)),
                clip_final_norm=bool(mcfg.get('clip_final_norm', False)), **text)
        else:
            self.frontend = TextEncoderFrontend(
                self.tokenizer, self.te, clip_skip=int(mcfg.get('clip_skip', 0)),
                clip_final_norm=bool(mcfg.get('clip_final_norm', True)), **text)

    def make_hooks(self):
        """Prompt-tuning words: every ``.pt`` file of ``tokenizer_pt.emb_dir``
        (sorted by file name) registered with the tokenizer, its ids past
        the encoder's table, its rows in ``emb_rows`` in id order."""
        pt_cfg = self.cfgs.get('tokenizer_pt') or Cfg()
        self.train_emb_names = [t['name'] for t in (pt_cfg.get('train') or [])]
        self.emb_slices: Dict[str, slice] = {}
        rows = []
        emb_dir = pt_cfg.get('emb_dir', 'embs/')
        if emb_dir and os.path.isdir(emb_dir):
            for f in sorted(os.listdir(emb_dir)):
                if f.endswith('.pt'):
                    name, vecs = load_webui_embedding(os.path.join(emb_dir, f))
                    ids = self.tokenizer.add_word(name, n_vectors=vecs.shape[0])
                    start = sum(len(r) for r in rows)
                    if ids[0] != self.te.cfg.vocab_size + start:
                        raise ValueError(f'word {name!r} took ids {ids}, not the rows after '
                                         'the loaded words (the tokenizer already held words)')
                    rows.append(vecs.astype(np.float32))
                    self.emb_slices[name] = slice(start, start + vecs.shape[0])
        self.emb_rows = np.concatenate(rows) if rows else None

    def build_dataset(self):
        self.vae.to(self.dtype)
        self.datasets = [self._build_one_dataset(ds_cfg)
                         for ds_cfg in (self.cfgs.get('data') or {}).values()]
        if not self.datasets:
            raise ValueError('no datasets configured (data:)')

    def _encode(self, images: np.ndarray) -> np.ndarray:
        """[N, H, W, 3] in [-1, 1] -> scaled latents [N, h, w, 4], fp32."""
        with torch.no_grad():
            x = torch.from_numpy(images).to(self.device, self.dtype)
            lat = self.vae.encode(x)[0].float() * self.vae.cfg.scaling_factor
        return lat.cpu().numpy()

    def _build_one_dataset(self, ds_cfg: Cfg) -> TextImagePairDataset:
        src_classes = {'Text2ImageCondSource': Text2ImageCondSource,
                       'T2IFolderClassSource': T2IFolderClassSource,
                       'Text2ImageAttMapSource': Text2ImageAttMapSource,
                       'Text2ImageSource': Text2ImageSource}
        sources = []
        for sname, s_cfg in (ds_cfg.get('source') or {}).items():
            s = dict(s_cfg)
            tgt = str(s.pop('_target_', 'Text2ImageSource')).split('.')[-1]
            cls = src_classes.get(tgt)
            if cls is None:
                raise ValueError(f'data source {sname!r}: unknown _target_ {tgt!r}; '
                                 f'known: {sorted(src_classes)}')
            kw = dict(img_root=s.get('img_root', '.'), caption_file=s.get('caption_file'),
                      prompt_template=s.get('prompt_template'), repeat=int(s.get('repeat', 1)),
                      word_names=s.get('word_names') or {},
                      text_transforms=self._build_text_transforms(s.get('text_transforms')))
            if s.get('bg_color') is not None:
                kw['bg_color'] = tuple(int(c) for c in s['bg_color'])
            if cls is Text2ImageAttMapSource:
                kw['att_map_root'] = s.get('att_map') or s.get('att_map_root')
            sources.append(cls(**kw))
        if not sources:
            raise ValueError('a dataset has no source')
        source = sources[0] if len(sources) == 1 else ComposeDataSource(sources)
        vae_scale = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        # DreamArtist's [neg, pos] prompts whenever a LoRA group of either
        # model has a negative branch; SDXL's crop-info time_ids
        da = any(sp.get('branch') == 'n' for sp in list(self.cfgs.get('lora_unet') or [])
                 + list(self.cfgs.get('lora_text_encoder') or []))
        with_crop = (bool(ds_cfg.get('with_crop_info', self.sdxl))
                     or 'CropInfo' in str(ds_cfg.get('_target_', '')))
        ds = TextImagePairDataset(source, self._build_bucket(ds_cfg.get('bucket')),
                                  frontend=self.frontend, vae_scale=vae_scale,
                                  cache_latents=bool(ds_cfg.get('cache_latents', False)),
                                  loss_weight=float(ds_cfg.get('loss_weight', 1.0)),
                                  dream_artist=da, with_crop_info=with_crop)
        ds.build(int(ds_cfg.get('batch_size', 4)))
        ds.bucket.check_sizes(vae_scale * 2 ** (len(self.unet.cfg.block_out_channels) - 1))
        if ds.want_cache:
            t0 = time.perf_counter()
            ds.cache_all_latents(self._encode)
            seconds = time.perf_counter() - t0
            self.seconds['latent cache'] += seconds
            self.loggers.info(f'latent cache: {len(ds._latent_cache)} latents in '
                              f'{len(ds.encodes)} VAE calls, {seconds:.2f} s')
        return ds

    @staticmethod
    def _build_text_transforms(tt_cfg):
        """The source's caption augmentations (TagShuffle, TagDropout,
        TagErase; TemplateFill is applied by the source itself), each
        called as (text, rng)."""
        if not tt_cfg:
            return None
        node = dict(tt_cfg)
        items = node.get('transforms', [node] if node.get('_target_') else [])
        if str(node.get('_target_', '')).endswith('Compose'):
            items = node.get('transforms') or []
        built = []
        for item in items:
            try:
                obj = instantiate(item)
            except Exception as e:
                raise ValueError(f'text_transforms: cannot instantiate '
                                 f'{item.get("_target_", item)!r}: {e}') from e
            if isinstance(obj, TemplateFill):
                continue
            if not callable(obj):
                raise ValueError(f'text_transforms: {item.get("_target_", item)!r} built a '
                                 f'non-callable {type(obj).__name__}')
            built.append(obj)
        return Compose(built) if built else None

    @staticmethod
    def _build_bucket(b_cfg):
        if not b_cfg:
            return FixedBucket(512)
        b = dict(b_cfg)
        target = str(b.pop('_target_', ''))
        kw = {k: v for k, v in b.items() if not k.startswith('_')}
        if 'RatioBucket.from_files' in target:
            return RatioBucket.from_files(**kw)
        if 'RatioBucket.from_ratios' in target:
            return RatioBucket.from_ratios(**kw)
        if 'FixedBucket' in target or 'fixed' in target.lower():
            return FixedBucket(**kw)
        if 'LongEdge' in target:
            return LongEdgeBucket(**kw)
        if 'SizeBucket' in target:
            return SizeBucket(**kw)
        if not target:
            return RatioBucket.from_files(**kw) if kw else FixedBucket(512)
        raise ValueError(f'bucket: unknown _target_ {target!r}; known: RatioBucket.from_files, '
                         'RatioBucket.from_ratios, FixedBucket, SizeBucket, LongEdgeBucket')

    def _models(self):
        """(config key of its LoRA, of its fine-tune, module, alias, pack
        suffix) of the UNet and each text encoder; SDXL's second encoder
        takes the first's specs."""
        out = [('lora_unet', 'unet', self.unet, 'unet', 'unet'),
               ('lora_text_encoder', 'text_encoder', self.te, 'te', 'te')]
        if self.sdxl:
            out.append(('lora_text_encoder', 'text_encoder', self.te2, 'te2', 'te2'))
        return out

    def build_trainables(self):
        """The pack (``trainer/assemble.py``) and each group's lr; the
        words' rows and their lrs (``pt_lrs``)."""
        cfgs = self.cfgs
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        pack: Dict[str, Any] = {}
        self.lora_scales: Dict[str, Dict[str, float]] = {}
        self.group_lrs: Dict[str, float] = {}
        for lora_cfg, _, module, alias, part in self._models():
            specs = list(cfgs.get(lora_cfg) or [])
            for suffix, items in (('', [sp for sp in specs if sp.get('branch', 'p') != 'n']),
                                  ('_neg', [sp for sp in specs if sp.get('branch') == 'n'])):
                key = f'lora_{part}{suffix}'
                if items:
                    ov, sc = make_lora_overlay(gen, module, items, aliases=self.aliases[alias])
                    if ov:
                        pack[key], self.lora_scales[key] = ov, sc
                        self.group_lrs[key] = float(items[0].get('lr', 1e-4))
        for _, ft_cfg, module, alias, part in self._models():
            items = list(cfgs.get(ft_cfg) or [])
            if items:
                pats, lr = [], 1e-6
                for item in items:
                    pats += list(item.get('layers', []))
                    lr = float(item.get('lr', lr))
                names = trainable_mask(module, pats, self.aliases[alias])
                if names:
                    pack[f'{part}_ft'] = base_weights(module, names)
                    self.group_lrs[f'{part}_ft'] = lr
        self.pt_lrs: Dict[str, float] = {}
        if self.train_emb_names and self.emb_rows is not None:
            # every loaded word's rows train, under the largest lr (the JAX
            # package's tx_pt)
            rows = torch.from_numpy(self.emb_rows).to(self.device)
            pack['emb'] = ({k: v.contiguous() for k, v in split_sdxl_embedding(
                rows, dim_l=self.te.cfg.hidden_size).items()} if self.sdxl else rows)
            for item in (cfgs.get('tokenizer_pt') or {}).get('train'):
                self.pt_lrs[item['name']] = float(item.get('lr', 3e-3))
        if not pack:
            raise ValueError('the config trains nothing: no lora_unet, lora_text_encoder, unet '
                             'or text_encoder layers or tokenizer_pt words were selected')
        self.pack = pack
        self.dream_artist = 'lora_unet_neg' in pack or 'lora_te_neg' in pack

    def build_optimizer_scheduler(self):
        """One optimizer; each pack key a parameter group with its own lr
        under the shared schedule shape."""
        tcfg = self.cfgs.get('train') or Cfg()
        scfg = dict(tcfg.get('scheduler') or {})
        steps = int(tcfg.get('train_steps', scfg.get('num_training_steps', 1000)))
        lr_scale = (sum(d.bs for d in self.datasets) if bool(tcfg.get('scale_lr', False))
                    else 1.0)
        opt_fn, okw = resolve_optimizer(tcfg.get('optimizer'))
        clip = float(tcfg.get('max_grad_norm', 1.0) or 0)
        self.schedules = {k: make_schedule(scfg.get('name', 'constant'), lr * lr_scale,
                                           int(scfg.get('num_warmup_steps', 0)),
                                           int(scfg.get('num_training_steps', steps)))
                          for k, lr in self.group_lrs.items()}
        self.optimizer = make_optimizer(opt_fn, lr=0.0, clip_norm=clip or None, **okw)
        self.optimizer_pt, self.schedule_pt = make_pt_optimizer(
            tcfg.get('optimizer_pt'), dict(tcfg.get('scheduler_pt') or scfg),
            max(self.pt_lrs.values(), default=3e-3), steps, clip or None)

    def build_ckpt_manager(self):
        kind = self.cfgs.get('ckpt_type', 'safetensors')
        self.ckpt_manager = CkptManagerSafe() if kind == 'safetensors' else CkptManagerPKL()
        self.ckpt_manager.set_save_dir(os.path.join(self.exp_dir, 'ckpts'))
        self.states = StateManager(os.path.join(self.exp_dir, 'state'))

    @torch.no_grad()
    def load_resume(self):
        """Weight-only resume from reference-style per-model ckpt lists
        (``train.resume.ckpt_path.unet`` / ``TE``), EMA twins included."""
        self.start_step = 0
        self._resume_ema: Dict[str, Any] = {}
        rcfg = (self.cfgs.get('train') or Cfg()).get('resume')
        if not rcfg:
            return
        self.start_step = int(rcfg.get('start_step', 0))
        cp = rcfg.get('ckpt_path') or {}
        if cp.get('plugin'):
            raise _unported('resuming plugins (ControlNet)', 7)

        def load_model(paths, lora_key, ft_key, module, aliases):
            params = dict(module.named_parameters())
            for path in paths or []:
                ck = self.ckpt_manager.load_ckpt(path, aliases=aliases)
                for p, entry in (ck.get('lora') or {}).items():
                    if p in self.pack.get(lora_key, {}):
                        for k, v in entry.items():
                            self.pack[lora_key][p][k].copy_(v)
                if ck.get('lora_ema') and lora_key in self.pack:
                    self._resume_ema[lora_key] = ck['lora_ema']
                # the trained subset resumes into the pack; the rest folds
                # into the frozen base
                for name, v in (ck.get('base') or {}).items():
                    (self.pack.get(ft_key, {}).get(name, params[name])).copy_(v)
                if ck.get('base_ema') and ft_key in self.pack:
                    self._resume_ema[ft_key] = ck['base_ema']

        load_model(cp.get('unet'), 'lora_unet', 'unet_ft', self.unet, self.aliases['unet'])
        load_model(cp.get('TE') or cp.get('text_encoder'), 'lora_te', 'te_ft', self.te,
                   self.aliases['te'])
        words = cp.get('words') or {}
        for name, path in (words.items() if isinstance(words, dict) else words):
            if name not in self.emb_slices or 'emb' not in self.pack:
                self.loggers.info(f'resume: word {name!r} is not among the loaded embeddings; '
                                  'skipped')
                continue
            sl = self.emb_slices[name]
            vecs = torch.from_numpy(load_webui_embedding(path)[1][:sl.stop - sl.start])
            emb = self.pack['emb']
            if self.sdxl:
                # the file holds the joined [n, 768 + 1280] vectors
                for key, part in split_sdxl_embedding(vecs, self.te.cfg.hidden_size).items():
                    emb[key][sl.start:sl.start + len(part)].copy_(part)
            else:
                emb[sl.start:sl.start + len(vecs)].copy_(vecs)

    # ------------------------------------------------------------ steps ----
    def make_train_step(self):
        tcfg = self.cfgs.get('train') or Cfg()
        mcfg = self.cfgs.get('model') or Cfg()
        ema_cfg = mcfg.get('ema')
        loss_cfg = tcfg.get('loss') or Cfg()
        crit_cfg = dict(loss_cfg.get('criterion') or {})
        # the specific Min-SNR variants first: every one's name holds 'minsnr'
        tgt = str(crit_cfg.get('_target_', 'mse')).lower().replace('_', '')
        loss_name = next((name for key, name in (('kdiff', 'kdiff_min_snr'),
                                                 ('soft', 'soft_min_snr'), ('edm', 'edm'),
                                                 ('minsnr', 'min_snr')) if key in tgt), 'mse')
        kw = {k: v for k, v in crit_cfg.items() if k in ('gamma', 'sigma_data')}
        self.criterion = LOSSES[loss_name](noise_scheduler=self.noise_schedule, **kw)
        # loss.type 'sample' trains against x0 instead of eps
        if (str(loss_cfg.get('type', 'eps')) == 'sample'
                and self.noise_schedule.prediction_type == 'epsilon'):
            self.noise_schedule = dataclasses.replace(self.noise_schedule,
                                                      prediction_type='sample')
        lo, hi, ramp = get_cfg_range(str(tcfg.get('cfg_scale', '1.0')))
        step_cfg = StepConfig(grad_accum=self.grad_accum,
                              ema_decay=(float(ema_cfg.get('decay_max', 0.9999))
                                         if ema_cfg else None),
                              noise_kind=self.noise_kind, pyramid_discount=self.pyramid_discount,
                              dream_artist=self.dream_artist, da_cfg_low=lo, da_cfg_high=hi,
                              da_cfg_ramp=ramp)
        # fp32 copies of the weights LoRA merges into (either branch), then
        # the compute dtype
        self.frozen = {part: lora_base_weights(module, {
            **self.pack.get(f'lora_{part}', {}), **self.pack.get(f'lora_{part}_neg', {})})
            for _, _, module, _, part in self._models()}
        if str(mcfg.get('frozen_base_dtype', '')).lower() in ('bf16', 'bfloat16'):
            self.frozen = {k: {n: t.to(torch.bfloat16) for n, t in v.items()}
                           for k, v in self.frozen.items()}
            for te in (self.te, self.te2):
                if te is not None:
                    te.to(torch.bfloat16)
        self.unet.to_compute_dtype(self.dtype)
        self._train_step = build_train_step(
            make_unet_apply(self.unet), self.frontend.encode_ids, self.noise_schedule,
            self.criterion, step_cfg, self.lora_scales, te_apply=make_te_apply(self.frontend))
        self.state = init_train_state(self.pack, self.optimizer, use_ema=ema_cfg is not None,
                                      schedules=self.schedules, optimizer_pt=self.optimizer_pt,
                                      schedule_pt=self.schedule_pt)
        with torch.no_grad():
            for key, tree in self._resume_ema.items():
                for dst, src in zip(pack_leaves(self.state.ema[key]), pack_leaves(tree)):
                    dst.copy_(src)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.data_pos = [(0, 0)] * len(self.datasets)
        self.pending: List[List[Dict[str, torch.Tensor]]] = [[] for _ in self.datasets]

    # ------------------------------------------------------- full state ----
    def _full_state(self, step: int) -> Dict[str, Any]:
        opts = {k: getattr(self.state, k) for k in ('optimizer', 'optimizer_pt')}
        return {'step': step, 'pack': self.state.pack, 'ema': self.state.ema,
                **{k: o.state_dict() for k, o in opts.items() if o is not None},
                'generator': self.generator.get_state(), 'data': list(self.data_pos),
                'pending': self.pending}

    @torch.no_grad()
    def restore_full_state(self):
        """``train.resume.auto``: continue from the newest full state."""
        rcfg = (self.cfgs.get('train') or Cfg()).get('resume')
        if not (isinstance(rcfg, dict) and rcfg.get('auto', False)):
            return
        latest = self.states.latest_step()
        if latest is None:
            return
        st = self.states.restore(latest)
        for dst, src in zip(pack_leaves(self.state.pack), pack_leaves(st['pack'])):
            dst.copy_(src)
        if self.state.ema is not None:
            for dst, src in zip(pack_leaves(self.state.ema), pack_leaves(st['ema'])):
                dst.copy_(src)
        for key in ('optimizer', 'optimizer_pt'):
            if getattr(self.state, key) is not None:
                getattr(self.state, key).load_state_dict(st[key])
        self.generator.set_state(st['generator'])
        self.data_pos = [tuple(p) for p in st['data']]
        self.pending = [[{k: v.to(self.device) for k, v in b.items()} for b in queue]
                        for queue in st['pending']]
        self.start_step = self.state.step = int(st['step'])
        self.loggers.info(f'resumed the full train state at step {latest}')

    # ------------------------------------------------------------ train ----
    def train(self, draws: Optional[Callable] = None) -> int:
        """Run to ``train_steps`` (or a preemption signal); returns the last
        step. ``draws(step, dataset_index, batch)`` -> [(noise, t)] per
        microbatch, in place of the generator's (the tests feed the JAX
        package's)."""
        sigs = resolve_preemption_cfg((self.cfgs.get('train') or Cfg()).get('preemption'))
        self.preempted = False
        with PreemptionGuard(sigs or []) as guard:
            return self._train_loop(guard if sigs else None, draws)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            if k == 'prompts':
                continue
            t = torch.as_tensor(np.asarray(v))
            out[k] = t.to(self.device) if t.dtype == torch.int64 else t.to(self.device,
                                                                            torch.float32)
        if 'images' in out and 'latents' not in out:
            # uncached: encode on the device
            with torch.no_grad():
                out['latents'] = (self.vae.encode(out.pop('images').to(self.dtype))[0].float()
                                  * self.vae.cfg.scaling_factor)
        return out

    def _advance(self, di: int):
        epoch, index = self.data_pos[di]
        index += 1
        if index == len(self.datasets[di]):
            epoch, index = epoch + 1, 0
        self.data_pos[di] = (epoch, index)

    def _next_batches(self, data_iter) -> List[Dict[str, torch.Tensor]]:
        """One (accumulated) batch per dataset. With grad_accum > 1 the
        microbatches of a step share their shapes, so batches wait per
        dataset and shape until grad_accum of one shape are there (the
        JAX package's grouping, which fixes which batches form a step)."""
        out: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(self.datasets)
        rounds = 0
        while any(o is None for o in out):
            rounds += 1
            if self.grad_accum > 1 and rounds > 64 * self.grad_accum:
                raise RuntimeError(f'gradient accumulation could not collect {self.grad_accum} '
                                   'same-shape microbatches within a reasonable window: '
                                   'reduce num_bucket or gradient_accumulation_steps')
            for di, raw in enumerate(next(data_iter)):
                self._advance(di)
                if out[di] is not None:
                    continue
                b = self._to_device(raw)
                if self.grad_accum <= 1:
                    out[di] = b
                    continue
                sig = sorted((k, tuple(v.shape)) for k, v in b.items())
                same = [m for m in self.pending[di]
                        if sorted((k, tuple(v.shape)) for k, v in m.items()) == sig] + [b]
                if len(same) == self.grad_accum:
                    self.pending[di] = [m for m in self.pending[di] if not any(
                        m is s for s in same)]
                    out[di] = {k: torch.stack([m[k] for m in same]) for k in b}
                else:
                    self.pending[di].append(b)
        return out

    def _train_loop(self, guard, draws) -> int:
        log_step = max(int(self.loggers.log_step), 1)
        step = self.start_step
        loss_ema = None
        pending_losses: List[torch.Tensor] = []
        self.history: List[float] = []          # every step's loss, fetched at log cadence
        self.step_shapes: List[List[tuple]] = []
        self.step_ends: List[float] = []
        t0 = time.perf_counter()
        data_iter = iter(DataGroup(self.datasets, start=self.data_pos))
        try:
            while step < self.train_steps:
                batches = self._next_batches(data_iter)
                for di, batch in enumerate(batches):
                    d = draws(step, di, batch) if draws is not None else None
                    self.state, metrics = self._train_step(self.state, self.frozen, batch,
                                                           self.generator, draws=d)
                    pending_losses.append(metrics['loss'].detach())
                self.step_shapes.append([tuple(b['latents'].shape) for b in batches])
                step += 1
                if step % log_step == 0:
                    # the losses are fetched only here, so the host runs ahead
                    # of the device between log lines
                    losses = [float(x) for x in pending_losses]
                    pending_losses.clear()
                    self.history.extend(losses)
                    for loss in losses:
                        loss_ema = loss if loss_ema is None else 0.93 * loss_ema + 0.07 * loss
                    dt = (time.perf_counter() - t0) / log_step
                    self.loggers.info(f'step {step}/{self.train_steps} loss {loss_ema:.4f} '
                                      f'{dt * 1000:.0f} ms/it')
                    self.loggers.log({'loss': loss_ema, 'step': step}, step)
                    t0 = time.perf_counter()
                self.step_ends.append(time.perf_counter())
                if step % self.save_step == 0:
                    self.save_model(step)
                if step < self.train_steps and guard is not None and guard.should_stop():
                    self.preempted = True
                    self.loggers.info(f'preemption signal: saving the full state at step '
                                      f'{step} and stopping')
                    if step % self.save_step != 0:
                        self.save_model(step)
                    return step
        finally:
            data_iter.close()
            self.history.extend(float(x) for x in pending_losses)
        if step % self.save_step != 0:
            self.save_model(step)
        return step

    # ------------------------------------------------------------- save ----
    def save_model(self, step: int):
        """``ckpts/unet-<step>``, ``text_encoder-<step>`` and (SDXL)
        ``text_encoder_2-<step>`` in the reference layout (the JAX trainer's
        keys; the negative branch is not saved, as there), ``<word>-<step>.pt``
        for each trained word (SDXL: the joined vectors), and the full
        state."""
        self.states.save(step, self._full_state(step))
        pack, ema = self.state.pack, self.state.ema or {}
        names = {'unet': 'unet', 'te': 'text_encoder', 'te2': 'text_encoder_2'}
        for _, _, module, alias, part in self._models():
            ft, lora = f'{part}_ft', f'lora_{part}'
            if ft in pack or lora in pack:
                self.ckpt_manager.save_model_with_lora(
                    os.path.join(self.exp_dir, 'ckpts',
                                 f'{names[part]}-{step}{self.ckpt_manager.ext}'),
                    module, base=pack.get(ft), lora_overlay=pack.get(lora),
                    base_ema=ema.get(ft), lora_ema=ema.get(lora), aliases=self.aliases[alias])
        if 'emb' in pack:
            rows = pack['emb']
            rows = (concat_sdxl_embedding({k: v.detach().cpu().numpy() for k, v in rows.items()})
                    if self.sdxl else rows.detach().cpu().numpy())
            for name, sl in self.emb_slices.items():
                if name in self.train_emb_names:
                    self.ckpt_manager.save_embedding(
                        os.path.join(self.exp_dir, 'ckpts', f'{name}-{step}.pt'), rows[sl], name,
                        step)
        self.loggers.info(f'saved ckpt @ step {step}')

    def save_merged(self, out_dir: str):
        """The trained pack (ft subsets and LoRA deltas) folded into the base
        weights, with the VAE and text encoder, as a diffusers-layout
        directory (the training side of ``Visualizer.save_model``). Merged
        weights are written in fp32 (``assemble`` merges there), the rest
        in the dtype the trainer holds them in."""
        pack = self.state.pack
        with torch.no_grad():
            states = {'unet': assemble(self.frozen['unet'], pack, self.lora_scales),
                      'te': assemble_te(self.frozen['te'], pack, self.lora_scales)}
        CkptManagerDiffusers().save_pipeline(out_dir, self.unet, self.vae, self.te,
                                             tokenizer=self.frontend.tokenizer, states=states)
        self.loggers.info(f'exported the merged pipeline to {out_dir}')


def main(argv=None) -> Trainer:
    """``--cfg FILE`` and ``key=value`` overrides; trains and returns the
    Trainer."""
    p = argparse.ArgumentParser(description='Config-driven training on the PyTorch port')
    p.add_argument('--cfg', required=True)
    args, unknown = p.parse_known_args(argv)
    trainer = Trainer(load(args.cfg, unknown))
    try:
        trainer.train()
    finally:
        trainer.loggers.close()
    return trainer
