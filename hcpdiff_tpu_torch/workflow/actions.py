"""Workflow actions (counterpart of ``hcpdiff_tpu/workflow/actions.py``;
reference hcpdiff/workflow/{io,text,diffusion,vae,model,utils}.py): the
vocabulary of ``cfgs/workflow/*.yaml``.

``states`` carries the run's data: ``text_emb`` (the CFG-doubled context,
negative prompts first), ``latents`` (fp32 NHWC tensors on the models'
device), ``sampler_state``, ``rng`` (a CPU ``torch.Generator``, as the
port draws latents and sampler noise: ROADMAP "Seeds"), ``timesteps`` /
``t`` (indices into the sampler's plan), and ``images`` and ``cond``
(numpy [B, H, W, 3] in [0, 1], the JAX package's layouts). ``memory``
holds the models: ``LoadModelsAction`` puts the ``build_models`` world
there (modules on the card unless the config says ``device: cpu``), the
text frontend, the noise schedule, a ``DiffusionPipeline`` over them
(``pipe``) and ``unet_apply(x, t, ctx, cond=None, **extra)``: the UNet
with its current weights, the loaded plugins' residuals summed into its
taps where a call has ``cond`` (``DiffusionPipeline._with_taps``, each
plugin's residuals times its ``alpha``). Unlike the JAX ``unet_apply`` it
takes no params: LoRA and part loads write the merged weights (fp32
merges, cast to the compute dtype) into the UNet, whose fp32 base stays in
``memory['unet_params']``.

Where the JAX package fails, the port fails too, with a clearer error: a
sampler state made at one latent size and carried to another (the
highres configs' DPM++ 2M after ``LatentResizeAction``) raises a
``ValueError`` naming both shapes, and the workflows run under a
stateless sampler (``euler``) there. ``actions_pre_lora`` is not a key the
runner reads, as in the JAX package.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ckpt.manager import auto_manager
from ..config.instantiate import instantiate, locate
from ..data.processor import ControlNetProcessor
from ..diffusion.samplers import make_sampler
from ..diffusion.schedules import NoiseSchedule
from ..infer.interfaces import DiskInterface
from ..infer.pipeline import DiffusionPipeline
from ..infer.visualizer import ModelMerger
from ..models.controlnet import build_controlnet, controlnet_from_state, plugin_builder
from ..models.factory import build_models
from ..models.text_frontend import TextEncoderFrontend
from .base import BasicAction, MemoryMixin


def _vae_scale(memory) -> int:
    return 2 ** (len(memory['vae_cfg'].block_out_channels) - 1)


# ----------------------------------------------------------------- io ----

class LoadModelsAction(BasicAction, MemoryMixin):
    """Build the models into memory (reference workflow/io.py:13). ``dtype``
    bf16, fp16 and amp mean bf16, anything else fp32; the device is
    ``memory['device']`` (the runner's ``device``), the card by default."""

    def __init__(self, pretrained_model: Optional[str] = None, dtype: str = 'bf16', **kw):
        super().__init__(**kw)
        self.pretrained = pretrained_model
        self.dtype = torch.bfloat16 if dtype in ('bf16', 'fp16', 'amp') else torch.float32

    def __call__(self, memory=None, **states):
        device = torch.device(str(memory.get('device', 'cuda')))
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('the workflow runs on a CUDA card and none is present; ask for the '
                               'CPU with device=cpu')
        world = build_models(self.pretrained, dtype=torch.float32, device=device)
        if world['sdxl']:
            raise NotImplementedError('the workflow actions run SD1.x/2.x models, as in the JAX '
                                      'package (NoisePredAction gives the UNet no SDXL '
                                      'conditioning)')
        memory.update(world)
        unet, vae = world['unet'], world['vae']
        # the fp32 base of LoRA and part merges, then the compute dtype
        memory['unet_params'] = {n: p.detach() for n, p in unet.named_parameters()}
        unet.requires_grad_(False).to_compute_dtype(self.dtype)
        vae.requires_grad_(False).to(self.dtype)
        world['te'].requires_grad_(False)
        memory['device'], memory['dtype'] = device, self.dtype
        memory['frontend'] = TextEncoderFrontend(world['tokenizer'], world['te'])
        memory['schedule'] = NoiseSchedule.make()
        memory['pipe'] = pipe = DiffusionPipeline(unet, vae, memory['frontend'],
                                                  memory['schedule'])
        memory['plugins'] = {}
        memory['unet_apply'] = pipe._with_taps(unet)
        return states


def _write_unet(memory) -> None:
    """The model loader's merged weights into the UNet (each cast to the
    dtype it holds, 4-D ones channels_last), and the names a load touched
    before and not now back to their base."""
    loader, unet = memory['model_loader'], memory['unet']
    params = dict(unet.named_parameters())
    touched = loader.touched()
    for name, value in loader.items(sorted(touched | memory.get('unet_touched', set()))):
        value = value.to(params[name].dtype)
        params[name].data = (value.contiguous(memory_format=torch.channels_last)
                             if value.dim() == 4 else value)
    memory['unet_touched'] = touched


class BuildModelLoaderAction(BasicAction, MemoryMixin):
    def __call__(self, memory=None, **states):
        memory['model_loader'] = ModelMerger(memory['unet_params'], memory['unet'],
                                             memory['aliases']['unet'])
        return states


class LoadLoraAction(BasicAction, MemoryMixin):
    def __init__(self, path: str, alpha: float = 1.0, **kw):
        super().__init__(**kw)
        self.path, self.alpha = path, float(alpha)

    def __call__(self, memory=None, **states):
        memory['model_loader'].load_lora(self.path, self.alpha)
        _write_unet(memory)
        return states


class LoadPartAction(BasicAction, MemoryMixin):
    def __init__(self, path: str, alpha: float = 1.0, **kw):
        super().__init__(**kw)
        self.path, self.alpha = path, float(alpha)

    def __call__(self, memory=None, **states):
        memory['model_loader'].load_part(self.path, self.alpha)
        _write_unet(memory)
        return states


class RemoveLoraAction(BasicAction, MemoryMixin):
    """Drops the loaded LoRAs (parts stay blended, as in the JAX package)."""

    def __call__(self, memory=None, **states):
        loader = memory['model_loader']
        loader.overlays.clear()
        loader.scales.clear()
        _write_unet(memory)
        return states


def _hook_plugin(memory, name: str, net: torch.nn.Module, alpha: float) -> None:
    memory['plugins'][name] = (net, alpha)
    memory['pipe'].plugins = list(memory['plugins'].values())


class LoadPluginAction(BasicAction, MemoryMixin):
    """A ControlNet plugin file (``.___.`` keys or a webui ControlNet) into
    the UNet's taps (reference workflow/io.py:13-150). The slot ``name``,
    else the file's first; it runs in the UNet's compute dtype."""

    def __init__(self, path: str, name: str = 'controlnet1', alpha: float = 1.0, **kw):
        super().__init__(**kw)
        self.path, self.name, self.alpha = path, name, float(alpha)

    def __call__(self, memory=None, **states):
        all_states = auto_manager(self.path).load_plugins(self.path, unet_cfg=memory['unet_cfg'])
        st = all_states.get(self.name)
        if st is None and all_states:
            st = next(iter(all_states.values()))
        net = controlnet_from_state(st, memory['unet'], _vae_scale(memory), memory['dtype'],
                                    self.path)
        _hook_plugin(memory, self.name, net, self.alpha)
        return states


class RemovePluginAction(BasicAction, MemoryMixin):
    def __init__(self, name: str = 'controlnet1', **kw):
        super().__init__(**kw)
        self.name = name

    def __call__(self, memory=None, **states):
        memory.get('plugins', {}).pop(self.name, None)
        memory['pipe'].plugins = list(memory.get('plugins', {}).values())
        return states


class BuildPluginAction(BasicAction, MemoryMixin):
    """A fresh plugin (no trained state) into the UNet's taps (reference
    workflow/io.py BuildPluginAction): ``cfg`` a ``_target_`` dict, which
    must resolve (the Trainer's builder dispatch), or none for a ControlNet
    from the UNet's blocks, seeded with 0."""

    def __init__(self, name: str = 'controlnet1', alpha: float = 1.0,
                 cfg: Optional[dict] = None, **kw):
        super().__init__(**kw)
        self.name, self.alpha, self.cfg = name, float(alpha), cfg

    def __call__(self, memory=None, **states):
        spec = dict(self.cfg or {})
        tgt = str(spec.pop('_target_', ''))
        spec.pop('_partial_', None)
        builder = build_controlnet
        if tgt:
            try:
                locate(tgt)
            except Exception as e:
                raise ValueError(f'BuildPluginAction: cannot resolve plugin _target_ {tgt!r}: '
                                 f'{e}') from e
            builder = plugin_builder(tgt)
        gen = torch.Generator(device=memory['device']).manual_seed(0)
        net = builder(gen, memory['unet'], vae_scale=_vae_scale(memory), **spec)
        _hook_plugin(memory, self.name,
                     net.to_compute_dtype(memory['dtype']).eval().requires_grad_(False), self.alpha)
        return states


class InputFeederAction(BasicAction, MemoryMixin):
    """Extra inputs into the states (reference workflow/diffusion.py:19-31):
    ``cond`` (a path, an array or a processor's ``_target_`` dict) becomes
    the plugins' condition [bs, height, width, 3] in [0, 1], which
    ``NoisePredAction`` reads; other keys pass as they are."""

    def __init__(self, ex_inputs: Dict[str, Any], width: int = 512, height: int = 512, **kw):
        super().__init__(**kw)
        self.ex_inputs = ex_inputs
        self.w, self.h = int(width), int(height)

    def __call__(self, memory=None, bs: int = 1, **states):
        out = dict(states)
        for key, node in self.ex_inputs.items():
            if key == 'cond':
                if isinstance(node, dict):
                    node = instantiate(node)
                if not isinstance(node, ControlNetProcessor) and not hasattr(node, 'ndim'):
                    node = ControlNetProcessor(node)
                if isinstance(node, ControlNetProcessor):
                    node = node(width=self.w, height=self.h, batch_size=bs)
                out['cond'] = np.asarray(node, np.float32)
            else:
                out[key] = node
        out['bs'] = bs
        return out


class SaveImageAction(BasicAction):
    def __init__(self, save_root: str = 'output/', image_type: str = 'png', **kw):
        super().__init__(**kw)
        self.save_root, self.image_type = save_root, image_type

    def forward(self, images=None, **states):
        DiskInterface(self.save_root, self.image_type).on_infer_finish(images)
        return {'images': images, **states}


# --------------------------------------------------------------- text ----

class TextHookAction(BasicAction, MemoryMixin):
    """The frontend's N_repeats, clip_skip and final norm (workflow/text.py:11)."""

    def __init__(self, N_repeats: int = 1, clip_skip: int = 0, clip_final_norm: bool = True,
                 **kw):
        super().__init__(**kw)
        self.n, self.skip, self.fn = int(N_repeats), int(clip_skip), bool(clip_final_norm)

    def __call__(self, memory=None, **states):
        fe = memory['frontend']
        fe.n_repeats, fe.clip_skip, fe.clip_final_norm = self.n, self.skip, self.fn
        return states


class TextEncodeAction(BasicAction, MemoryMixin):
    def __init__(self, prompt: Optional[str] = None, negative_prompt: str = '', bs: int = 1,
                 **kw):
        super().__init__(**kw)
        self.prompt, self.neg, self.bs = prompt, negative_prompt, int(bs)

    def __call__(self, memory=None, prompt=None, negative_prompt=None, **states):
        prompt = prompt if prompt is not None else self.prompt
        neg = negative_prompt if negative_prompt is not None else self.neg
        hidden, pooled = memory['frontend'].encode([neg] * self.bs + [prompt] * self.bs,
                                                   emb_ext=memory.get('emb_ext'))
        return {'text_emb': hidden, 'pooled': pooled, 'bs': self.bs, **states}


class AttnMultTextEncodeAction(TextEncodeAction):
    """TextEncodeAction: the frontend always reads the (text:weight)
    attention multipliers (workflow/text.py:48)."""


# ---------------------------------------------------------- diffusion ----

class SeedAction(BasicAction):
    """``rng``: a CPU ``torch.Generator`` seeded with ``seed`` (the clock's
    when none)."""

    def __init__(self, seed: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.seed = seed

    def forward(self, **states):
        seed = self.seed if self.seed is not None else int(time.time()) % (1 << 31)
        return {'rng': torch.Generator().manual_seed(int(seed)), **states}


class PrepareDiffusionAction(BasicAction, MemoryMixin):
    def __init__(self, dtype: str = 'bf16', **kw):
        super().__init__(**kw)

    def __call__(self, memory=None, **states):
        memory.setdefault('schedule', NoiseSchedule.make())
        return states


class MakeTimestepsAction(BasicAction, MemoryMixin):
    """A new ``N_steps`` plan of ``sampler`` (any of ``make_sampler``'s
    names); ``timesteps`` its indices, from ``N_steps - int(N_steps *
    strength)`` on when ``strength`` is set (the plan itself is whole, and
    the latents are not noised, as in the JAX package)."""

    def __init__(self, N_steps: int = 20, sampler: str = 'dpm++_2m',
                 strength: Optional[float] = None, **kw):
        super().__init__(**kw)
        self.n, self.sampler_name, self.strength = int(N_steps), sampler, strength

    def __call__(self, memory=None, **states):
        memory['sampler'] = make_sampler(self.sampler_name, memory['schedule'], self.n)
        ts = list(range(self.n))
        if self.strength is not None:
            ts = ts[self.n - int(self.n * self.strength):]
        return {'timesteps': ts, **states}


def draw_latents(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard normal latents, drawn on the CPU from ``generator``."""
    return torch.randn(tuple(shape), generator=generator)


class MakeLatentAction(BasicAction, MemoryMixin):
    def __init__(self, width: int = 512, height: int = 512, **kw):
        super().__init__(**kw)
        self.w, self.h = int(width), int(height)

    def __call__(self, memory=None, rng=None, bs: int = 1, **states):
        scale = _vae_scale(memory)
        sampler = memory['sampler']
        lat = draw_latents(rng, (bs, self.h // scale, self.w // scale,
                                 memory['vae_cfg'].latent_channels))
        lat = lat.to(memory['device']) * sampler.init_noise_sigma
        state = sampler.init_state(tuple(lat.shape))
        return {'latents': lat, 'sampler_state': state, 'rng': rng, 'bs': bs, **states}


class NoisePredAction(BasicAction, MemoryMixin):
    """Classifier-free guidance as one doubled UNet batch (negative half
    first), ``cond`` doubled with it."""

    def __init__(self, guidance_scale: float = 7.5, **kw):
        super().__init__(**kw)
        self.g = float(guidance_scale)

    def __call__(self, memory=None, latents=None, t=None, text_emb=None, sampler_state=None,
                 **states):
        sampler = memory['sampler']
        i = int(t)
        x_in = sampler.scale_model_input(sampler_state, latents, i)
        B = latents.shape[0]
        kw = {}
        cond = states.get('cond')
        if cond is not None:
            c = torch.as_tensor(np.asarray(cond), dtype=torch.float32).to(latents.device)
            kw['cond'] = torch.cat([c, c])
        eps = memory['unet_apply'](torch.cat([x_in, x_in]),
                                   torch.full((2 * B,), int(sampler.timesteps[i]),
                                              device=latents.device), text_emb, **kw)
        e_n, e_p = eps.float().chunk(2)
        pred = e_n + self.g * (e_p - e_n)
        return {'noise_pred': pred, 'latents': latents, 't': t, 'text_emb': text_emb,
                'sampler_state': sampler_state, **states}


def check_sampler_state(state, latents: torch.Tensor) -> None:
    """A state tensor of another shape than the latents (a multistep
    sampler's history from before a resize) raises."""
    if isinstance(state, (tuple, list)):
        for s in state:
            check_sampler_state(s, latents)
    elif torch.is_tensor(state) and state.dim() == latents.dim() and state.shape != latents.shape:
        raise ValueError(f'the sampler state holds a tensor of shape {tuple(state.shape)} but the '
                         f'latents are {tuple(latents.shape)}: it was made before the latents '
                         'were resized; a loop after a resize needs a stateless sampler such as '
                         'euler (MakeTimestepsAction sampler: euler)')


class SampleAction(BasicAction, MemoryMixin):
    def __call__(self, memory=None, latents=None, noise_pred=None, t=None, sampler_state=None,
                 rng=None, **states):
        check_sampler_state(sampler_state, latents)
        latents, sampler_state, x0 = memory['sampler'].step(sampler_state, noise_pred, int(t),
                                                            latents, rng)
        return {'latents': latents, 'sampler_state': sampler_state, 'rng': rng, 'x0_pred': x0,
                **states}


class DiffusionStepAction(BasicAction, MemoryMixin):
    """NoisePred then Sample (reference workflow/diffusion.py:192-201)."""

    def __init__(self, guidance_scale: float = 7.5, **kw):
        super().__init__(**kw)
        self.pred = NoisePredAction(guidance_scale=guidance_scale)
        self.sample = SampleAction()

    def __call__(self, memory=None, **states):
        return self.sample(memory=memory, **self.pred(memory=memory, **states))


class X0PredAction(BasicAction):
    def forward(self, x0_pred=None, **states):
        return {'latents': x0_pred, 'x0_pred': x0_pred, **states}


# ----------------------------------------------------------------- vae ----

class EncodeAction(BasicAction, MemoryMixin):
    """``images`` as they are -> the posterior's mean times the VAE's
    scaling factor."""

    def __call__(self, memory=None, images=None, rng=None, **states):
        lat = memory['pipe'].encode(np.asarray(images, np.float32)).float()
        return {'latents': lat, 'rng': rng, **states}


class VaeOptimizeAction(BasicAction, MemoryMixin):
    """``slicing`` decodes one sample at a time (reference
    workflow/vae.py:8-23); spatial ``tiling`` is not supported, as in the
    JAX package."""

    def __init__(self, slicing: bool = True, tiling: bool = False, **kw):
        super().__init__(**kw)
        if tiling:
            raise NotImplementedError('VAE spatial tiling is not supported; use slicing '
                                      '(per-sample decodes) instead')
        self.slicing = bool(slicing)

    def __call__(self, memory=None, **states):
        memory['vae_slicing'] = self.slicing
        return states


class DecodeAction(BasicAction, MemoryMixin):
    """``latents`` -> ``images`` numpy [B, H, W, 3] in [0, 1]."""

    def __call__(self, memory=None, latents=None, **states):
        pipe = memory['pipe']
        if memory.get('vae_slicing') and latents.shape[0] > 1:
            img = np.concatenate([pipe.decode(latents[i:i + 1])
                                  for i in range(latents.shape[0])])
        else:
            img = pipe.decode(latents)
        return {'images': img, 'latents': latents, **states}


# --------------------------------------------------------------- utils ----

# jax.image.resize's method names -> its kernels (jax/_src/image/scale.py)
RESIZE_METHODS = {'nearest': 'nearest', 'linear': 'linear', 'bilinear': 'linear',
                  'trilinear': 'linear', 'triangle': 'linear', 'cubic': 'cubic',
                  'bicubic': 'cubic', 'tricubic': 'cubic', 'lanczos3': 'lanczos3',
                  'lanczos5': 'lanczos5'}


def _kernel(kind: str, x: torch.Tensor) -> torch.Tensor:
    """The resize kernel at distances ``x`` >= 0: the triangle, Keys cubic
    (a = -0.5) or Lanczos of radius 3 or 5."""
    if kind == 'linear':
        return torch.clamp(1 - x, min=0)
    if kind == 'cubic':
        out = ((1.5 * x - 2.5) * x) * x + 1
        out = torch.where(x >= 1, ((-0.5 * x + 2.5) * x - 4) * x + 2, out)
        return torch.where(x >= 2, torch.zeros_like(x), out)
    radius = 3.0 if kind == 'lanczos3' else 5.0
    y = radius * torch.sin(torch.pi * x) * torch.sin(torch.pi * x / radius)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, torch.pi ** 2 * x ** 2,
                                                torch.ones_like(x)), torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


def resize_weights(n_in: int, n_out: int, kind: str, device=None) -> torch.Tensor:
    """fp32 [n_out, n_in]: ``compute_weight_mat`` of ``jax.image.resize``
    (transposed). Half-pixel centres; on a shrinking axis the kernel is
    widened by the factor (antialias); each column is normalised by its
    sum (zero where the sum is ~0), and an output whose sample lies outside
    the input gets no weight."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _kernel(kind, (sample[:, None] - src[None, :]).abs() / kernel_scale)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def resize(x: torch.Tensor, height: int, width: int, method: str = 'bilinear') -> torch.Tensor:
    """NHWC ``x`` to [B, height, width, C] as ``jax.image.resize(x, shape,
    method)`` gives it, for each of its methods: 'nearest' picks
    floor((i + 0.5) * in / out); the others apply one fp32 weight matrix an
    axis (``resize_weights``) on ``x``'s device, an axis whose size is kept
    left as it is."""
    kind = RESIZE_METHODS.get(method)
    if kind is None:
        raise ValueError(f'Unknown resize method "{method}"')
    x = x.float()
    h_in, w_in = x.shape[1], x.shape[2]
    if kind == 'nearest':
        for dim, (n_in, n_out) in ((1, (h_in, height)), (2, (w_in, width))):
            if n_in != n_out:
                pos = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
                x = x.index_select(dim, pos.floor().long().to(x.device))
        return x
    if h_in != height:
        x = torch.einsum('oh,bhwc->bowc', resize_weights(h_in, height, kind, x.device), x)
    if w_in != width:
        x = torch.einsum('ow,bhwc->bhoc', resize_weights(w_in, width, kind, x.device), x)
    return x


class LatentResizeAction(BasicAction):
    """The highres fix's latent resize (reference workflow/utils.py:8)."""

    def __init__(self, width: int = 1024, height: int = 1024, scale: int = 8,
                 method: str = 'bilinear', **kw):
        super().__init__(**kw)
        self.w, self.h, self.scale, self.method = width, height, scale, method

    def forward(self, latents=None, **states):
        return {'latents': resize(latents, self.h // self.scale, self.w // self.scale,
                                  self.method).contiguous(), **states}


class ImageResizeAction(BasicAction):
    def __init__(self, width: int = 1024, height: int = 1024, method: str = 'bilinear', **kw):
        super().__init__(**kw)
        self.w, self.h, self.method = width, height, method

    def forward(self, images=None, **states):
        out = resize(torch.from_numpy(np.asarray(images, np.float32)), self.h, self.w, self.method)
        return {'images': out.numpy(), **states}
