"""The ``train`` traffic kind: a closed loop of LoRA training steps from
``trainer/step.py:build_train_step``, the function the program's
``Trainer`` calls, on cached latents.

Set-up builds the one training object (the frozen fp32 text encoder, the
frozen UNet computing in the configuration's dtype with remat, the LoRA
pack, AdamW and the groups' schedules, as ``Trainer.make_train_step``
assembles them) and drives it through the first ``check_steps`` steps by
the window's own call on batches that all differ; the window continues
from there. Every batch, its noise and timesteps, the weights and the
LoRA factors' first values are drawn by the benchmark from the seed and
handed to the program (``draws``) and again to the reference.

The check keeps each of the first steps' losses, each leaf's first
gradient as AdamW took it (its first moment after one step) and each
leaf's change after the first steps, and the plain fp32 reference
(``reference/train.py``) follows the same steps.
"""
from __future__ import annotations

import gc
import hashlib
import math
import statistics
import sys
import time
from typing import Dict, List

import torch

from hcpbench import weights
from hcpbench.counts.model import clip_encode, unet_call
from hcpbench.trace import Ranges

CHECKS = ('loss_rel', 'grad_gap', 'change_gap')
BOS, EOS = 512, 513


def _gen(seed: int, what: str, index: int, device) -> torch.Generator:
    digest = hashlib.sha256(f'{int(seed)}/{what}/{index}'.encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:8], 'little') >> 1)


def make_batch(traffic: dict, seed: int, step: int, device) -> dict:
    """Step ``step``'s batch: latents and 77-token ids (BOS, byte-level
    tokens, EOS)."""
    g = _gen(seed, 'batch', step, device)
    B, n = traffic['batch'], traffic['latent']
    latents = torch.randn(B, n, n, 4, generator=g, device=device)
    body = torch.randint(0, 512, (B, 75), generator=g, device=device)
    ids = torch.cat([torch.full((B, 1), BOS, device=device), body,
                     torch.full((B, 1), EOS, device=device)], dim=1)
    return {'latents': latents, 'input_ids': ids}


def make_draws(traffic: dict, seed: int, step: int, device):
    """Step ``step``'s noise and timesteps."""
    g = _gen(seed, 'draws', step, device)
    B, n = traffic['batch'], traffic['latent']
    return (torch.randn(B, n, n, 4, generator=g, device=device),
            torch.randint(0, 1000, (B,), generator=g, device=device))


def lora_init(module: torch.nn.Module, paths: List[str], rank: int, seed: int, part: str,
              device) -> Dict[str, Dict[str, torch.Tensor]]:
    """LoRA factors of the layers: ``down`` uniform in +-sqrt(6 / fan_in)
    (one draw for all of them), ``up`` zeros, ``alpha`` 1, fp32."""
    shapes = [tuple(module.get_submodule(p).weight.shape) for p in paths]
    fans = [math.prod(s[1:]) for s in shapes]
    flat = torch.rand(sum(rank * f for f in fans), generator=_gen(seed, f'lora_{part}', 0, device),
                      device=device)
    out, pos = {}, 0
    for p, s, f in zip(paths, shapes, fans):
        bound = math.sqrt(6.0 / f)
        down = (flat[pos:pos + rank * f].view(rank, f) * 2 - 1) * bound
        out[p] = {'down': down.clone(), 'up': torch.zeros(s[0], rank, device=device),
                  'alpha': torch.tensor(1.0, device=device)}
        pos += rank * f
    return out


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class Session:
    """The training object built from the configuration, and its steps."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 phases: Dict[str, float], int8: bool = False):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        t = time.perf_counter()
        from hcpdiff_tpu_torch.adapt.overlay import make_lora_overlay
        from hcpdiff_tpu_torch.diffusion.losses import MSELoss
        from hcpdiff_tpu_torch.diffusion.schedules import NoiseSchedule
        from hcpdiff_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
        from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend
        from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
        from hcpdiff_tpu_torch.trainer.assemble import (lora_base_weights, make_te_apply,
                                                        make_unet_apply)
        from hcpdiff_tpu_torch.trainer.optimizers import make_optimizer, make_schedule
        from hcpdiff_tpu_torch.trainer.step import StepConfig, build_train_step, init_train_state
        from hcpdiff_tpu_torch.utils.clip_tokenizer import CLIPTokenizer
        phases['import_program_s'] = time.perf_counter() - t
        if device.type == 'cuda':
            t = time.perf_counter()
            from hcpdiff_tpu_torch.ops import _build
            _build.library()
            phases['kernel_library_s'] = time.perf_counter() - t
        t = time.perf_counter()
        dtype = getattr(torch, config['dtype'])
        tr = traffic
        with torch.device('meta'):
            unet = UNet2DCondition(UNetConfig(**_tuples(config['unet'])), remat=True,
                                   remat_policy=tr['remat_policy'], int8=int8)
            te = CLIPTextModel(CLIPTextConfig(**config['text_encoders'][0]))
        unet = weights.fill(unet.to_empty(device=device), seed, 'unet', dtype)
        te = weights.fill(te.to_empty(device=device), seed, 'text_encoder_0', dtype)
        gen = torch.Generator(device=device).manual_seed(0)
        pack, scales, frozen = {}, {}, {}
        for part, module, spec in (('unet', unet, tr['lora_unet']), ('te', te, tr['lora_te'])):
            overlay, sc = make_lora_overlay(gen, module, [spec])
            drawn = lora_init(module, sorted(overlay), spec['rank'], seed, part, device)
            for path, f in overlay.items():
                for k in ('down', 'up', 'alpha'):
                    f[k].copy_(drawn[path][k])
            pack[f'lora_{part}'], scales[f'lora_{part}'] = overlay, sc
            frozen[part] = lora_base_weights(module, overlay)
        unet.to_compute_dtype(dtype).to(memory_format=torch.channels_last)
        for m in (unet, te):
            m.requires_grad_(False)
        self.frontend = TextEncoderFrontend(CLIPTokenizer.tiny(), te)
        schedule = NoiseSchedule.make()
        self.step_fn = build_train_step(make_unet_apply(unet), self.frontend.encode_ids,
                                        schedule, MSELoss(), StepConfig(), scales,
                                        te_apply=make_te_apply(self.frontend))
        opt = tr['optimizer']
        schedules = {f'lora_{p}': make_schedule(tr['scheduler']['name'], tr[f'lora_{p}']['lr'],
                                                tr['scheduler']['warmup'],
                                                tr['scheduler']['steps'])
                     for p in ('unet', 'te')}
        self.state = init_train_state(
            pack, make_optimizer(opt['name'], lr=0.0, clip_norm=tr['max_grad_norm'],
                                 weight_decay=opt['weight_decay']), schedules=schedules)
        self.unet, self.te, self.frozen = unet, te, frozen
        if device.type == 'cuda':
            torch.cuda.synchronize()
        phases['weights_s'] = time.perf_counter() - t
        self.kept: dict = {}

    def leaves(self) -> Dict[tuple, torch.Tensor]:
        return {(part[5:], path, k): f[k] for part in sorted(self.state.pack)
                for path, f in self.state.pack[part].items() for k in ('alpha', 'down', 'up')}

    def _step(self, index: int):
        batch = make_batch(self.traffic, self.seed, index, self.device)
        draws = [make_draws(self.traffic, self.seed, index, self.device)]
        self.state, metrics = self.step_fn(self.state, self.frozen, batch, draws=draws)
        return metrics['loss']

    def warm(self) -> None:
        """The first ``check_steps`` steps, through the window's own call:
        kept are their losses, each leaf's first gradient from AdamW's state
        and each leaf's change."""
        first = {k: v.detach().clone() for k, v in self.leaves().items()}
        losses = []
        for i in range(self.traffic['check_steps']):
            losses.append(float(self._step(i)))
            if i == 0:
                beta1 = self.state.optimizer.defaults['betas'][0]
                moments = self.state.optimizer.state
                self.kept['grads'] = {
                    k: (moments[v]['exp_avg'] / (1 - beta1)).cpu() if 'exp_avg' in moments[v]
                    else torch.zeros(v.shape) for k, v in self.leaves().items()}
        self.kept['losses'] = losses
        self.kept['changes'] = {k: (v.detach() - first[k]).cpu() for k, v in self.leaves().items()}

    def unit(self, index: int) -> int:
        """Step ``check_steps + index``; returns its samples."""
        self._step(self.traffic['check_steps'] + index)
        return self.traffic['batch']

    def unit_flops(self) -> float:
        """Model operations of one sample: the UNet's and the text encoder's
        forward, times three for forward and backward (remat's recompute not
        counted)."""
        n = self.traffic['latent']
        return 3 * (unet_call(self.config['unet'], 1, n, n, 77)
                    + clip_encode(self.config['text_encoders'][0], 1, 77))

    def ranges(self):
        """The step call in a range, and the UNet's and the text encoder's
        forward in theirs."""
        return _Ranges(self)

    def observe(self, spans: Dict[str, list]):
        """Host milliseconds of each step call until it returns (no
        synchronise)."""
        return _Observe(self, spans)

    def finish(self) -> dict:
        kept = self.kept
        self.state = self.step_fn = self.unet = self.te = self.frozen = self.frontend = None
        self.kept = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        return kept


class _Ranges:
    def __init__(self, session: Session):
        self.session = session

    def __enter__(self):
        s = self.session
        self.step_fn = s.step_fn

        def step(*a, **k):
            with torch.profiler.record_function('hcpbench.train_step'):
                return self.step_fn(*a, **k)
        s.step_fn = step
        self.hooks = []
        for name, m in (('hcpbench.unet', s.unet), ('hcpbench.text_encode', s.te)):
            r = Ranges()
            self.hooks += [m.register_forward_pre_hook(lambda m, a, r=r, n=name: r.enter(n)),
                           m.register_forward_hook(lambda m, a, o, r=r, n=name: r.exit(n))]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        self.session.step_fn = self.step_fn
        return False


class _Observe:
    def __init__(self, session: Session, spans: Dict[str, list]):
        self.session, self.spans = session, spans

    def __enter__(self):
        s = self.session
        self.step_fn = s.step_fn
        times = self.spans.setdefault('step_host_ms', [])

        def step(*a, **k):
            t = time.perf_counter()
            out = self.step_fn(*a, **k)
            times.append((time.perf_counter() - t) * 1e3)
            return out
        s.step_fn = step
        return self

    def __exit__(self, *exc):
        self.session.step_fn = self.step_fn
        return False


def end_to_end(records: List[dict], window_s: float) -> Dict[str, float]:
    """samples_per_s: the samples of every completed step over the window,
    which ends with a synchronise after the last step."""
    return {'samples_per_s': sum(r['units'] for r in records if r['ok']) / window_s}


def norm_gap(program: Dict[tuple, torch.Tensor], reference: Dict[tuple, torch.Tensor],
             keys) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's
    (of the leaves whose reference norm is not 0: at the first step the
    LoRA ``up`` factors are 0, so ``down`` and ``alpha`` have no gradient)."""
    ref = {k: float(reference[k].double().norm()) for k in keys}
    median = statistics.median([v for v in ref.values() if v > 0] or [1.0])
    return max(abs(float(program[k].double().norm()) - ref[k]) / max(ref[k], median)
               for k in keys)


def reference_steps(config: dict, traffic: dict, seed: int, device: torch.device,
                    lower_precision: bool = False):
    """The plain reference's first ``check_steps`` steps from the seed's
    weights, LoRA factors, batches and draws: (what the check compares, as
    ``Session.warm`` keeps it: losses, first gradients, changes; each
    leaf's largest gradient norm). With ``lower_precision`` every Linear
    and Conv2d layer computes one precision below the configuration's
    (``reference/lowp.py``): the control put in the program's place."""
    import contextlib
    from hcpbench.reference.lowp import LowerPrecision
    from hcpbench.reference.models import CLIPText, UNet
    from hcpbench.reference.train import LoraSteps, select_layers
    from hcpbench.reference.txt2img import alphas_cumprod
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, config['dtype'])
    try:
        t0 = time.perf_counter()
        with torch.device('meta'):
            unet, te = UNet(config['unet']), CLIPText(config['text_encoders'][0])
        unet = weights.fill(unet.to_empty(device=device), seed, 'unet', dtype)
        te = weights.fill(te.to_empty(device=device), seed, 'text_encoder_0', dtype)
        unet = unet.to(memory_format=torch.channels_last).requires_grad_(False)
        te.requires_grad_(False)
        lora = {}
        for part, module, spec in (('unet', unet, traffic['lora_unet']),
                                   ('te', te, traffic['lora_te'])):
            lora[part] = lora_init(module, select_layers(module, spec['layers']), spec['rank'],
                                   seed, part, device)
        steps = LoraSteps(unet, te, lora, {p: traffic[f'lora_{p}']['lr'] for p in lora},
                          traffic['scheduler']['warmup'], traffic['optimizer']['weight_decay'],
                          traffic['max_grad_norm'], alphas_cumprod(), EOS,
                          traffic['reference_rows'])
        first = {k: steps.t(k).detach().clone() for k in steps.leaves}
        losses = []
        with LowerPrecision(dtype) if lower_precision else contextlib.nullcontext():
            for i in range(traffic['check_steps']):
                noise, t = make_draws(traffic, seed, i, device)
                losses.append(steps.step(make_batch(traffic, seed, i, device), noise, t))
                if i == 0:
                    grads = {k: v.cpu() for k, v in steps.first_gradients().items()}
        changes = {k: (steps.t(k).detach() - first[k]).cpu() for k in steps.leaves}
        print(f'hcpbench: reference{" in lower precision" if lower_precision else ""} of '
              f'{len(losses)} steps: {time.perf_counter() - t0:.3f} s', file=sys.stderr)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {'losses': losses, 'grads': grads, 'changes': changes}, steps.grad_max


def control(config: dict, traffic: dict, seed: int, device: torch.device) -> dict:
    """What the control puts where the program's kept results go: the
    reference's first steps one precision below the configuration's."""
    return reference_steps(config, traffic, seed, device, lower_precision=True)[0]


def check(kept: dict, config: dict, traffic: dict, seed: int, device: torch.device,
          limits: dict) -> List[tuple]:
    """(name, value, limit): the worst step's relative loss gap, the worst
    leaf's first-gradient gap and the worst moving leaf's change gap, the
    reference following the same first steps."""
    if not kept.get('losses'):
        return [('completed_steps', 0.0, None)]
    ref, grad_max = reference_steps(config, traffic, seed, device)
    grads, changes = ref['grads'], ref['changes']
    if set(grads) != set(kept['grads']):
        return [(k, float('inf'), limits.get(k)) for k in CHECKS]
    # leaves whose gradient is nought to rounding in the reference move by
    # Adam's round-off alone: left out of the change by this rule
    median = statistics.median(grad_max.values())
    moving = [k for k, g in grad_max.items() if g >= 1e-3 * median]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(kept['losses'], ref['losses']))
    return [('loss_rel', loss_rel, limits.get('loss_rel')),
            ('grad_gap', norm_gap(kept['grads'], grads, sorted(grads)), limits.get('grad_gap')),
            ('change_gap', norm_gap(kept['changes'], changes, moving), limits.get('change_gap'))]
