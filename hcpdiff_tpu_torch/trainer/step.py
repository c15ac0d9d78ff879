"""The training step (counterpart of ``hcpdiff_tpu/trainer/step.py``).

``build_train_step(...)`` returns ``train_step(state, frozen, batch,
generator)``: noise and timesteps drawn from an explicit
``torch.Generator``, the text encoder (under ``no_grad`` while the pack
trains nothing of it, else with its assembled weights and their
gradient), the UNet's assembled weights and forward, the loss, its
gradient with respect to the pack, gradient accumulation as a loop over
microbatches, the learning rates of the pack's groups from their
schedules, the optimizer step (after optax-style global-norm clipping)
and the EMA. Given ``parallel`` (``parallel/zero.py:DataParallel``), the
batch is this rank's block of the global batch: the noise and timesteps
are drawn (or fed) for the global batch and the rank keeps its block,
the gradients and the loss are reduced over the data axis after the
``grad_accum`` loop, the global norm sums every rank's partials, and
under ZeRO each optimizer steps only the rank's leaves. The JAX step is
a pure function; here the optimizer updates
the pack's tensors in place, so the returned state is the one passed in,
advanced one step.

Ported: ``lora_unet``, ``unet_ft``, ``lora_te``, ``te_ft``, SDXL's
``lora_te2``/``te2_ft`` (with the pooled embedding and ``time_ids``, zeros
when the batch has none), the prompt-tuning rows ``emb`` (updated by a
second optimizer with its own clip, as the JAX step's ``tx_pt``),
DreamArtist's two branches (the ids laid out [neg..., pos...], ``pred =
e_n + scale * (e_p - e_n)`` with the scale ramped over t / T), pyramid
noise, ``grad_accum``, EMA (over the whole pack), ``min_timestep``/
``max_timestep``, the three prediction types (through
``NoiseSchedule.target``), ``att_mask`` and ``loss_weight``, ControlNet
(``controlnet``: its fp32 weights, run by ``controlnet_apply`` on the
noisy latents, t, the context and the batch's ``cond``, its residuals fed
to the frozen UNet's taps), and the metrics ``loss`` and ``grad_norm``
(over the whole pack).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import math

import torch

from ..diffusion.schedules import NoiseSchedule, pyramid_noise
from .assemble import assemble, assemble_te, assemble_te2
from .optimizers import Optimizer, clip_by_global_norm_, global_norm


def is_pt_key(key: str) -> bool:
    """Pack keys the prompt-embedding optimizer updates."""
    return key.startswith('emb')


@dataclasses.dataclass
class StepConfig:
    grad_accum: int = 1
    ema_decay: Optional[float] = None   # None or < 0: power ramp (EMA on if state has one)
    ema_power_ramp: bool = True
    max_ema_decay: float = 0.9999
    min_timestep: int = 0
    max_timestep: Optional[int] = None
    noise_kind: str = 'gaussian'        # | 'pyramid'
    pyramid_discount: float = 0.9
    dream_artist: bool = False
    da_cfg_low: float = 1.0
    da_cfg_high: float = 3.0
    da_cfg_ramp: str = 'cos'            # cos | cos2 | ln | linear


@dataclasses.dataclass
class TrainState:
    step: int
    pack: Dict[str, Any]                  # trainable trees; every leaf requires grad
    optimizer: Optional[torch.optim.Optimizer]   # bound to the model keys' leaves
    clip_norm: Optional[float]
    ema: Optional[Dict[str, Any]]
    schedules: Optional[List[Callable[[int], float]]] = None   # lr of each param group
    # the prompt-embedding optimizer over the ``emb*`` keys, its clip and lr
    optimizer_pt: Optional[torch.optim.Optimizer] = None
    clip_norm_pt: Optional[float] = None
    schedule_pt: Optional[Callable[[int], float]] = None


def da_scale(t: torch.Tensor, T: int, lo: float, hi: float, ramp: str) -> torch.Tensor:
    """DreamArtist's CFG scale at each timestep: lo + (hi - lo) * w(t / T)
    (the JAX step's ``_da_scale``)."""
    r = t.float() / T
    if ramp == 'cos':
        w = (1 - torch.cos(math.pi * r)) / 2
    elif ramp == 'cos2':
        w = (1 - torch.cos(math.pi * r ** 2)) / 2
    elif ramp == 'ln':
        w = torch.log1p((math.e - 1) * r)
    else:
        w = r
    return lo + (hi - lo) * w


def pack_leaves(tree: Mapping[str, Any]) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order."""
    out: List[torch.Tensor] = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(pack_leaves(value) if isinstance(value, Mapping) else [value])
    return out


def optimizer_groups(pack: Mapping[str, Any], per_key: bool
                     ) -> Tuple[List[List[int]], List[List[int]]]:
    """The parameter groups of the model keys' optimizer (one a key under
    ``per_key``, else one) and of the prompt-embedding one, as indices
    into ``pack_leaves(pack)``."""
    model, pt, pos = [], [], 0
    for key in sorted(pack):
        n = len(pack_leaves({key: pack[key]}))
        idx = list(range(pos, pos + n))
        pos += n
        if is_pt_key(key):
            pt = [(pt[0] if pt else []) + idx]
        elif per_key or not model:
            model.append(idx)
        else:
            model[0] += idx
    return model, pt


def init_train_state(pack: Dict[str, Any], optimizer: Optimizer, use_ema: bool = False,
                     schedules: Optional[Mapping[str, Callable[[int], float]]] = None,
                     optimizer_pt: Optional[Optimizer] = None,
                     schedule_pt: Optional[Callable[[int], float]] = None,
                     owned: Optional[Sequence[bool]] = None) -> TrainState:
    """Marks every leaf of ``pack`` trainable and binds the optimizer to
    the model keys' leaves and ``optimizer_pt`` (lr ``schedule_pt``) to
    the ``emb*`` keys'; the EMA starts as a copy of the pack.
    ``schedules`` ({pack key: count -> lr}) gives each model key a
    parameter group of its own whose lr follows its schedule; without it
    one group takes the optimizer's lr. ``owned`` (ZeRO, one flag a leaf of
    ``pack_leaves(pack)``) binds the optimizers to those leaves only; each
    group keeps its place, empty where the rank owns none of it."""
    leaves = pack_leaves(pack)
    for t in leaves:
        t.requires_grad_(True)
    keep = owned if owned is not None else [True] * len(leaves)
    model_groups, pt_groups = optimizer_groups(pack, schedules is not None)
    model = sorted(k for k in pack if not is_pt_key(k))
    groups = [[leaves[i] for i in g if keep[i]] for g in model_groups]
    params, group_schedules = (groups[0] if groups else []), None
    if schedules is not None:
        params = [{'params': g, 'lr': schedules[k](0)} for g, k in zip(groups, model)]
        group_schedules = [schedules[k] for k in model]
    elif owned is not None:
        params = [{'params': params}]
    opt_pt = None
    if pt_groups:
        if optimizer_pt is None:
            raise ValueError(f'pack keys {sorted(k for k in pack if is_pt_key(k))} need the '
                             'prompt-embedding optimizer')
        rows = [leaves[i] for i in pt_groups[0] if keep[i]]
        opt_pt = optimizer_pt.init(rows if owned is None else [{'params': rows}])
        if schedule_pt is not None:
            opt_pt.param_groups[0]['lr'] = schedule_pt(0)

    def copy(tree):
        return {k: copy(v) if isinstance(v, Mapping) else v.detach().clone()
                for k, v in tree.items()}
    return TrainState(step=0, pack=pack, optimizer=optimizer.init(params) if model else None,
                      clip_norm=optimizer.clip_norm, ema=copy(pack) if use_ema else None,
                      schedules=group_schedules, optimizer_pt=opt_pt,
                      clip_norm_pt=optimizer_pt.clip_norm if optimizer_pt else None,
                      schedule_pt=schedule_pt)


def build_train_step(unet_apply: Callable, te_encode: Callable, schedule: NoiseSchedule,
                     criterion, cfg: StepConfig,
                     lora_scales: Optional[Dict[str, Dict[str, float]]] = None,
                     te_apply: Optional[Callable] = None,
                     controlnet_apply: Optional[Callable] = None,
                     parallel=None):
    """Returns ``train_step(state, frozen, batch, generator=None, draws=None)``.

    unet_apply(params, x, t, ctx, **extra) -> prediction; ``params`` are
    the merged weights by state-dict name (``trainer/assemble.py:make_unet_apply``),
    ``extra`` SDXL's ``pooled_text_emb`` and ``time_ids``.
    te_encode(input_ids, token_mult) -> (ctx, pooled), run under no_grad
    while the pack holds no text-encoder key and no ``emb*`` rows;
    te_apply(params, input_ids, token_mult, emb_ext) (``make_te_apply``)
    runs it with the assembled weights otherwise (SDXL: ``params`` =
    {'te': ..., 'te2': ...}).
    controlnet_apply(params, x, t, ctx, cond) -> (down residuals, mid
    residual) runs the pack's ``controlnet`` weights where the batch has
    ``cond`` [B, H, W, 3] (not under DreamArtist, as in the JAX step).
    frozen: {'unet': ..., 'te': ...[, 'te2': ...]}, each {state-dict
    name: fp32 base weight} for the weights the pack's LoRA merges into;
    a 'te2' entry makes the step SDXL's.
    batch: {'latents': [B, h, w, 4], 'input_ids': [B, S] (DreamArtist: [2B,
    S], negative prompts first), 'token_mult', 'att_mask' [B, h, w],
    'loss_weight' [] or [B], 'time_ids' [B, 6], 'cond' optional}; with grad_accum
    > 1 every entry has a leading [grad_accum] axis.
    draws: optional [(noise, t)] per microbatch, used instead of drawing
    from ``generator`` (the tests feed the JAX package's draws); under
    ``parallel`` they are the global batch's.
    ``train_step.forward_loss(pack, frozen, batch, noise, t)`` is the
    scalar loss of one microbatch.
    """
    T = schedule.num_train_timesteps
    t_hi = cfg.max_timestep or T

    def forward_loss(pack, frozen, batch, noise, t) -> torch.Tensor:
        latents = batch['latents']
        B = latents.shape[0]
        noisy = schedule.add_noise(latents, noise, t)
        target = schedule.target(latents, noise, t)
        sdxl = 'te2' in frozen

        def encode(ids, tm, branch):
            te_params = assemble_te(frozen.get('te', {}), pack, lora_scales, branch)
            if sdxl:
                te_params = {'te': te_params, 'te2': assemble_te2(frozen['te2'], pack,
                                                                  lora_scales, branch)}
            ext = pack.get('emb')
            if ext is not None or any(te_params.values() if sdxl else te_params):
                return te_apply(te_params, ids, tm, emb_ext=ext)
            with torch.no_grad():
                return te_encode(ids, tm)

        def unet(ids, tm, branch):
            ctx, pooled = encode(ids, tm, branch)
            extra = {}
            if sdxl:
                tid = batch.get('time_ids')
                extra = {'pooled_text_emb': pooled,
                         'time_ids': tid if tid is not None else torch.zeros(
                             B, 6, device=latents.device)}
            if (controlnet_apply is not None and 'controlnet' in pack and not cfg.dream_artist
                    and batch.get('cond') is not None):
                down, mid = controlnet_apply(pack['controlnet'], noisy, t, ctx, batch['cond'])
                extra.update(down_residuals=down, mid_residual=mid)
            return unet_apply(assemble(frozen.get('unet', {}), pack, lora_scales, branch),
                              noisy, t, ctx, **extra)

        ids, tm = batch['input_ids'], batch.get('token_mult')
        if cfg.dream_artist:
            e_n = unet(ids[:B], None if tm is None else tm[:B], 'neg')
            e_p = unet(ids[B:], None if tm is None else tm[B:], 'pos')
            scale = da_scale(t, T, cfg.da_cfg_low, cfg.da_cfg_high, cfg.da_cfg_ramp)
            pred = e_n + scale.reshape((-1,) + (1,) * (e_n.dim() - 1)) * (e_p - e_n)
        else:
            pred = unet(ids, tm, 'pos')
        loss = criterion(pred, target, t)
        if batch.get('att_mask') is not None:
            loss = loss * batch['att_mask'][..., None]
        if batch.get('loss_weight') is not None:
            lw = torch.as_tensor(batch['loss_weight'], device=loss.device)
            loss = loss * lw.reshape((-1,) + (1,) * (loss.dim() - 1))
        return loss.mean()

    def draw(latents: torch.Tensor, generator: torch.Generator
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The noise and timesteps of the global batch (``parallel``: the
        local batch times the data axis)."""
        dev = generator.device
        shape = latents.shape
        if parallel is not None:
            shape = (shape[0] * parallel.n,) + tuple(shape[1:])
        if cfg.noise_kind == 'pyramid':
            noise = pyramid_noise(generator, shape, cfg.pyramid_discount)
        else:
            noise = torch.randn(shape, generator=generator, device=dev)
        t = torch.randint(cfg.min_timestep, t_hi, (shape[0],), generator=generator, device=dev)
        return noise.to(latents.device), t.to(latents.device)

    def ema_decay(step: int) -> float:
        if cfg.ema_decay is None or cfg.ema_decay < 0 or cfg.ema_power_ramp:
            d = min((1.0 + step) / (10.0 + step), cfg.max_ema_decay)
            if cfg.ema_decay and cfg.ema_decay > 0:
                d = min(d, cfg.ema_decay)
            return d
        return cfg.ema_decay

    def update(optimizer, pairs, clip_norm, lrs, norm):
        """optax's chain over these (param, grad) pairs: clip the gradients
        by the global ``norm`` of the optimizer's gradients, then one
        optimizer step at the groups' lrs."""
        if optimizer is None:
            return
        grads = [g for _, g in pairs]
        if clip_norm:
            clip_by_global_norm_(grads, clip_norm, norm=norm)
        for (p, _), g in zip(pairs, grads):
            p.grad = g
        for group, lr in zip(optimizer.param_groups, lrs):
            group['lr'] = lr
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def train_step(state: TrainState, frozen: Mapping[str, Any], batch: Mapping[str, Any],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves = pack_leaves(state.pack)
        ema = pack_leaves(state.ema) if state.ema is not None else None
        if parallel is not None:
            parallel.gather(leaves)
        grads = [torch.zeros_like(p) for p in leaves]
        loss_sum = 0.0
        for i in range(cfg.grad_accum):
            mb = batch if cfg.grad_accum == 1 else {
                k: (v[i] if v is not None else None) for k, v in batch.items()}
            noise, t = draws[i] if draws is not None else draw(mb['latents'], generator)
            if parallel is not None:
                noise, t = parallel.block(noise), parallel.block(t)
            loss = forward_loss(state.pack, frozen, mb, noise, t)
            for acc, g in zip(grads, torch.autograd.grad(loss, leaves, allow_unused=True)):
                if g is not None:
                    acc.add_(g)
            loss_sum = loss_sum + loss.detach()
        if cfg.grad_accum > 1:
            for g in grads:
                g.div_(cfg.grad_accum)
        loss = loss_sum / cfg.grad_accum
        # the model keys and the emb* keys, each under its own optimizer;
        # optax evaluates a schedule at the count before this update
        pt = [is_pt_key(k) for k in sorted(state.pack) for _ in pack_leaves({k: state.pack[k]})]
        if parallel is None:
            grad_norm = global_norm(grads)
        else:
            grads, loss = parallel.reduce_grads(grads, loss)
        # each optimizer's squared norm over the gradients this rank holds
        sq = [sum(g.float().square().sum() for g, e in zip(grads, pt) if e == want
                  and g is not None) for want in (False, True)]
        sq = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=leaves[0].device)
                          for x in sq])
        if parallel is not None:
            sq, loss = parallel.global_sums(sq, loss)
            grad_norm = torch.sqrt(sq.sum())
        metrics = {'loss': loss, 'grad_norm': grad_norm}
        pairs = [(p, g, e) for p, g, e in zip(leaves, grads, pt) if g is not None]
        update(state.optimizer, [(p, g) for p, g, e in pairs if not e], state.clip_norm,
               [lr(state.step) for lr in state.schedules or ()], torch.sqrt(sq[0]))
        update(state.optimizer_pt, [(p, g) for p, g, e in pairs if e], state.clip_norm_pt,
               [state.schedule_pt(state.step)] if state.schedule_pt else [], torch.sqrt(sq[1]))
        if parallel is not None:
            parallel.after_update(leaves)
        state.step += 1
        if ema is not None:
            d = ema_decay(state.step)
            with torch.no_grad():
                for e, p in zip(ema, leaves):
                    if e.numel():
                        e.mul_(d).add_(p, alpha=1.0 - d)
        if parallel is not None:
            parallel.release(leaves, ema or [])
        return state, metrics

    train_step.forward_loss = forward_loss
    return train_step
