"""The training step (counterpart of ``hcpdiff_tpu/trainer/step.py``).

``build_train_step(...)`` returns ``train_step(state, frozen, batch,
generator)``: noise and timesteps drawn from an explicit
``torch.Generator``, the text encoder (under ``no_grad`` while the pack
trains nothing of it, else with its assembled weights and their
gradient), the UNet's assembled weights and forward, the loss, its
gradient with respect to the pack, gradient accumulation as a loop over
microbatches, the learning rates of the pack's groups from their
schedules, the optimizer step (after optax-style global-norm clipping)
and the EMA. The JAX step is a pure function; here the optimizer updates
the pack's tensors in place, so the returned state is the one passed in,
advanced one step.

Ported: the single-branch (non-DreamArtist) step over ``lora_unet``,
``unet_ft``, ``lora_te`` and ``te_ft``, ``grad_accum``, EMA,
``min_timestep``/``max_timestep``, the three prediction types (through
``NoiseSchedule.target``), ``att_mask`` and ``loss_weight``, and the
metrics ``loss`` and ``grad_norm``. Not yet: DreamArtist, pyramid noise,
SDXL conditioning, ControlNet, prompt-embedding rows and their second
optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..diffusion.schedules import NoiseSchedule
from .assemble import assemble, assemble_te
from .optimizers import Optimizer, clip_by_global_norm_, global_norm


@dataclasses.dataclass
class StepConfig:
    grad_accum: int = 1
    ema_decay: Optional[float] = None   # None or < 0: power ramp (EMA on if state has one)
    ema_power_ramp: bool = True
    max_ema_decay: float = 0.9999
    min_timestep: int = 0
    max_timestep: Optional[int] = None


@dataclasses.dataclass
class TrainState:
    step: int
    pack: Dict[str, Any]                  # trainable trees; every leaf requires grad
    optimizer: torch.optim.Optimizer      # bound to the pack's leaves
    clip_norm: Optional[float]
    ema: Optional[Dict[str, Any]]
    schedules: Optional[List[Callable[[int], float]]] = None   # lr of each param group


def pack_leaves(tree: Mapping[str, Any]) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order."""
    out: List[torch.Tensor] = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(pack_leaves(value) if isinstance(value, Mapping) else [value])
    return out


def init_train_state(pack: Dict[str, Any], optimizer: Optimizer, use_ema: bool = False,
                     schedules: Optional[Mapping[str, Callable[[int], float]]] = None
                     ) -> TrainState:
    """Marks every leaf of ``pack`` trainable and binds the optimizer to
    them; the EMA starts as a copy of the pack. ``schedules`` ({pack key:
    count -> lr}) gives each pack key a parameter group of its own whose
    lr follows its schedule; without it one group takes the optimizer's lr."""
    leaves = pack_leaves(pack)
    for t in leaves:
        t.requires_grad_(True)
    params, group_schedules = leaves, None
    if schedules is not None:
        keys = sorted(pack)
        params = [{'params': pack_leaves({k: pack[k]}), 'lr': schedules[k](0)} for k in keys]
        group_schedules = [schedules[k] for k in keys]

    def copy(tree):
        return {k: copy(v) if isinstance(v, Mapping) else v.detach().clone()
                for k, v in tree.items()}
    return TrainState(step=0, pack=pack, optimizer=optimizer.init(params),
                      clip_norm=optimizer.clip_norm, ema=copy(pack) if use_ema else None,
                      schedules=group_schedules)


def build_train_step(unet_apply: Callable, te_encode: Callable, schedule: NoiseSchedule,
                     criterion, cfg: StepConfig,
                     lora_scales: Optional[Dict[str, Dict[str, float]]] = None,
                     te_apply: Optional[Callable] = None):
    """Returns ``train_step(state, frozen, batch, generator=None, draws=None)``.

    unet_apply(params, x, t, ctx) -> prediction; ``params`` are the merged
    weights by state-dict name (``trainer/assemble.py:make_unet_apply``).
    te_encode(input_ids, token_mult) -> (ctx, pooled), run under no_grad
    while the pack holds no text-encoder key; te_apply(params,
    input_ids, token_mult) (``make_te_apply``) runs it with the assembled
    weights otherwise.
    frozen: {'unet': ..., 'te': ...}, each {state-dict name: fp32 base
    weight} for the weights the pack's LoRA merges into.
    batch: {'latents': [B, h, w, 4], 'input_ids': [B, S], 'token_mult',
    'att_mask' [B, h, w], 'loss_weight' [] or [B] optional}; with
    grad_accum > 1 every entry has a leading [grad_accum] axis.
    draws: optional [(noise, t)] per microbatch, used instead of drawing
    from ``generator`` (the tests feed the JAX package's draws).
    ``train_step.forward_loss(pack, frozen, batch, noise, t)`` is the
    scalar loss of one microbatch.
    """
    T = schedule.num_train_timesteps
    t_hi = cfg.max_timestep or T

    def forward_loss(pack, frozen, batch, noise, t) -> torch.Tensor:
        latents = batch['latents']
        noisy = schedule.add_noise(latents, noise, t)
        target = schedule.target(latents, noise, t)
        te_params = assemble_te(frozen.get('te', {}), pack, lora_scales)
        if te_params:
            ctx, _ = te_apply(te_params, batch['input_ids'], batch.get('token_mult'))
        else:
            with torch.no_grad():
                ctx, _ = te_encode(batch['input_ids'], batch.get('token_mult'))
        pred = unet_apply(assemble(frozen.get('unet', {}), pack, lora_scales), noisy, t, ctx)
        loss = criterion(pred, target, t)
        if batch.get('att_mask') is not None:
            loss = loss * batch['att_mask'][..., None]
        if batch.get('loss_weight') is not None:
            lw = torch.as_tensor(batch['loss_weight'], device=loss.device)
            loss = loss * lw.reshape((-1,) + (1,) * (loss.dim() - 1))
        return loss.mean()

    def draw(latents: torch.Tensor, generator: torch.Generator
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = generator.device
        noise = torch.randn(latents.shape, generator=generator, device=dev)
        t = torch.randint(cfg.min_timestep, t_hi, (latents.shape[0],), generator=generator,
                          device=dev)
        return noise.to(latents.device), t.to(latents.device)

    def ema_decay(step: int) -> float:
        if cfg.ema_decay is None or cfg.ema_decay < 0 or cfg.ema_power_ramp:
            d = min((1.0 + step) / (10.0 + step), cfg.max_ema_decay)
            if cfg.ema_decay and cfg.ema_decay > 0:
                d = min(d, cfg.ema_decay)
            return d
        return cfg.ema_decay

    def train_step(state: TrainState, frozen: Mapping[str, Any], batch: Mapping[str, Any],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves = pack_leaves(state.pack)
        grads = [torch.zeros_like(p) for p in leaves]
        loss_sum = 0.0
        for i in range(cfg.grad_accum):
            mb = batch if cfg.grad_accum == 1 else {
                k: (v[i] if v is not None else None) for k, v in batch.items()}
            noise, t = draws[i] if draws is not None else draw(mb['latents'], generator)
            loss = forward_loss(state.pack, frozen, mb, noise, t)
            for acc, g in zip(grads, torch.autograd.grad(loss, leaves, allow_unused=True)):
                if g is not None:
                    acc.add_(g)
            loss_sum = loss_sum + loss.detach()
        if cfg.grad_accum > 1:
            for g in grads:
                g.div_(cfg.grad_accum)
        metrics = {'loss': loss_sum / cfg.grad_accum, 'grad_norm': global_norm(grads)}
        if state.clip_norm:
            clip_by_global_norm_(grads, state.clip_norm)
        for p, g in zip(leaves, grads):
            p.grad = g
        for group, lr in zip(state.optimizer.param_groups, state.schedules or ()):
            group['lr'] = lr(state.step)      # optax: the count before this update
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        if state.ema is not None:
            d = ema_decay(state.step)
            with torch.no_grad():
                for e, p in zip(pack_leaves(state.ema), leaves):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        return state, metrics

    train_step.forward_loss = forward_loss
    return train_step
