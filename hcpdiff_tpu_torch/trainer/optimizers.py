"""Optimizers and learning-rate schedules (counterpart of
``hcpdiff_tpu/trainer/optimizers.py``).

The JAX package builds optax transforms, optionally chained after
``optax.clip_by_global_norm``. Here ``make_optimizer`` returns an
:class:`Optimizer` that binds a ``torch.optim`` optimizer to the trainable
tensors and carries the clip norm, which the train step applies with
optax's formula (:func:`clip_by_global_norm_`). ``adamw``, ``adam`` and
``sgd`` are ``torch.optim``'s; ``lion``, ``adafactor``, ``adamw_8bit``,
``dadapt_adamw`` and ``prodigy`` are ``trainer/optim_classes.py``'s, which
take optax's steps. ``resolve_optimizer`` takes the short names,
``optim.<name>`` and the class paths the JAX registry maps, and raises
for a target it does not know.

``make_schedule`` gives the value of the JAX package's optax schedule at
an update count, computed as optax computes it (float32). optax evaluates
a schedule at the count of updates made *before* the current one, so the
train step sets each parameter group's lr to ``schedule(state.step)``
before it steps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .optim_classes import AdamWBf16, Adafactor, DAdaptAdamW, Lion, Prodigy

Factory = Callable[[Sequence], torch.optim.Optimizer]
Schedule = Callable[[int], float]

_f32 = np.float32


def _cos(x):
    """float32 cosine as XLA computes it, to within an ulp (the float64
    cosine of the float32 argument, rounded)."""
    return np.cos(np.asarray(x, np.float64)).astype(np.float32)


def _constant(value: float) -> Schedule:
    return lambda count: float(_f32(value))


def _polynomial(init: float, end: float, power: float, steps: int, begin: int = 0) -> Schedule:
    """optax.polynomial_schedule (linear_schedule is power 1)."""
    if steps <= 0:
        return _constant(init)

    def schedule(count):
        c = min(max(count - begin, 0), steps)
        frac = _f32(1) - _f32(c) / _f32(steps)
        return float(_f32(init - end) * frac ** _f32(power) + _f32(end))
    return schedule


def _cosine_decay(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    def schedule(count):
        c = _f32(min(count, decay_steps))
        cos = _f32(0.5) * (_f32(1) + _cos(_f32(math.pi) * c / _f32(decay_steps)))
        return float(_f32(init) * (_f32(1 - alpha) * cos + _f32(alpha)))
    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules."""
    def schedule(count):
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            out = out if count < b else s(count - b)
        return out
    return schedule


def _onecycle(steps: int, peak: float, pct_start: float, div_factor: float = 25.0,
              final_div_factor: float = 1e4) -> Schedule:
    """optax.cosine_onecycle_schedule: a piecewise cosine interpolation from
    peak / div_factor up to peak at pct_start, then down to
    peak / (div_factor * final_div_factor) at ``steps``."""
    marks = {int(pct_start * steps): div_factor, int(steps): 1.0 / (div_factor * final_div_factor)}
    bounds = np.asarray([0] + sorted(marks))
    # optax's own mix of precisions: the values in float64, the cosine
    # interpolation in float32, the last value added in float64
    values = np.cumprod([peak / div_factor] + [marks[b] for b in bounds[1:]])

    def schedule(count):
        with np.errstate(divide='ignore', invalid='ignore'):
            pct = ((count - bounds[:-1]) / (bounds[1:] - bounds[:-1])).astype(np.float32)
        start, end = values[:-1], values[1:]
        interp = end.astype(np.float32) + ((start - end) / 2.0).astype(np.float32) * (
            _cos(_f32(math.pi) * pct) + _f32(1))
        hit = (bounds[:-1] <= count) & (count < bounds[1:])
        return float(hit.astype(np.float32).dot(interp) + (bounds[-1] <= count) * values[-1])
    return schedule


def make_schedule(name: str = 'constant', lr: float = 1e-5, warmup_steps: int = 0,
                  training_steps: int = 1000, num_cycles: float = 0.5, power: float = 1.0,
                  min_lr_ratio: float = 0.0, **kw) -> Schedule:
    """The JAX package's ``make_schedule``: count -> lr."""
    name = name.lower()
    span = max(training_steps - warmup_steps, 1)
    if name in ('constant', 'constant_with_warmup'):
        base = _constant(lr)
    elif name == 'linear':
        base = _polynomial(lr, lr * min_lr_ratio, 1.0, span)
    elif name == 'cosine':
        base = _cosine_decay(lr, span, min_lr_ratio)
    elif name == 'cosine_with_restarts':
        n = max(int(num_cycles), 1)
        period = max((training_steps - warmup_steps) // n, 1)
        base = _join([_cosine_decay(lr, period, min_lr_ratio)] * n,
                     [period * i for i in range(1, n)])
    elif name == 'polynomial':
        base = _polynomial(lr, lr * min_lr_ratio, power, span)
    elif name == 'one_cycle':
        return _onecycle(training_steps, lr, pct_start=min(max(
            warmup_steps / max(training_steps, 1), 0.02), 0.5))
    else:
        raise ValueError(f'unknown lr schedule: {name}')
    if warmup_steps > 0:
        return _join([_polynomial(0.0, lr, 1.0, warmup_steps), base], [warmup_steps])
    return base


def adamw(lr: float = 1e-5, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 1e-2, **kw) -> Factory:
    """``torch.optim.AdamW``, which takes the same step as ``optax.adamw``
    (bias-corrected moments, eps outside the square root, decoupled weight
    decay scaled by the learning rate)."""
    return lambda params: torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                                            weight_decay=weight_decay)


def adam(lr: float = 1e-5, betas=(0.9, 0.999), eps: float = 1e-8, **kw) -> Factory:
    """``torch.optim.Adam`` (``optax.adam``; weight decay ignored, as the
    JAX factory ignores it)."""
    return lambda params: torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps)


def sgd(lr: float = 1e-4, momentum: float = 0.9, **kw) -> Factory:
    """``torch.optim.SGD`` with momentum (``optax.sgd``: the first step's
    trace is the gradient, no dampening)."""
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=momentum)


def lion(lr: float = 1e-6, betas=(0.9, 0.99), weight_decay: float = 0.0, **kw) -> Factory:
    """``optax.lion``."""
    return lambda params: Lion(params, lr=lr, betas=tuple(betas), weight_decay=weight_decay)


def adafactor(lr: float = 1e-5, **kw) -> Factory:
    """``optax.adafactor(lr)`` with optax's defaults; betas and weight
    decay are ignored, as the JAX factory ignores them."""
    return lambda params: Adafactor(params, lr=lr)


def adamw_8bit(lr: float = 1e-5, betas=(0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 1e-2, **kw) -> Factory:
    """The JAX package's ``adamw_8bit``: AdamW with a bf16 first moment
    (not quantized to 8 bits)."""
    return lambda params: AdamWBf16(params, lr=lr, betas=tuple(betas), eps=eps,
                                    weight_decay=weight_decay)


def dadapt_adamw(lr: float = 1.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, **kw) -> Factory:
    """``optax.contrib.dadapt_adamw``, ``d`` estimated per parameter group."""
    return lambda params: DAdaptAdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay)


def prodigy(lr: float = 1.0, betas=(0.9, 0.999), eps: float = 1e-8,
            weight_decay: float = 0.0, **kw) -> Factory:
    """``optax.contrib.prodigy``, ``d`` estimated per parameter group."""
    return lambda params: Prodigy(params, lr=lr, betas=tuple(betas), eps=eps,
                                  weight_decay=weight_decay)


OPTIMIZERS = {'adamw': adamw, 'adam': adam, 'lion': lion, 'sgd': sgd, 'adafactor': adafactor,
              'adamw_8bit': adamw_8bit, 'dadapt_adamw': dadapt_adamw, 'prodigy': prodigy}
# the class paths the JAX registry maps (lower case)
_ALIASES = {'torch.optim.adamw': 'adamw', 'torch.optim.adam': 'adam', 'torch.optim.sgd': 'sgd',
            'lion_pytorch.lion': 'lion', 'bitsandbytes.optim.adamw8bit': 'adamw_8bit',
            'dadaptation.dadaptadam': 'dadapt_adamw', 'dadaptation.dadaptadamw': 'dadapt_adamw',
            'prodigyopt.prodigy': 'prodigy',
            'transformers.optimization.adafactor': 'adafactor'}
# class names the JAX resolver takes under any module path
_TAILS = {'adamw8bit': 'adamw_8bit', 'adam8bit': 'adamw_8bit'}


def resolve_optimizer(ocfg) -> tuple:
    """An optimizer config node ``{_target_: name, **kwargs}`` -> (factory,
    kwargs). ``lr`` is dropped (the group lrs drive the schedules). An
    unknown target raises, never falling back to AdamW."""
    spec = dict(ocfg or {})
    tgt = spec.pop('_target_', None)
    spec.pop('_partial_', None)
    spec.pop('lr', None)
    if 'betas' in spec:
        spec['betas'] = tuple(spec['betas'])
    if tgt is None:
        return adamw, spec
    low = str(tgt).lower()
    tail = low.rsplit('.', 1)[-1]
    name = _ALIASES.get(low, _TAILS.get(tail, tail))
    if name in OPTIMIZERS:
        return OPTIMIZERS[name], spec
    raise ValueError(f'cannot resolve optimizer _target_ {tgt!r}; known: '
                     f'{sorted(OPTIMIZERS)}')


@dataclasses.dataclass
class Optimizer:
    factory: Factory
    clip_norm: Optional[float] = None

    def init(self, params: Sequence) -> torch.optim.Optimizer:
        """``params``: tensors, or torch parameter groups (dicts)."""
        return self.factory(list(params))


def make_optimizer(name_or_fn='adamw', lr: float = 1e-5, clip_norm: Optional[float] = None,
                   **kw) -> Optimizer:
    fn = OPTIMIZERS[name_or_fn] if isinstance(name_or_fn, str) else name_or_fn
    return Optimizer(fn(lr, **kw), clip_norm)


def make_pt_optimizer(ocfg, scfg, lr: float, steps: int, clip_norm: Optional[float]
                      ) -> Tuple[Optimizer, Schedule]:
    """The prompt-embedding optimizer (the JAX trainer's ``tx_pt``): the
    ``optimizer_pt`` node's class and kwargs, ``lr`` (the largest of the
    words' lrs) under the ``scheduler_pt`` node's schedule, and its own
    global-norm clip."""
    fn, kw = resolve_optimizer(ocfg)
    schedule = make_schedule(scfg.get('name', 'constant'), lr, int(scfg.get('num_warmup_steps', 0)),
                             int(scfg.get('num_training_steps', steps)))
    return make_optimizer(fn, lr=0.0, clip_norm=clip_norm, **kw), schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(tensors: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``tensors`` in place by max_norm / norm where norm >= max_norm,
    as ``optax.clip_by_global_norm`` does (not
    ``torch.nn.utils.clip_grad_norm_``, which divides by norm + 1e-6).
    Returns the norm before clipping."""
    norm = global_norm(tensors)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for t in tensors:
        t.mul_(factor.to(t.dtype))
    return norm
