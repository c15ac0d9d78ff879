"""Optimizer factories (counterpart of ``hcpdiff_tpu/trainer/optimizers.py``).

The JAX package builds optax transforms, optionally chained after
``optax.clip_by_global_norm``. Here ``make_optimizer`` returns an
:class:`Optimizer` that binds a ``torch.optim`` optimizer to the trainable
tensors and carries the clip norm, which the train step applies with
optax's formula (:func:`clip_by_global_norm_`). Only ``adamw`` is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

Factory = Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]


def adamw(lr: float = 1e-5, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 1e-2, **kw) -> Factory:
    """``torch.optim.AdamW``, which takes the same step as ``optax.adamw``
    (bias-corrected moments, eps outside the square root, decoupled weight
    decay scaled by the learning rate)."""
    return lambda params: torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                                            weight_decay=weight_decay)


OPTIMIZERS = {'adamw': adamw}


@dataclasses.dataclass
class Optimizer:
    factory: Factory
    clip_norm: Optional[float] = None

    def init(self, params: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
        return self.factory(list(params))


def make_optimizer(name_or_fn='adamw', lr: float = 1e-5, clip_norm: Optional[float] = None,
                   **kw) -> Optimizer:
    fn = OPTIMIZERS[name_or_fn] if isinstance(name_or_fn, str) else name_or_fn
    return Optimizer(fn(lr, **kw), clip_norm)


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
