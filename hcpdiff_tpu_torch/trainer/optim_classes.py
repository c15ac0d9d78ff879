"""The optimizers beyond ``torch.optim``'s: Lion, Adafactor, AdamW with a
bf16 first moment (``adamw_8bit``), D-Adaptation AdamW and Prodigy, as
``torch.optim.Optimizer`` subclasses that take the steps of the optax
transforms the JAX package builds (``optax.lion``, ``optax.adafactor``,
``scale_by_adam(mu_dtype=bfloat16)`` + ``add_decayed_weights`` +
``scale_by_learning_rate``, ``optax.contrib.dadapt_adamw`` and
``optax.contrib.prodigy``), in optax's order of operations.

The train step sets each parameter group's ``lr`` from its schedule
before ``step()``, as optax evaluates a schedule at the count of updates
made before the current one. The JAX trainer runs one optax instance per
pack key (``optax.multi_transform``), so D-Adaptation's and Prodigy's
distance estimate ``d`` and its sums are kept per parameter group, in the
state of the group's first parameter (``d``, ``numerator``). Every
reduction stays on the parameters' device: ``step()`` makes no host sync.
The update counts are host integers. Under ZeRO a rank holds only some of
a group's parameters: ``group_sum`` (set by ``parallel/zero.py``) then
sums the group's two partial sums over the ranks, once a group a step on
every rank, so each rank updates with the same ``d``.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

_f32 = np.float32


def _pow32(base: float, count: int) -> float:
    """``base ** count`` in float32, as optax computes a bias correction."""
    return float(np.power(_f32(base), _f32(count)))


def _bf16(x: float) -> float:
    """A Python float rounded to bfloat16, as JAX rounds a weakly typed
    scalar that multiplies a bfloat16 array."""
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))


def _trained(group) -> List[torch.Tensor]:
    return [p for p in group['params'] if p.grad is not None]


class _Counted(torch.optim.Optimizer):
    """Keeps each parameter's update count (``step``, a host int) in its
    state, as optax keeps one count per transform."""

    def _count(self, p: torch.Tensor) -> int:
        state = self.state[p]
        state['step'] = state.get('step', 0) + 1
        return state['step']


class Lion(_Counted):
    """``optax.lion``: u = sign((1 - b1) g + b1 m) + wd p, p -= lr u, then
    m = (1 - b2) g + b2 m (sign(0) = 0)."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group['betas']
            for p in _trained(group):
                g, state = p.grad, self.state[p]
                self._count(p)
                m = state.setdefault('exp_avg', torch.zeros_like(p))
                u = torch.sign(g * (1 - b1) + m * b1) + p * group['weight_decay']
                p.add_(u * -group['lr'])
                m.copy_(g * (1 - b2) + m * b2)


class AdamWBf16(_Counted):
    """AdamW with its first moment stored in bfloat16 (the JAX package's
    ``adamw_8bit``: ``scale_by_adam(mu_dtype=bfloat16)``, then
    ``add_decayed_weights``, then ``scale_by_learning_rate``). As in the
    jitted optax step, the new first moment is computed in fp32 from the
    stored bf16 one times b1 rounded to bf16 (XLA keeps the product in
    fp32 and adds it to (1 - b1) g in a fused multiply-add), used unrounded for this update and rounded to bf16 for the
    next; the second moment stays fp32."""

    def __init__(self, params, lr: float = 1e-5, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group['betas']
            b1_bf16 = _bf16(b1)
            for p in _trained(group):
                g, state = p.grad, self.state[p]
                count = self._count(p)
                mu_q = state.setdefault('exp_avg', torch.zeros_like(p, dtype=torch.bfloat16))
                nu = state.setdefault('exp_avg_sq', torch.zeros_like(p))
                # XLA fuses this into one multiply-add: the exact sum, rounded once
                mu = (g.double() * float(_f32(1 - b1)) + mu_q.double() * b1_bf16).float()
                nu.copy_(g * g * (1 - b2) + nu * b2)
                u = (mu / (1 - _pow32(b1, count))) / (
                    torch.sqrt(nu / (1 - _pow32(b2, count))) + group['eps'])
                u = u + p * group['weight_decay']
                p.add_(u * -group['lr'])
                mu_q.copy_(mu)

    def load_state_dict(self, state_dict):
        # torch casts loaded state to each parameter's dtype: the first
        # moment goes back to bf16 (its values are bf16's, so exactly)
        super().load_state_dict(state_dict)
        for state in self.state.values():
            if 'exp_avg' in state:
                state['exp_avg'] = state['exp_avg'].to(torch.bfloat16)


def _factored_dims(shape: Tuple[int, ...], min_dim: int) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the two largest axes (numpy's argsort
    order) where the smaller of them is at least ``min_dim``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Adafactor(_Counted):
    """``optax.adafactor(lr)`` with its defaults: the second moment
    factored into row and column statistics over a parameter's two largest
    axes where both are at least 128 (else kept whole), decay
    1 - (t + 1)^-0.8, eps 1e-30, the update clipped to RMS 1, scaled by lr
    and by the parameter's RMS (at least 1e-3), no momentum, no weight
    decay."""

    MIN_DIM_TO_FACTOR, DECAY, EPS, CLIP_RMS, MIN_SCALE = 128, 0.8, 1e-30, 1.0, 1e-3

    def __init__(self, params, lr: float = 1e-5):
        super().__init__(params, dict(lr=lr))

    @classmethod
    def state_bytes(cls, shape: Tuple[int, ...]) -> int:
        """The bytes of a parameter's state (fp32): its row and column
        statistics where factored, else a whole second moment."""
        n = int(np.prod(shape))
        dims = _factored_dims(tuple(shape), cls.MIN_DIM_TO_FACTOR)
        if dims is None:
            return 4 * n
        return 4 * (n // shape[dims[1]] + n // shape[dims[0]])

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in _trained(group):
                g, state = p.grad, self.state[p]
                count = self._count(p)
                decay = _f32(1) - np.power(_f32(count), _f32(-self.DECAY))
                keep = float(decay)
                fresh = float(_f32(1) - decay)
                g2 = g * g + self.EPS
                dims = _factored_dims(tuple(p.shape), self.MIN_DIM_TO_FACTOR)
                if dims is not None:
                    d1, d0 = dims
                    if 'v_row' not in state:
                        state['v_row'] = torch.zeros_like(g2.mean(d0))
                        state['v_col'] = torch.zeros_like(g2.mean(d1))
                    v_row, v_col = state['v_row'], state['v_col']
                    v_row.copy_(v_row * keep + g2.mean(d0) * fresh)
                    v_col.copy_(v_col * keep + g2.mean(d1) * fresh)
                    reduced = d1 - 1 if d1 > d0 else d1
                    row = (v_row / v_row.mean(reduced, keepdim=True)).pow(-0.5)
                    u = g * row.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
                else:
                    v = state.setdefault('v', torch.zeros_like(p))
                    v.copy_(v * keep + g2 * fresh)
                    u = g * v.pow(-0.5)
                u = u / torch.clamp(_rms(u) / self.CLIP_RMS, min=1.0)
                u = u * group['lr']
                rms = _rms(p)
                u = u * torch.where(rms <= self.MIN_SCALE, torch.full_like(rms, self.MIN_SCALE),
                                    rms)
                p.add_(u * -1)


def _group_sum(values: Iterable[torch.Tensor]) -> torch.Tensor:
    """Leaf values summed in leaf order, as optax's tree reductions add
    them."""
    total = None
    for v in values:
        total = v if total is None else total + v
    return total


class _DistanceAdaptive(_Counted):
    """D-Adaptation and Prodigy share this: the group's estimate ``d``
    (from optax's ``estim_lr0``, 1e-6) and its weighted numerator live, as
    0-d fp32 tensors, in the state of the group's first parameter, with
    the group's count."""

    D0 = 1e-6
    GROUP_KEYS = ('step', 'd', 'numerator')     # the group's state, with its first parameter
    group_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    sum_device: Optional[torch.device] = None

    def _sums(self, *partials: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The group's sums over every rank's parameters (``group_sum``)."""
        if self.group_sum is None:
            return partials
        return tuple(self.group_sum(torch.stack([p.float() for p in partials])))

    def _skip(self) -> None:
        """A group with no parameter to step here still takes its part in
        the ranks' sums."""
        if self.group_sum is not None:
            self.group_sum(torch.zeros(2, device=self.sum_device))

    def _group_state(self, group):
        p0 = group['params'][0]
        head = self.state[p0]
        if 'd' not in head:
            head['d'] = torch.tensor(self.D0, dtype=torch.float32, device=p0.device)
            head['numerator'] = torch.zeros((), dtype=torch.float32, device=p0.device)
        return head, self._count(p0)

    @staticmethod
    def _bias_correction(betas, count: int) -> float:
        b1, b2 = betas
        return float(np.sqrt(_f32(1) - _f32(_pow32(b2, count)))
                     / (_f32(1) - _f32(_pow32(b1, count))))


class DAdaptAdamW(_DistanceAdaptive):
    """``optax.contrib.dadapt_adamw``: AdamW whose step is lr (the
    schedule) times an estimate ``d`` of the distance to the solution,
    grown from ``estim_lr0`` from the group's weighted gradient sums."""

    def __init__(self, params, lr: float = 1.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = _trained(group)
            if not params:
                self._skip()
                continue
            b1, b2 = group['betas']
            sb2, eps = b2 ** 0.5, group['eps']
            head, count = self._group_state(group)
            dlr = head['d'] * group['lr'] * self._bias_correction((b1, b2), count)
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                for key in ('exp_avg', 'exp_avg_sq', 'grad_sum'):
                    st.setdefault(key, torch.zeros_like(p))
            numerator_acum = _group_sum(
                torch.vdot(p.grad.flatten(), (st['grad_sum'] / (torch.sqrt(st['exp_avg_sq'])
                                                                + eps)).flatten())
                for p, st in zip(params, states))
            for p, st in zip(params, states):
                g = p.grad
                st['exp_avg'].copy_(st['exp_avg'] * b1 + (1 - b1) * dlr * g)
                st['exp_avg_sq'].copy_(st['exp_avg_sq'] * b2 + (1 - b2) * g * g)
                st['grad_sum'].copy_(st['grad_sum'] * sb2 + (1 - sb2) * dlr * g)
            l1 = _group_sum(st['grad_sum'].abs().sum() for st in states)
            numerator_acum, l1 = self._sums(numerator_acum, l1)
            head['numerator'] = head['numerator'] * sb2 + (1 - sb2) * dlr * numerator_acum
            head['d'] = torch.maximum(head['d'], head['numerator'] / ((1 - sb2) * l1))
            for p, st in zip(params, states):
                p.add_(-group['weight_decay'] * dlr * p
                       - st['exp_avg'] / (torch.sqrt(st['exp_avg_sq']) + eps))


class Prodigy(_DistanceAdaptive):
    """``optax.contrib.prodigy`` with its defaults (beta3 = sqrt(b2), no
    safeguard warm-up, coefficient 1): D-Adaptation with the gradients
    scaled by ``d`` before the moments, the numerator weighted by the
    distance from the initial parameters (kept as ``params0``) and ``d``'s
    newest value in the update's eps."""

    def __init__(self, params, lr: float = 1.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = _trained(group)
            if not params:
                self._skip()
                continue
            b1, b2 = group['betas']
            b3, d0, eps = b2 ** 0.5, self.D0, group['eps']
            head, count = self._group_state(group)
            d = head['d']
            dlr = d * group['lr'] * self._bias_correction((b1, b2), count)
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                for key in ('exp_avg', 'exp_avg_sq', 'grad_sum'):
                    st.setdefault(key, torch.zeros_like(p))
                st.setdefault('params0', p.detach().clone())
            numerator_acum = _group_sum(torch.vdot(p.grad.flatten(), (st['params0'] - p).flatten())
                                        for p, st in zip(params, states))
            for p, st in zip(params, states):
                dg = d * p.grad
                st['exp_avg'].copy_(st['exp_avg'] * b1 + (1 - b1) * dg)
                st['exp_avg_sq'].copy_(st['exp_avg_sq'] * b2 + (1 - b2) * dg * dg)
                st['grad_sum'].copy_(st['grad_sum'] * b3 + dlr * dg / d0)
            denominator = _group_sum(st['grad_sum'].abs().sum() for st in states)
            numerator_acum, denominator = self._sums(numerator_acum, denominator)
            head['numerator'] = head['numerator'] * b3 + (d / d0) * dlr * numerator_acum
            head['d'] = torch.maximum(d, head['numerator'] / denominator)
            for p, st in zip(params, states):
                p.add_(-group['weight_decay'] * dlr * p
                       - dlr * st['exp_avg'] / (torch.sqrt(st['exp_avg_sq']) + head['d'] * eps))
