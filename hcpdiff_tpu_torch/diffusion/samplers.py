"""Inference samplers (counterpart of ``hcpdiff_tpu/diffusion/samplers.py``).

The JAX samplers are pure functions stepped inside ``lax.scan``; here the
denoise loop is an eager Python loop, so a step index is a Python int and
the sigma and alpha tables are read on the host. Latents and model outputs
are fp32 tensors on any device. Ported: DDIM, DDPM, Euler, Euler
ancestral, DPM++ 2M and DPM++ 2M SDE; ``make_sampler`` raises
``NotImplementedError`` for the JAX package's other samplers.

Sampler protocol, as in the JAX package:

- ``timesteps``: int64 numpy array [N] of descending training timesteps;
- ``init_state(shape)`` -> the state carried from step to step;
- ``scale_model_input(state, x, i)``;
- ``step(state, model_out, i, x, generator=None)`` -> (x_prev, new_state,
  x0_pred). The stochastic samplers (DDPM, Euler ancestral, DPM++ 2M SDE,
  DDIM with eta > 0) draw their noise from ``generator``, a CPU
  ``torch.Generator`` (the JAX ``rng``), so that one seed gives one image
  on any device; without one they add none, as the JAX samplers do
  without an ``rng`` (DDPM needs one);
- ``slice_for_partial(t_start)``: cut the plan for an img2img/inpaint
  loop that starts at transfer index ``t_start``.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .schedules import NoiseSchedule


def draw_noise(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard normal noise shaped like ``x``, drawn on the CPU from
    ``generator`` and moved to ``x``'s device."""
    return torch.randn(x.shape, generator=generator, dtype=torch.float32).to(x.device)


class BaseSampler:
    """Timestep plan over a noise schedule."""

    def __init__(self, schedule: NoiseSchedule, num_steps: int,
                 spacing: str = 'leading', steps_offset: int = 1):
        self.schedule = schedule
        self.num_steps = int(num_steps)
        T = schedule.num_train_timesteps
        if spacing == 'leading':
            ratio = T // self.num_steps
            ts = (np.arange(0, self.num_steps) * ratio).round()[::-1].astype(np.int64)
            ts = ts + steps_offset
        elif spacing == 'linspace':
            ts = np.linspace(0, T - 1, self.num_steps).round()[::-1].astype(np.int64)
        elif spacing == 'trailing':
            ts = np.arange(T, 0, -T / self.num_steps).round().astype(np.int64) - 1
        else:
            raise ValueError(spacing)
        self.timesteps = np.clip(ts, 0, T - 1)
        self.step_stride = max(T // self.num_steps, 1)

    def init_state(self, shape: Tuple[int, ...]) -> Any:
        return None

    def scale_model_input(self, state: Any, x: torch.Tensor, i: int) -> torch.Tensor:
        return x

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def slice_for_partial(self, t_start: int) -> int:
        """Slice the plan in place for an img2img/inpaint loop starting at
        transfer index ``t_start``; multistep history restarts (the order
        ramps from 1), as in the JAX package. Returns the timestep at which
        the init latents are noised."""
        if t_start <= 0:
            return int(self.timesteps[0])
        t0 = int(self.timesteps[t_start])
        self.timesteps = self.timesteps[t_start:]
        self.num_steps = self.num_steps - int(t_start)
        return t0

    def _acp(self, t: int) -> float:
        """alphas_cumprod[t], and 1 before the first training step."""
        return float(self.schedule.alphas_cumprod[t]) if t >= 0 else 1.0

    def _x0_eps(self, model_out: torch.Tensor, x: torch.Tensor, t: int):
        """(x0, eps) from the model output under the prediction type."""
        a = self._acp(t)
        sa, sb = a ** 0.5, (1 - a) ** 0.5
        pt = self.schedule.prediction_type
        if pt == 'epsilon':
            return (x - sb * model_out) / sa, model_out
        if pt == 'v_prediction':
            return sa * x - sb * model_out, sa * model_out + sb * x
        if pt == 'sample':
            return model_out, (x - sa * model_out) / sb
        raise ValueError(pt)


class DDIMSampler(BaseSampler):
    """DDIM; deterministic at eta = 0 (the default)."""

    def __init__(self, schedule: NoiseSchedule, num_steps: int, eta: float = 0.0, **kw):
        super().__init__(schedule, num_steps, **kw)
        self.eta = float(eta)

    def step(self, state, model_out, i, x, generator=None):
        t = int(self.timesteps[i])
        t_prev = t - self.step_stride
        a_t, a_prev = self._acp(t), self._acp(t_prev)
        x0, eps = self._x0_eps(model_out, x, t)
        sigma = 0.0
        if self.eta > 0.0 and generator is not None:
            sigma = self.eta * ((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)) ** 0.5
        x_prev = a_prev ** 0.5 * x0 + max(1 - a_prev - sigma ** 2, 0.0) ** 0.5 * eps
        if sigma > 0.0:
            x_prev = x_prev + sigma * draw_noise(x, generator)
        return x_prev, state, x0


class DDPMSampler(BaseSampler):
    """DDPM ancestral sampling over the plan's timesteps; needs a generator."""

    def step(self, state, model_out, i, x, generator=None):
        if generator is None:
            raise ValueError('DDPM draws noise at every step: pass a generator')
        t = int(self.timesteps[i])
        t_prev = t - self.step_stride
        a_t, a_prev = self._acp(t), self._acp(t_prev)
        x0, _ = self._x0_eps(model_out, x, t)
        cur_alpha = a_t / a_prev
        cur_beta = 1 - cur_alpha
        mean = (a_prev ** 0.5 * cur_beta / (1 - a_t)) * x0 \
            + (cur_alpha ** 0.5 * (1 - a_prev) / (1 - a_t)) * x
        noise = draw_noise(x, generator)
        if t_prev < 0:
            return mean, state, x0
        var = max((1 - a_prev) / (1 - a_t) * cur_beta, 1e-20)
        return mean + var ** 0.5 * noise, state, x0


class KSamplerBase(BaseSampler):
    """Karras-style sigma-space samplers."""

    def __init__(self, schedule: NoiseSchedule, num_steps: int,
                 use_karras_sigmas: bool = False, spacing: str = 'linspace', **kw):
        super().__init__(schedule, num_steps, spacing=spacing, **kw)
        acp = schedule.alphas_cumprod
        all_sigmas = np.sqrt((1 - acp) / acp)
        ts = self.timesteps
        if use_karras_sigmas:
            smin, smax = all_sigmas[ts[-1]], all_sigmas[ts[0]]
            rho = 7.0
            ramp = np.linspace(0, 1, self.num_steps)
            sig = (smax ** (1 / rho) + ramp * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
            # map back to the nearest timesteps (log-sigma interpolation)
            new_ts = np.interp(np.log(sig), np.log(all_sigmas),
                               np.arange(len(all_sigmas))).round()
            self.timesteps = new_ts.astype(np.int64)
            sigmas = sig
        else:
            sigmas = all_sigmas[ts]
        self.sigmas = np.append(sigmas, 0.0).astype(np.float32)
        self._init_noise_sigma = float(np.sqrt(float(sigmas[0]) ** 2 + 1))

    @property
    def init_noise_sigma(self) -> float:
        return self._init_noise_sigma

    def slice_for_partial(self, t_start: int) -> int:
        if t_start <= 0:
            return int(self.timesteps[0])
        t0 = super().slice_for_partial(t_start)
        self.sigmas = self.sigmas[t_start:]
        # the init scaling maps VP to k-space at the new start sigma
        self._init_noise_sigma = float(np.sqrt(float(self.sigmas[0]) ** 2 + 1))
        return t0

    def scale_model_input(self, state, x, i):
        s = float(self.sigmas[i])
        return x / (s * s + 1) ** 0.5

    def _to_x0(self, model_out: torch.Tensor, x: torch.Tensor, i: int) -> torch.Tensor:
        """x here is in k-space (x = x0 + sigma * eps)."""
        s = float(self.sigmas[i])
        pt = self.schedule.prediction_type
        if pt == 'epsilon':
            return x - s * model_out
        if pt == 'v_prediction':
            return x / (s ** 2 + 1) - model_out * (s / (s ** 2 + 1) ** 0.5)
        if pt == 'sample':
            return model_out
        raise ValueError(pt)


class EulerSampler(KSamplerBase):
    def step(self, state, model_out, i, x, generator=None):
        s, s_next = float(self.sigmas[i]), float(self.sigmas[i + 1])
        x0 = self._to_x0(model_out, x, i)
        d = (x - x0) / max(s, 1e-12)
        return x + d * (s_next - s), state, x0


class EulerAncestralSampler(KSamplerBase):
    def step(self, state, model_out, i, x, generator=None):
        s, s_next = float(self.sigmas[i]), float(self.sigmas[i + 1])
        x0 = self._to_x0(model_out, x, i)
        sigma_up = max(s_next ** 2 * (s ** 2 - s_next ** 2) / max(s ** 2, 1e-12), 0.0) ** 0.5
        sigma_down = max(s_next ** 2 - sigma_up ** 2, 0.0) ** 0.5
        d = (x - x0) / max(s, 1e-12)
        x_prev = x + d * (sigma_down - s)
        if generator is not None:
            x_prev = x_prev + draw_noise(x, generator) * sigma_up
        return x_prev, state, x0


def _lam(sig: float) -> float:
    return -float(np.log(max(sig, 1e-12)))


class DPMpp2MSampler(KSamplerBase):
    """DPM-Solver++ 2M (multistep, deterministic). The state is the previous
    step's x0 prediction."""

    def init_state(self, shape):
        return None

    def step(self, state, model_out, i, x, generator=None):
        s, s_next = float(self.sigmas[i]), float(self.sigmas[i + 1])
        x0 = self._to_x0(model_out, x, i)
        if s_next == 0:
            return x0, x0, x0
        t, t_next = _lam(s), _lam(s_next)
        h = t_next - t
        if i == 0:
            x0_mix = x0
        else:
            r = (t - _lam(float(self.sigmas[i - 1]))) / (1.0 if h == 0 else h)
            denom = 1.0 if r == 0 else 2.0 * r
            x0_mix = (1 + 1 / denom) * x0 - (1 / denom) * state
        x_prev = (s_next / max(s, 1e-12)) * x - float(np.expm1(-h)) * x0_mix
        return x_prev, x0, x0


class DPMpp2MSDESampler(KSamplerBase):
    """DPM-Solver++ 2M SDE (midpoint), diffusers' DPMSolverMultistepScheduler
    with algorithm_type='sde-dpmsolver++': one model call a step, noise
    scaled by ``eta``. The state is the previous step's x0 prediction."""

    def __init__(self, schedule: NoiseSchedule, num_steps: int, eta: float = 1.0, **kw):
        super().__init__(schedule, num_steps, **kw)
        self.eta = float(eta)

    def init_state(self, shape):
        return None

    def step(self, state, model_out, i, x, generator=None):
        s, s_next = float(self.sigmas[i]), float(self.sigmas[i + 1])
        x0 = self._to_x0(model_out, x, i)
        if s_next == 0:
            return x0, x0, x0
        h = _lam(s_next) - _lam(s)
        eta_h = self.eta * h
        x_next = (s_next / max(s, 1e-12) * float(np.exp(-eta_h))) * x \
            - float(np.expm1(-h - eta_h)) * x0
        if i >= 1:
            h_last = _lam(s) - _lam(float(self.sigmas[i - 1]))
            r = h_last / (1.0 if h == 0 else h)
            x_next = x_next + (-0.5 * float(np.expm1(-h - eta_h)) / (1.0 if r == 0 else r)) \
                * (x0 - state)
        if generator is not None and self.eta > 0:
            scale = s_next * max(-float(np.expm1(-2.0 * eta_h)), 0.0) ** 0.5
            x_next = x_next + draw_noise(x, generator) * scale
        return x_next, x0, x0


SAMPLERS = {
    'ddim': DDIMSampler,
    'ddpm': DDPMSampler,
    'euler': EulerSampler,
    'euler_a': EulerAncestralSampler,
    'dpm++_2m': DPMpp2MSampler,
    'dpmpp_2m': DPMpp2MSampler,
    'dpm++_2m_sde': DPMpp2MSDESampler,
    'dpmpp_2m_sde': DPMpp2MSDESampler,
}


def make_sampler(name: str, schedule: NoiseSchedule, num_steps: int, **kw) -> BaseSampler:
    key = name.lower()
    if key not in SAMPLERS:
        raise NotImplementedError(
            f'sampler {name!r} is not ported to the PyTorch package yet '
            f'(ported: {sorted(SAMPLERS)})')
    return SAMPLERS[key](schedule, num_steps, **kw)
