"""Inference samplers (counterpart of ``hcpdiff_tpu/diffusion/samplers.py``).

The JAX samplers are pure functions stepped inside ``lax.scan``; here the
denoise loop is an eager Python loop, so a step index is a Python int and
the sigma tables are read on the host. Latents and model outputs are fp32
tensors on any device. Only DPM++ 2M is ported so far; ``make_sampler``
raises ``NotImplementedError`` for the JAX package's other samplers.

Sampler protocol, as in the JAX package:

- ``timesteps``: int64 numpy array [N] of descending training timesteps;
- ``init_state(shape)`` -> the state carried from step to step;
- ``scale_model_input(state, x, i)``;
- ``step(state, model_out, i, x)`` -> (x_prev, new_state, x0_pred).
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .schedules import NoiseSchedule


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


class DPMpp2MSampler(KSamplerBase):
    """DPM-Solver++ 2M (multistep, deterministic). The state is the previous
    step's x0 prediction."""

    def init_state(self, shape):
        return None

    def step(self, state, model_out, i, x):
        s, s_next = float(self.sigmas[i]), float(self.sigmas[i + 1])
        x0 = self._to_x0(model_out, x, i)
        if s_next == 0:
            return x0, x0, x0

        def t_fn(sig):
            return -np.log(max(sig, 1e-12))

        t, t_next = t_fn(s), t_fn(s_next)
        h = t_next - t
        if i == 0:
            x0_mix = x0
        else:
            r = (t - t_fn(float(self.sigmas[i - 1]))) / (1.0 if h == 0 else h)
            denom = 1.0 if r == 0 else 2.0 * r
            x0_mix = (1 + 1 / denom) * x0 - (1 / denom) * state
        x_prev = (s_next / max(s, 1e-12)) * x - float(np.expm1(-h)) * x0_mix
        return x_prev, x0, x0


SAMPLERS = {
    'dpm++_2m': DPMpp2MSampler,
    'dpmpp_2m': DPMpp2MSampler,
}


def make_sampler(name: str, schedule: NoiseSchedule, num_steps: int, **kw) -> BaseSampler:
    key = name.lower()
    if key not in SAMPLERS:
        raise NotImplementedError(
            f'sampler {name!r} is not ported to the PyTorch package yet '
            f'(ported: {sorted(SAMPLERS)})')
    return SAMPLERS[key](schedule, num_steps, **kw)
