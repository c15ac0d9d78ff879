"""Inference samplers (counterpart of ``hcpdiff_tpu/diffusion/samplers.py``).

The JAX samplers are pure functions stepped inside ``lax.scan``; here the
denoise loop is an eager Python loop, so a step index is a Python int and
the sigma and alpha tables are read on the host. Latents and model outputs
are fp32 tensors on any device. ``SAMPLERS`` holds every name of the
JAX table: DDIM, DDPM, Euler, Euler ancestral, DPM++ 2M, DPM++ 2M SDE,
PNDM, UniPC, LMS, DEIS, and the two-stage Heun, DPM2, DPM2 ancestral,
DPM++ 2S ancestral and DPM++ SDE. A two-stage sampler's plan is
staggered: each transfer but the last is two UNet evaluations, so
``timesteps``, ``sigmas`` and ``num_steps`` describe the 2N - 1
evaluations of N steps (and PNDM's with ``prk_warmup``, whose first three
transfers are four evaluations each).

Sampler protocol, as in the JAX package:

- ``timesteps``: int64 numpy array [N] of descending training timesteps;
- ``init_state(shape)`` -> the state carried from step to step;
- ``scale_model_input(state, x, i)``;
- ``step(state, model_out, i, x, generator=None)`` -> (x_prev, new_state,
  x0_pred). The stochastic samplers (DDPM, Euler ancestral, DPM++ 2M SDE,
  DDIM with eta > 0, DPM2 ancestral, DPM++ 2S ancestral, DPM++ SDE) draw
  their noise from ``generator``, a CPU
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


class PNDMSampler(BaseSampler):
    """PNDM: PLMS multistep over an eps history. ``prk_warmup=False`` (the
    default) is the skip-prk variant SD pipelines run, PLMS from step 0;
    ``prk_warmup=True`` runs the pseudo Runge-Kutta warmup on the first 3
    transfers, 4 evaluations each, so ``num_steps`` grows by 9 and
    ``timesteps`` is the staggered evaluation plan (stage 0-3 an RK
    evaluation, 4 a PLMS step)."""

    def __init__(self, schedule: NoiseSchedule, num_steps: int, prk_warmup: bool = False,
                 **kw):
        super().__init__(schedule, num_steps, **kw)
        self.prk_warmup = bool(prk_warmup) and self.num_steps >= 4
        if self.prk_warmup:
            ts, d = self.timesteps, self.step_stride
            eval_t, base_t, stage = [], [], []
            for k in range(3):
                t = int(ts[k])
                mid, tp = max(t - d // 2, 0), max(t - d, 0)
                eval_t += [t, mid, mid, tp]
                base_t += [t] * 4
                stage += [0, 1, 2, 3]
            for t in ts[3:]:
                eval_t.append(int(t))
                base_t.append(int(t))
                stage.append(4)
            self.timesteps = np.asarray(eval_t, np.int64)
            self._base_t = base_t
            self._stage = stage
            self.num_steps = len(eval_t)

    def slice_for_partial(self, t_start: int) -> int:
        if self.prk_warmup and t_start > 0:
            # an RK transfer is 4 dependent evaluations: entering it
            # midway is not defined
            raise ValueError('img2img/inpaint: pndm with prk_warmup=True cannot start from a '
                             'partial plan; use prk_warmup=False (the SD-pipeline skip-prk '
                             'variant) or another sampler.')
        return super().slice_for_partial(t_start)

    def init_state(self, shape):
        # (the last 4 eps, their count[, the RK base sample, the RK eps sum])
        return ((), 0) if not self.prk_warmup else ((), 0, None, None)

    def _transfer(self, x, eps, t: int, t_prev: int):
        """The PNDM transfer (the paper's phi) from t to t_prev."""
        a_t = float(self.schedule.alphas_cumprod[t])
        a_prev = float(self.schedule.alphas_cumprod[t_prev])
        denom = a_t ** 0.5 * (((1 - a_prev) * a_t) ** 0.5 + ((1 - a_t) * a_prev) ** 0.5)
        return (a_prev / a_t) ** 0.5 * x - (a_prev - a_t) * eps / denom

    @staticmethod
    def _plms_eps(ets, count: int):
        if count >= 4:
            return (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3] - 9 * ets[-4]) / 24
        if count == 3:
            return (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
        if count == 2:
            return (3 * ets[-1] - ets[-2]) / 2
        return ets[-1]

    def step(self, state, model_out, i, x, generator=None):
        t_eval = int(self.timesteps[i])
        _, eps = self._x0_eps(model_out, x, t_eval)
        a = float(self.schedule.alphas_cumprod[t_eval])
        x0 = (x - (1 - a) ** 0.5 * eps) / a ** 0.5
        ets, count = state[0], state[1]
        if not self.prk_warmup:
            ets, count = (ets + (eps,))[-4:], count + 1
            x_prev = self._transfer(x, self._plms_eps(ets, count), t_eval,
                                    max(t_eval - self.step_stride, 0))
            return x_prev, (ets, count), x0
        _, _, cur_sample, cur_mo = state
        stage, t, d = self._stage[i], self._base_t[i], self.step_stride
        mid, tp = max(t - d // 2, 0), max(t - d, 0)
        if stage == 4:
            ets, count = (ets + (eps,))[-4:], count + 1
            x_next = self._transfer(x, self._plms_eps(ets, count), t, tp)
            return x_next, (ets, count, cur_sample, cur_mo), x0
        # RK: stage 0 records the base sample and pushes its eps; stage 3
        # combines the four evaluations
        if stage == 0:
            cur_sample, cur_mo = x, eps / 6
            ets, count = (ets + (eps,))[-4:], count + 1
        elif stage in (1, 2):
            cur_mo = cur_mo + eps / 3
        eps_rk = cur_mo + eps / 6 if stage == 3 else eps
        x_next = self._transfer(cur_sample, eps_rk, t, mid if stage <= 1 else tp)
        return x_next, (ets, count, cur_sample, None if stage == 3 else cur_mo), x0


class UniPCSampler(KSamplerBase):
    """UniPC (arXiv 2302.04867), bh2, order 2, data prediction: diffusers'
    UniPCMultistepScheduler defaults. One evaluation a step: at step i the
    corrector first refines the current sample (predicted at step i - 1)
    with this step's x0, then the predictor advances to sigma_{i+1}, in
    k-space (lambda = -log sigma). The state is (the last sample, the x0
    of step i - 1, the x0 of step i - 2)."""

    def init_state(self, shape):
        return (None, None, None)

    def _lam_at(self, i: int) -> float:
        return _lam(float(self.sigmas[i]))

    def step(self, state, model_out, i, x, generator=None):
        last_sample, m0, m1 = state
        m_t = self._to_x0(model_out, x, i)
        lam_im1, lam_im2 = self._lam_at(max(i - 1, 0)), self._lam_at(max(i - 2, 0))
        lam_i, lam_ip1 = self._lam_at(i), self._lam_at(i + 1)
        s, s_next = float(self.sigmas[i]), float(self.sigmas[i + 1])
        x_cur = x
        if i >= 1:
            # corrector (uni_c) on the current sample: s0 = i - 1, t = i
            h_c = lam_i - lam_im1
            hh = -h_c
            phi1 = float(np.expm1(hh))
            b_h = phi1                                  # bh2
            phi2 = phi1 / hh - 1.0
            phi3 = phi2 / hh - 0.5
            b0, b1 = phi2 / b_h, 2.0 * phi3 / b_h
            r1_c = (lam_im2 - lam_im1) / (1.0 if h_c == 0 else h_c)
            # order 2 solves [[1, 1], [r1, 1]] rhos = [b0, b1]; order 1 is [0.5]
            rho0 = (b0 - b1) / (1.0 if r1_c == 1.0 else 1.0 - r1_c)
            rho_d1, rho_dt = (rho0, b0 - rho0) if i >= 2 else (0.0, 0.5)
            ratio_c = s / max(float(self.sigmas[i - 1]), 1e-12)
            d1_t = m_t - m0
            mix = rho_dt * d1_t
            if i >= 2:
                mix = rho_d1 * ((m1 - m0) / (1.0 if r1_c == 0 else r1_c)) + mix
            x_cur = ratio_c * last_sample - phi1 * m0 - b_h * mix
        if s_next == 0:
            return m_t, (x_cur, m_t, m0), m_t
        # predictor (uni_p) to sigma_{i+1}: s0 = i, t = i + 1
        h_p = lam_ip1 - lam_i
        phi1_p = float(np.expm1(-h_p))
        x_pred = (s_next / max(s, 1e-12)) * x_cur - phi1_p * m_t
        if i >= 1:
            r1_p = (lam_im1 - lam_i) / (1.0 if h_p == 0 else h_p)
            x_pred = x_pred - 0.5 * phi1_p * ((m0 - m_t) / (1.0 if r1_p == 0 else r1_p))
        return x_pred, (x_cur, m_t, m0), m_t


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    fn = getattr(np, 'trapezoid', None) or getattr(np, 'trapz')
    return fn(y, x)


class LMSSampler(KSamplerBase):
    """Linear multistep (k-diffusion's sample_lms): Adams-Bashforth in
    sigma space, each step's coefficients the integral of the Lagrange
    basis over [sigma_i, sigma_{i+1}], a 4097-point trapezoid on the host."""

    ORDER = 4

    def __init__(self, schedule: NoiseSchedule, num_steps: int, order: int = 4, **kw):
        super().__init__(schedule, num_steps, **kw)
        self.order = min(int(order), self.ORDER)
        self._build_coeffs()

    def _build_coeffs(self) -> None:
        sig = self.sigmas                        # [N + 1], the last 0
        coeffs = np.zeros((self.num_steps, self.ORDER), np.float64)
        for i in range(self.num_steps):
            o = min(i + 1, self.order)
            taus = np.linspace(sig[i], sig[i + 1], 4097)
            for j in range(o):
                prod = np.ones_like(taus)
                for k in range(o):
                    if k != j:
                        prod *= (taus - sig[i - k]) / (sig[i - j] - sig[i - k])
                coeffs[i, j] = _trapezoid(prod, taus)
        self._coeffs = coeffs.astype(np.float32)

    def slice_for_partial(self, t_start: int) -> int:
        t0 = super().slice_for_partial(t_start)
        if t_start > 0:
            # the coefficients index the sigmas from the plan's start:
            # rebuilt over the cut plan (the order ramps up again)
            self._build_coeffs()
        return t0

    def init_state(self, shape):
        return ()                                # the d history, newest last

    def step(self, state, model_out, i, x, generator=None):
        x0 = self._to_x0(model_out, x, i)
        d = (x - x0) / max(float(self.sigmas[i]), 1e-12)
        ds = (state + (d,))[-self.ORDER:]
        c = self._coeffs[i]
        upd = None
        for j in range(min(len(ds), self.ORDER)):
            term = float(c[j]) * ds[len(ds) - 1 - j]
            upd = term if upd is None else upd + term
        return x + upd, ds, x0


class DEISSampler(KSamplerBase):
    """DEIS (arXiv 2204.13902), logrho, order 2 (diffusers'
    DEISMultistepScheduler default): the eps parametrization integrated in
    sigma with eps Lagrange-interpolated in log sigma. Order 1 is Euler;
    the first step is order 1, and so is the last in runs under 15 steps
    (diffusers' ``lower_order_final``). The state is the last eps."""

    def init_state(self, shape):
        return None

    def step(self, state, model_out, i, x, generator=None):
        s, s_next = float(self.sigmas[i]), float(self.sigmas[i + 1])
        x0 = self._to_x0(model_out, x, i)
        eps = (x - x0) / max(s, 1e-12)
        if s_next == 0:
            return x0, eps, x0
        use_o2 = i >= 1 and (self.num_steps >= 15 or i < self.num_steps - 1)
        if not use_o2:
            return x + (s_next - s) * eps, eps, x0

        def ind(t, b, c):
            # the integral of (log x - log c) / (log b - log c) over [0, t]
            t = max(t, 1e-12)
            den = float(np.log(b) - np.log(c))
            return t * (-float(np.log(c)) + float(np.log(t)) - 1.0) / (1.0 if den == 0 else den)

        sp, sc = max(float(self.sigmas[i - 1]), 1e-12), max(s, 1e-12)
        c1 = ind(s_next, sc, sp) - ind(sc, sc, sp)      # on eps_i
        c2 = ind(s_next, sp, sc) - ind(sc, sp, sc)      # on eps_{i-1}
        return x + c1 * eps + c2 * state, eps, x0


class TwoStageKSampler(KSamplerBase):
    """Two evaluations a transfer (Heun, DPM2, DPM2 ancestral, DPM++ 2S
    ancestral, DPM++ SDE): each transfer k but the last is a predictor
    evaluation at sigma_k (stage 0) and a corrector evaluation at the
    transfer's second sigma (stage 1); the last, to sigma 0, is an Euler
    step (k-diffusion's rule). ``timesteps``, ``sigmas`` and ``num_steps``
    describe that 2N - 1 evaluation plan; ``slice_for_partial`` cuts it at
    a stage-0 index. The state is (the transfer's base sample, its first
    derivative)."""

    def __init__(self, schedule: NoiseSchedule, num_steps: int, **kw):
        super().__init__(schedule, num_steps, **kw)
        sig = self.sigmas.astype(np.float64)    # [N + 1], the last 0
        ts, N = self.timesteps, self.num_steps
        s_from, s_to, s_mid, s_up = self._transfer_tables(sig)
        acp = self.schedule.alphas_cumprod
        log_all = np.log(np.sqrt((1 - acp) / acp))

        def t_of_sigma(sv):
            if sv <= 0:
                return 0
            return int(np.clip(np.interp(np.log(sv), log_all, np.arange(len(log_all))).round(),
                               0, len(log_all) - 1))

        plan_sig, plan_t, stage, pair = [], [], [], []
        for k in range(N - 1):
            plan_sig += [sig[k], s_mid[k]]
            plan_t += [int(ts[k]), t_of_sigma(s_mid[k])]
            stage += [0, 1]
            pair += [k, k]
        plan_sig.append(sig[N - 1])
        plan_t.append(int(ts[N - 1]))
        stage.append(0)
        pair.append(N - 1)
        self._plan_stage, self._pair = stage, pair
        self._s_from, self._s_to, self._s_mid, self._s_up = (
            np.asarray(a, np.float32) for a in (s_from, s_to, s_mid, s_up))
        self.timesteps = np.asarray(plan_t, np.int64)
        self.sigmas = np.append(plan_sig, 0.0).astype(np.float32)
        self.num_steps = len(plan_t)

    def _transfer_tables(self, sig):
        """(s_from, s_to, s_mid, s_up) of each transfer k (numpy [N])."""
        raise NotImplementedError

    def init_state(self, shape):
        return (None, None)

    def slice_for_partial(self, t_start: int) -> int:
        """Cut the staggered plan at transfer ``t_start``'s stage-0
        evaluation, plan index 2 t_start; ``_pair`` keeps indexing the
        whole run's transfer tables."""
        if t_start <= 0:
            return int(self.timesteps[0])
        i0 = 2 * int(t_start)
        if i0 >= len(self.timesteps):
            raise ValueError(f't_start {t_start} out of range for a {len(self.timesteps)}'
                             '-entry staggered plan')
        t0 = int(self.timesteps[i0])
        self.timesteps = self.timesteps[i0:]
        self.sigmas = self.sigmas[i0:]
        self._plan_stage = self._plan_stage[i0:]
        self._pair = self._pair[i0:]
        self.num_steps = len(self.timesteps)
        self._init_noise_sigma = float(np.sqrt(float(self.sigmas[0]) ** 2 + 1))
        return t0

    def _combine(self, x_base, d1, d2, k: int):
        raise NotImplementedError

    def step(self, state, model_out, i, x, generator=None):
        x_base, d1 = state
        k = self._pair[i]
        x0 = self._to_x0(model_out, x, i)
        d = (x - x0) / max(float(self.sigmas[i]), 1e-12)
        s_from, s_up = float(self._s_from[k]), float(self._s_up[k])
        if self._plan_stage[i] == 0:
            if i < self.num_steps - 1:
                return x + d * (float(self._s_mid[k]) - s_from), (x, d), x0
            # the last transfer: Euler to s_to (0, or sigma_down)
            x_next = x + d * (float(self._s_to[k]) - s_from)
            if generator is not None and s_up > 0:
                x_next = x_next + draw_noise(x, generator) * s_up
            return x_next, (x, d), x0
        x_next = self._combine(x_base, d1, d, k)
        if generator is not None and s_up > 0:
            x_next = x_next + draw_noise(x, generator) * s_up
        return x_next, state, x0


def _geometric_mid(a, b):
    """sqrt(a b) (the log-space midpoint), a where b is 0."""
    with np.errstate(divide='ignore'):
        mid = np.exp(0.5 * (np.log(np.maximum(a, 1e-12)) + np.log(np.maximum(b, 1e-12))))
    return np.where(b <= 0, a, mid)


class HeunSampler(TwoStageKSampler):
    """Heun's method (diffusers' HeunDiscreteScheduler): the trapezoidal
    correction, the second evaluation at sigma_{k+1}."""

    def _transfer_tables(self, sig):
        N = self.num_steps
        s_to = sig[1:N + 1]
        return sig[:N], s_to, s_to.copy(), np.zeros(N)

    def _combine(self, x_base, d1, d2, k):
        return x_base + 0.5 * (d1 + d2) * (float(self._s_to[k]) - float(self._s_from[k]))


class DPM2Sampler(TwoStageKSampler):
    """DPM2 (k-diffusion's sample_dpm_2, diffusers' KDPM2DiscreteScheduler):
    the midpoint method, the second evaluation at the log-space midpoint."""

    def _transfer_tables(self, sig):
        N = self.num_steps
        s_from, s_to = sig[:N], sig[1:N + 1]
        return s_from, s_to, _geometric_mid(s_from, s_to), np.zeros(N)

    def _combine(self, x_base, d1, d2, k):
        return x_base + d2 * (float(self._s_to[k]) - float(self._s_from[k]))


class DPM2AncestralSampler(DPM2Sampler):
    """DPM2 ancestral (k-diffusion's sample_dpm_2_ancestral): the midpoint
    method toward sigma_down, noise of sigma_up after the transfer."""

    def _transfer_tables(self, sig):
        N = self.num_steps
        s_from, s_next = sig[:N], sig[1:N + 1]
        with np.errstate(divide='ignore', invalid='ignore'):
            s_up = np.sqrt(np.maximum(s_next ** 2 * (s_from ** 2 - s_next ** 2)
                                      / np.maximum(s_from ** 2, 1e-24), 0.0))
            s_down = np.sqrt(np.maximum(s_next ** 2 - s_up ** 2, 0.0))
        return s_from, s_down, _geometric_mid(s_from, s_down), s_up


class DPMpp2SASampler(DPM2AncestralSampler):
    """DPM++ 2S ancestral (k-diffusion's sample_dpmpp_2s_ancestral): in
    sigma space the r = 1/2 predictor is an Euler step to the geometric
    midpoint, so it shares DPM2 ancestral's tables; the corrector
    re-anchors on the midpoint's x0."""

    def _combine(self, x_base, d1, d2, k):
        s_from, s_down = float(self._s_from[k]), float(self._s_to[k])
        s_mid = float(self._s_mid[k])
        x0_mid = (x_base + d1 * (s_mid - s_from)) - d2 * s_mid
        d_mid = (x_base - x0_mid) / max(s_from, 1e-12)
        return x_base + d_mid * (s_down - s_from)


class DPMppSDESampler(TwoStageKSampler):
    """DPM++ SDE, the singlestep stochastic DPM-Solver++(2S) (k-diffusion's
    sample_dpmpp_sde at r = 1/2; diffusers' DPMSolverSDEScheduler). Per
    transfer sigma_k -> sigma_{k+1}, eta 1 by default:

    - stage 0 (at sigma_k): an ancestral half-step to s_mid = sqrt(s_k
      s_{k+1}), x + d (sd1 - s_k) + su1 z0, (sd1, su1) = ancestral(s_k, s_mid);
    - stage 1 (at s_mid): x0_mid + (sd2 / s_k)(x_base - x0_mid) + su2 z,
      (sd2, su2) = ancestral(s_k, s_{k+1});
    - the last transfer: Euler to 0, without noise.

    ``brownian=True`` (the default) makes both stages' noise increments of
    one Brownian path: stage 1's unit normal is (sqrt(dt0) z0 + sqrt(dt1)
    z1) / sqrt(dt0 + dt1) with dt0 = s_k - s_mid, dt1 = s_mid - s_{k+1},
    z0 stage 0's normal (carried in the state) and z1 fresh;
    ``brownian=False`` draws stage 1's independently. eta 0 is the
    deterministic DPM-Solver++(2S) (DPMSolverSinglestepScheduler, order
    2). The state is (x_base, d1, z0)."""

    def __init__(self, schedule: NoiseSchedule, num_steps: int, eta: float = 1.0,
                 brownian: bool = True, **kw):
        self.eta = float(eta)
        self.brownian = bool(brownian)
        super().__init__(schedule, num_steps, **kw)
        dt0, dt1 = np.maximum(self._dt0, 0.0), np.maximum(self._dt1, 0.0)
        tot = np.where(dt0 + dt1 > 0, dt0 + dt1, 1.0)
        self._bw0 = np.sqrt(dt0 / tot).astype(np.float32)
        self._bw1 = np.sqrt(dt1 / tot).astype(np.float32)

    def _ancestral(self, a, b):
        with np.errstate(divide='ignore', invalid='ignore'):
            su = np.minimum(b, self.eta * np.sqrt(np.maximum(
                b ** 2 * (a ** 2 - b ** 2) / np.maximum(a ** 2, 1e-24), 0.0)))
            sd = np.sqrt(np.maximum(b ** 2 - su ** 2, 0.0))
        return sd, su

    def _transfer_tables(self, sig):
        N = self.num_steps
        s_from, s_next = sig[:N], sig[1:N + 1]
        s_mid = _geometric_mid(s_from, s_next)
        last = s_next <= 0
        sd2, su2 = self._ancestral(s_from, s_next)
        sd1, su1 = self._ancestral(s_from, s_mid)
        self._sd1 = np.where(last, s_from, sd1).astype(np.float32)
        self._su1 = np.where(last, 0.0, su1).astype(np.float32)
        self._dt0, self._dt1 = s_from - s_mid, s_mid - s_next
        return s_from, np.where(last, 0.0, sd2), s_mid, np.where(last, 0.0, su2)

    def init_state(self, shape):
        return (None, None, None)

    def step(self, state, model_out, i, x, generator=None):
        x_base, d1, z0 = state
        k = self._pair[i]
        x0 = self._to_x0(model_out, x, i)
        s_from, sd2 = float(self._s_from[k]), float(self._s_to[k])
        noisy = generator is not None and self.eta > 0
        if self._plan_stage[i] == 0:
            d = (x - x0) / max(float(self.sigmas[i]), 1e-12)
            if i == self.num_steps - 1:
                return x + d * (sd2 - s_from), (x, d, z0), x0
            x_next = x + d * (float(self._sd1[k]) - s_from)
            if noisy:
                z0 = draw_noise(x, generator)
                x_next = x_next + z0 * float(self._su1[k])
            return x_next, (x, d, z0), x0
        # stage 1: x0 is the midpoint's, and the transfer anchors on it
        x_next = x0 + (sd2 / max(s_from, 1e-12)) * (x_base - x0)
        if noisy:
            z1 = draw_noise(x, generator)
            z = (float(self._bw0[k]) * z0 + float(self._bw1[k]) * z1) if self.brownian else z1
            x_next = x_next + z * float(self._s_up[k])
        return x_next, state, x0


SAMPLERS = {
    'ddim': DDIMSampler,
    'ddpm': DDPMSampler,
    'euler': EulerSampler,
    'euler_a': EulerAncestralSampler,
    'dpm++_2m': DPMpp2MSampler,
    'dpmpp_2m': DPMpp2MSampler,
    'dpm++_2m_sde': DPMpp2MSDESampler,
    'dpmpp_2m_sde': DPMpp2MSDESampler,
    'dpm++_sde': DPMppSDESampler,
    'dpmpp_sde': DPMppSDESampler,
    'heun': HeunSampler,
    'lms': LMSSampler,
    'deis': DEISSampler,
    'dpm2': DPM2Sampler,
    'dpm2_a': DPM2AncestralSampler,
    'dpm++_2s_a': DPMpp2SASampler,
    'dpmpp_2s_a': DPMpp2SASampler,
    'pndm': PNDMSampler,
    'unipc': UniPCSampler,
}


def make_sampler(name: str, schedule: NoiseSchedule, num_steps: int, **kw) -> BaseSampler:
    key = name.lower()
    if key not in SAMPLERS:
        raise ValueError(f'unknown sampler {name!r} (known: {sorted(SAMPLERS)})')
    return SAMPLERS[key](schedule, num_steps, **kw)
