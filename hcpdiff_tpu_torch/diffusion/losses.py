"""Training losses (counterpart of ``hcpdiff_tpu/diffusion/losses.py``).

All return per-element losses (no reduction), so per-pixel attention
masks and per-sample loss weights apply before the mean. The weight tables
are fp32, computed from the schedule's fp32 alphas as the JAX package
computes them.
"""
from __future__ import annotations

import torch

from .schedules import NoiseSchedule


class MSELoss:
    need_timesteps = False

    def __init__(self, **_):
        pass

    def __call__(self, pred, target, timesteps=None):
        return (pred - target) ** 2


class MinSNRLoss(MSELoss):
    """MSE x min(gamma/SNR, 1) (arXiv 2303.09556), gamma=1 by default."""
    need_timesteps = True

    def __init__(self, noise_scheduler: NoiseSchedule, gamma: float = 1.0, **_):
        self.gamma = float(gamma)
        self.snr = torch.from_numpy(noise_scheduler.snr)                         # [T]
        self.sigma = torch.from_numpy(1.0 - noise_scheduler.alphas_cumprod).sqrt()

    def _at(self, table: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        return table.to(timesteps.device)[timesteps]

    def weight(self, timesteps):
        return torch.clamp(self.gamma / self._at(self.snr, timesteps), max=1.0)

    def __call__(self, pred, target, timesteps):
        w = self.weight(timesteps).reshape((-1,) + (1,) * (pred.dim() - 1))
        return w * (pred - target) ** 2


class SoftMinSNRLoss(MinSNRLoss):
    """weight = gamma^3 / (snr^2 + gamma^3)."""

    def weight(self, timesteps):
        snr = self._at(self.snr, timesteps)
        g3 = self.gamma ** 3
        return g3 / (snr ** 2 + g3)


class KDiffMinSNRLoss(MinSNRLoss):
    """k-diffusion weighting: 4 (gamma snr)^2 / (snr^2 + gamma^2)^2."""

    def weight(self, timesteps):
        snr = self._at(self.snr, timesteps)
        g = self.gamma
        return 4 * (g * snr) ** 2 / (snr ** 2 + g ** 2) ** 2


class EDMLoss(MinSNRLoss):
    """EDM (arXiv 2206.00364) weighting: (sigma^2 + gamma^2) / (snr (sigma
    gamma)^2), gamma in the sigma_data role."""

    def __init__(self, noise_scheduler: NoiseSchedule, gamma: float = 1.0, **kw):
        super().__init__(noise_scheduler, gamma=kw.get('sigma_data', gamma))

    def weight(self, timesteps):
        snr = self._at(self.snr, timesteps)
        sigma = self._at(self.sigma, timesteps)
        g = self.gamma
        return (sigma ** 2 + g ** 2) / (snr * (sigma * g) ** 2)


LOSSES = {
    'mse': MSELoss,
    'min_snr': MinSNRLoss,
    'soft_min_snr': SoftMinSNRLoss,
    'kdiff_min_snr': KDiffMinSNRLoss,
    'edm': EDMLoss,
}
