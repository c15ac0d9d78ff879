"""Noise schedules (counterpart of ``hcpdiff_tpu/diffusion/schedules.py``).

The beta and alpha-cumprod tables are fp32 numpy arrays: the samplers read
them on the host. The training side (``add_noise``, ``get_velocity``,
``target``) gathers per-sample rows of them onto the latents' device.
``pyramid_noise`` is the multi-scale noise of ``PyramidNoiseScheduler``
configs, split into its normal draws (``pyramid_draws``) and their sum
(``pyramid_combine``), so a test can feed the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    betas: np.ndarray                # [T] fp32
    alphas_cumprod: np.ndarray       # [T] fp32
    num_train_timesteps: int
    prediction_type: str = 'epsilon'  # epsilon | v_prediction | sample

    @classmethod
    def make(cls, num_train_timesteps: int = 1000,
             beta_start: float = 0.00085, beta_end: float = 0.012,
             beta_schedule: str = 'scaled_linear',
             prediction_type: str = 'epsilon',
             zero_terminal_snr: bool = False) -> 'NoiseSchedule':
        if beta_schedule == 'scaled_linear':   # SD default
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                num_train_timesteps, dtype=np.float64) ** 2
        elif beta_schedule == 'linear':
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
        elif beta_schedule == 'squaredcos_cap_v2':
            t = np.arange(num_train_timesteps + 1, dtype=np.float64) / num_train_timesteps
            f = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
            betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
        else:
            raise ValueError(beta_schedule)
        acp = np.cumprod(1.0 - betas)
        if zero_terminal_snr:
            acp, betas = _rescale_zero_terminal_snr(acp)
        return cls(betas=betas.astype(np.float32), alphas_cumprod=acp.astype(np.float32),
                   num_train_timesteps=num_train_timesteps, prediction_type=prediction_type)

    # ---- training side ----
    def _coef(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """alphas_cumprod[t] as [B, 1, ...] on ``like``'s device."""
        a = torch.as_tensor(self.alphas_cumprod, device=like.device)[t.to(like.device)]
        return a.reshape((-1,) + (1,) * (like.dim() - 1))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        a = self._coef(t, x0)
        return a.sqrt() * x0 + (1.0 - a).sqrt() * noise

    def get_velocity(self, x0: torch.Tensor, noise: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
        a = self._coef(t, x0)
        return a.sqrt() * noise - (1.0 - a).sqrt() * x0

    def target(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.prediction_type == 'epsilon':
            return noise
        if self.prediction_type == 'v_prediction':
            return self.get_velocity(x0, noise, t)
        if self.prediction_type == 'sample':
            return x0
        raise ValueError(self.prediction_type)

    @property
    def snr(self) -> np.ndarray:
        """Signal-to-noise ratio table [T] (fp32) for Min-SNR weighting."""
        a = self.alphas_cumprod
        return a / (1.0 - a)


def _rescale_zero_terminal_snr(acp: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-terminal-SNR rescale (arXiv 2305.08891): shift and scale
    sqrt(acp) so the last step has SNR 0 while step 0 keeps its SNR."""
    s = np.sqrt(acp)
    s0, sT = s[0], s[-1]
    s = (s - sT) * s0 / (s0 - sT)
    acp2 = s ** 2
    alphas = np.concatenate([acp2[:1], acp2[1:] / acp2[:-1]])
    return acp2, 1.0 - alphas


def pyramid_sizes(shape: Sequence[int], levels: int = 6) -> List[Tuple[int, ...]]:
    """The shape of each level's draw for NHWC ``shape``: the full shape,
    then (B, H / 2^i, W / 2^i, C) down to the first 1x1 level."""
    B, H, W, C = shape
    out = [tuple(shape)]
    for i in range(1, levels):
        h, w = max(1, H // 2 ** i), max(1, W // 2 ** i)
        out.append((B, h, w, C))
        if h == 1 and w == 1:
            break
    return out


def pyramid_draws(generator: torch.Generator, shape: Sequence[int], levels: int = 6,
                  device: Optional[torch.device] = None) -> List[torch.Tensor]:
    """One standard normal draw a level (``pyramid_sizes``), fp32."""
    dev = device if device is not None else generator.device
    return [torch.randn(s, generator=generator, device=dev) for s in pyramid_sizes(shape, levels)]


def pyramid_combine(draws: Sequence[torch.Tensor], discount: float = 0.9) -> torch.Tensor:
    """The first draw plus discount^i times each coarser one, upsampled
    bilinearly (half-pixel centres, edges clamped: ``jax.image.resize``'s
    bilinear upsampling), divided by the sum's standard deviation (over
    every element, ddof 0): the JAX package's ``pyramid_noise``."""
    noise = draws[0]
    B, H, W, C = noise.shape
    for i, n in enumerate(draws[1:], start=1):
        up = F.interpolate(n.permute(0, 3, 1, 2), size=(H, W), mode='bilinear',
                           align_corners=False).permute(0, 2, 3, 1)
        noise = noise + (discount ** i) * up
    return noise / noise.std(unbiased=False)


def pyramid_noise(generator: torch.Generator, shape: Sequence[int], discount: float = 0.9,
                  levels: int = 6, device: Optional[torch.device] = None) -> torch.Tensor:
    """Multi-scale (pyramid) noise of NHWC ``shape``."""
    return pyramid_combine(pyramid_draws(generator, shape, levels, device), discount)
