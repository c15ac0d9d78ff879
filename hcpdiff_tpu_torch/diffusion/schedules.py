"""Noise schedules (counterpart of ``hcpdiff_tpu/diffusion/schedules.py``).

The beta and alpha-cumprod tables are fp32 numpy arrays: the samplers read
them on the host, and no device holds them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


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


def _rescale_zero_terminal_snr(acp: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-terminal-SNR rescale (arXiv 2305.08891): shift and scale
    sqrt(acp) so the last step has SNR 0 while step 0 keeps its SNR."""
    s = np.sqrt(acp)
    s0, sT = s[0], s[-1]
    s = (s - sT) * s0 / (s0 - sT)
    acp2 = s ** 2
    alphas = np.concatenate([acp2[:1], acp2[1:] / acp2[:-1]])
    return acp2, 1.0 - alphas
