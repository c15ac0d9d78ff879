"""Shared building blocks (counterpart of ``hcpdiff_tpu/models/layers.py``).

Inside the UNet and VAE, activations are NCHW tensors in
``torch.channels_last`` memory format, which is physically [B, H, W, C]:
the GroupNorm kernel reads them as [B, S, C] with no copy.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.groupnorm import group_norm_silu


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embeddings in fp32, [cos | sin] with max period
    10000 (diffusers ``Timesteps`` with flip_sin_to_cos=True and
    downscale_freq_shift=0, as SD uses them)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm(nn.Module):
    """GroupNorm with fp32 statistics on an NCHW (channels-last) tensor,
    with the SiLU fused when ``fused_silu``; runs kernel D on the card."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 fused_silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.fused_silu = fused_silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = group_norm_silu(x.permute(0, 2, 3, 1).contiguous(), self.weight, self.bias,
                            self.num_groups, self.eps, self.fused_silu)
        return y.permute(0, 3, 1, 2)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACT = {
    'silu': F.silu,
    'swish': F.silu,
    'gelu': F.gelu,
    'quick_gelu': quick_gelu,
    'relu': F.relu,
    'mish': F.mish,
}


@torch.no_grad()
def init_flax_like(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in the manner of the flax initializers the JAX
    models use: lecun-normal dense and conv kernels (a normal truncated at
    two standard deviations, scaled to variance 1/fan_in), zero biases, unit
    norm scales, and normal(0.02) for any other parameter (CLIP's token and
    position tables). Call it on an fp32 module; ``generator`` must live on
    the parameters' device."""
    # inverse-CDF sampling of N(0, 1) truncated to [-2, 2]; 0.8796... is
    # the truncated distribution's standard deviation
    edge = math.erf(-2.0 / math.sqrt(2.0))
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            std = m.weight[0].numel() ** -0.5 / 0.87962566103423978
            m.weight.uniform_(edge, -edge, generator=generator).erfinv_()
            m.weight.mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        else:
            for p in m.parameters(recurse=False):
                p.normal_(0.0, 0.02, generator=generator)
    return module
