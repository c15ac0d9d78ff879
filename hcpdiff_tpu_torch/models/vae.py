"""AutoencoderKL (SD VAE) in PyTorch (counterpart of
``hcpdiff_tpu/models/vae.py``).

Parameter names follow the JAX tree (``decoder.up_0_res_0.norm1``,
``decoder.mid_attn.to_q`` ...). ``encode``/``decode`` take and return NHWC;
inside, activations are NCHW in ``torch.channels_last`` memory format.
Every GroupNorm runs kernel D and the mid-block attention (one head,
D = 512 at the SD widths) kernel A when the latent has at least 1024
positions; the convs are plain torch ops.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention
from .layers import GroupNorm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @classmethod
    def sd(cls) -> 'VAEConfig':
        return cls()

    @classmethod
    def sdxl(cls) -> 'VAEConfig':
        """SDXL's VAE: the SD architecture with its own latent scale."""
        return cls(scaling_factor=0.13025)

    @classmethod
    def tiny(cls, **kw) -> 'VAEConfig':
        base = dict(block_out_channels=(16, 32), layers_per_block=1,
                    norm_num_groups=4)
        base.update(kw)
        return cls(**base)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=1e-6, fused_silu=True)
        self.conv1 = _conv3(in_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=1e-6, fused_silu=True)
        self.conv2 = _conv3(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        o = attention(self.to_q(h)[:, None], self.to_k(h)[:, None],
                      self.to_v(h)[:, None])[:, 0]
        o = self.to_out(o)
        return x + o.view(B, H, W, C).permute(0, 3, 1, 2)


def _downsample(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    # diffusers pads (0,1,0,1) then uses a VALID stride-2 conv
    return conv(F.pad(x, (0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = c = cfg
        self.conv_in = _conv3(c.in_channels, c.block_out_channels[0])
        cur = c.block_out_channels[0]
        for bi, out_c in enumerate(c.block_out_channels):
            for li in range(c.layers_per_block):
                setattr(self, f'down_{bi}_res_{li}', VAEResnet(cur, out_c, c.norm_num_groups))
                cur = out_c
            if bi < len(c.block_out_channels) - 1:
                setattr(self, f'down_{bi}_downsample', nn.Conv2d(out_c, out_c, 3, stride=2))
        self.mid_res_0 = VAEResnet(cur, cur, c.norm_num_groups)
        self.mid_attn = VAEAttention(cur, c.norm_num_groups)
        self.mid_res_1 = VAEResnet(cur, cur, c.norm_num_groups)
        self.conv_norm_out = GroupNorm(c.norm_num_groups, cur, eps=1e-6, fused_silu=True)
        self.conv_out = _conv3(cur, 2 * c.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.conv_in(x)
        for bi in range(len(c.block_out_channels)):
            for li in range(c.layers_per_block):
                x = getattr(self, f'down_{bi}_res_{li}')(x)
            if bi < len(c.block_out_channels) - 1:
                x = _downsample(getattr(self, f'down_{bi}_downsample'), x)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = c = cfg
        mid_c = c.block_out_channels[-1]
        self.conv_in = _conv3(c.latent_channels, mid_c)
        self.mid_res_0 = VAEResnet(mid_c, mid_c, c.norm_num_groups)
        self.mid_attn = VAEAttention(mid_c, c.norm_num_groups)
        self.mid_res_1 = VAEResnet(mid_c, mid_c, c.norm_num_groups)
        rev = list(reversed(c.block_out_channels))
        cur = mid_c
        for bi, out_c in enumerate(rev):
            for li in range(c.layers_per_block + 1):
                setattr(self, f'up_{bi}_res_{li}', VAEResnet(cur, out_c, c.norm_num_groups))
                cur = out_c
            if bi < len(rev) - 1:
                setattr(self, f'up_{bi}_upsample', _conv3(out_c, out_c))
        self.conv_norm_out = GroupNorm(c.norm_num_groups, cur, eps=1e-6, fused_silu=True)
        self.conv_out = _conv3(cur, c.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.conv_in(z)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        n = len(c.block_out_channels)
        for bi in range(n):
            for li in range(c.layers_per_block + 1):
                x = getattr(self, f'up_{bi}_res_{li}')(x)
            if bi < n - 1:
                x = getattr(self, f'up_{bi}_upsample')(F.interpolate(x, scale_factor=2,
                                                                     mode='nearest'))
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image [B,H,W,3] in [-1,1] -> (mean, logvar), each fp32 [B,H/8,W/8,4]."""
        dtype = self.quant_conv.weight.dtype
        moments = self.quant_conv(self.encoder(x.to(dtype).permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).float().chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latent [B,h,w,4] (unscaled) -> fp32 image [B,8h,8w,3] in about [-1, 1]."""
        dtype = self.post_quant_conv.weight.dtype
        x = self.decoder(self.post_quant_conv(z.to(dtype).permute(0, 3, 1, 2)))
        return x.permute(0, 2, 3, 1).float()
