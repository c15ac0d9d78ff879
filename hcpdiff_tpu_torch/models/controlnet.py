"""ControlNet (counterpart of ``hcpdiff_tpu/models/controlnet.py``): a
sibling network of the UNet, a copy of its down and mid path whose every
skip and mid output passes a 1x1 zero-initialized conv, plus an encoder of
the condition image down to the latent size. ``forward`` returns the
residuals (NHWC, one a UNet skip) and the mid residual, each scaled by
``conditioning_scale``; the UNet adds them at its taps
(``UNet2DCondition.forward``'s ``down_residuals``, ``mid_residual``).

The blocks are the UNet's own ``ResnetBlock2D``, ``Transformer2D`` and
``Downsample2D``, so the kernels run as in the UNet (GroupNorm D, the
self-attention at S >= 1024 A, the feed-forward B and C; under
``fused_sublayers=True`` G, H, I and J, and under ``int8`` (``HCP_INT8=1``)
the int8 kernels K and L, as the JAX environment switches route both
networks). The condition encoder's convs (3 -> 16 -> 16 -> 32
-> 32 -> 96 -> 96 -> 256 -> C0, ``cond_stages`` of them stride 2 with
flax's SAME padding, zero-initialized output) and the zero convs are plain
convs, as ``nn.Conv`` is plain XLA there. Names are the JAX tree's paths
(``zero_0``, ``cond_embedding.blocks_1``, ``down_0_res_0.conv1`` ...), so
``ckpt/bridge.py`` loads one Flax ControlNet tree into either package.

``build_controlnet`` (``ControlNet.from_unet``) is the trainable-plugin
builder the Trainer's ``plugin_unet`` and the workflow's
``BuildPluginAction`` call; ``plugin_builder`` resolves a config's
``_target_`` to a builder; ``controlnet_from_state`` holds a plugin
file's weights for inference.
"""
from __future__ import annotations

import math
from typing import Callable, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config.instantiate import locate
from .layers import init_flax_like, timestep_embedding
from .unet import (Downsample2D, ResnetBlock2D, Transformer2D, UNet2DCondition, UNetConfig, _conv3,
                   resolve_int8)


def _cond_channels(stages: int) -> Tuple[int, ...]:
    """The condition encoder's widths, stage by stage (16, 32, 96, 256)."""
    return tuple(min(16 * 2 ** i if i < 2 else 96 if i == 2 else 256, 256)
                 for i in range(stages + 1))


def _same_stride2(x: torch.Tensor) -> torch.Tensor:
    """Flax's SAME padding of a 3x3 stride-2 conv: the total pad of each
    side, (ceil(n / 2) - 1) * 2 + 3 - n, split low = total // 2."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((math.ceil(n / 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ControlNetConditioningEmbedding(nn.Module):
    """The condition image (full size, NCHW) down to the latent size:
    ``stages`` stride-2 convs (3 for SD's /8 VAE)."""

    def __init__(self, out_channels: int, stages: int = 3):
        super().__init__()
        self.stages = stages
        ch = _cond_channels(stages)
        self.conv_in = _conv3(3, ch[0])
        for i in range(stages):
            setattr(self, f'blocks_{2 * i}', _conv3(ch[i], ch[i]))
            setattr(self, f'blocks_{2 * i + 1}', nn.Conv2d(ch[i], ch[i + 1], 3, stride=2))
        self.conv_out = _conv3(ch[-1], out_channels)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(cond))
        for i in range(self.stages):
            x = F.silu(getattr(self, f'blocks_{2 * i}')(x))
            x = F.silu(getattr(self, f'blocks_{2 * i + 1}')(_same_stride2(x)))
        return self.conv_out(x)


class ControlNet(nn.Module):
    """The UNet's down and mid copy, giving a residual at each skip and at
    the mid block. ``cond_stages`` = log2 of the VAE's scale."""

    # held in fp32 whatever the compute dtype, as the UNet's time MLP
    FP32_CHILDREN = ('time_embedding_linear_',)

    def __init__(self, cfg: UNetConfig, cond_stages: int = 3, fused_sublayers: bool = False,
                 int8: Optional[bool] = None):
        super().__init__()
        self.cfg = c = cfg
        self.fused_sublayers = fused = fused_sublayers
        self.int8 = int8 = resolve_int8(int8)
        ch0 = c.block_out_channels[0]
        tdim = ch0 * 4
        n = len(c.block_out_channels)
        self.time_embedding_linear_1 = nn.Linear(ch0, tdim)
        self.time_embedding_linear_2 = nn.Linear(tdim, tdim)
        self.conv_in = _conv3(c.in_channels, ch0)
        self.cond_embedding = ControlNetConditioningEmbedding(ch0, cond_stages)
        taps = [ch0]
        cur = ch0
        for bi, (btype, out_c) in enumerate(zip(c.down_block_types, c.block_out_channels)):
            for li in range(c.layers_per_block):
                setattr(self, f'down_{bi}_res_{li}',
                        ResnetBlock2D(cur, out_c, c.norm_num_groups, tdim, fused))
                cur = out_c
                if btype == 'CrossAttnDownBlock2D':
                    setattr(self, f'down_{bi}_attn_{li}', Transformer2D(
                        out_c, c.num_heads[bi], c.transformer_layers_per_block[bi],
                        c.cross_attention_dim, c.norm_num_groups, fused, c.qkv_bias,
                        int8=int8))
                taps.append(out_c)
            if bi < n - 1:
                setattr(self, f'down_{bi}_downsample', Downsample2D(out_c))
                taps.append(out_c)
        for i, ch in enumerate(taps):
            setattr(self, f'zero_{i}', nn.Conv2d(ch, ch, 1))
        mid_c = c.block_out_channels[-1]
        self.mid_res_0 = ResnetBlock2D(cur, mid_c, c.norm_num_groups, tdim, fused)
        if c.mid_cross_attn:
            self.mid_attn = Transformer2D(mid_c, c.num_heads[-1],
                                          c.transformer_layers_per_block[-1],
                                          c.cross_attention_dim, c.norm_num_groups, fused,
                                          c.qkv_bias, int8=int8)
        self.mid_res_1 = ResnetBlock2D(mid_c, mid_c, c.norm_num_groups, tdim, fused)
        self.zero_mid = nn.Conv2d(mid_c, mid_c, 1)

    # the compute dtype but the time MLP, as the UNet holds its weights
    to_compute_dtype = UNet2DCondition.to_compute_dtype

    @staticmethod
    def stages_for(vae_scale: int) -> int:
        return int(math.log2(vae_scale))

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, cond: torch.Tensor,
                conditioning_scale: float = 1.0) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """sample [B, h, w, C] NHWC, timesteps [B] (or a scalar),
        encoder_hidden_states [B, S, D], cond [B, H, W, 3] (H = h x the VAE
        scale) -> (residuals, mid): NHWC in the compute dtype, each times
        ``conditioning_scale``."""
        c = self.cfg
        dtype = self.conv_in.weight.dtype
        B = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(B)
        l1, l2 = self.time_embedding_linear_1, self.time_embedding_linear_2
        temb = F.linear(timestep_embedding(timesteps, c.block_out_channels[0]),
                        l1.weight.float(), l1.bias.float())
        temb = F.linear(F.silu(temb), l2.weight.float(), l2.bias.float()).to(dtype)
        ctx = encoder_hidden_states.to(dtype)

        x = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        x = x + self.cond_embedding(cond.to(dtype).permute(0, 3, 1, 2))
        outs = [x]
        n = len(c.block_out_channels)
        for bi, btype in enumerate(c.down_block_types):
            for li in range(c.layers_per_block):
                x = getattr(self, f'down_{bi}_res_{li}')(x, temb)
                if btype == 'CrossAttnDownBlock2D':
                    x = getattr(self, f'down_{bi}_attn_{li}')(x, ctx)
                outs.append(x)
            if bi < n - 1:
                x = getattr(self, f'down_{bi}_downsample')(x)
                outs.append(x)
        x = self.mid_res_0(x, temb)
        if c.mid_cross_attn:
            x = self.mid_attn(x, ctx)
        x = self.mid_res_1(x, temb)

        def tap(conv, h):
            r = conv(h)
            return (r if conditioning_scale == 1.0 else r * conditioning_scale).permute(0, 2, 3, 1)
        return ([tap(getattr(self, f'zero_{i}'), h) for i, h in enumerate(outs)],
                tap(self.zero_mid, x))


def init_from_unet(controlnet: ControlNet, unet: UNet2DCondition) -> ControlNet:
    """Copy the UNet's weights into the ControlNet's shared blocks (the
    time MLP, conv_in, the down and mid blocks), leaving the condition
    encoder and the zero convs as they are (the reference's deep copy from
    the host UNet)."""
    own = controlnet.state_dict()
    taken = {k: v for k, v in unet.state_dict().items()
             if k in own and not k.startswith(('zero_', 'cond_embedding'))}
    with torch.no_grad():
        for k, v in taken.items():
            own[k].copy_(v)
    return controlnet


def build_controlnet(generator: torch.Generator, unet: UNet2DCondition, vae_scale: int = 8,
                     **_) -> ControlNet:
    """A fresh ControlNet for ``unet`` (the reference's make_plugin): fp32 on
    the UNet's device, the flax-like init drawn from ``generator`` (which
    lives on that device), the condition encoder's output conv and every
    zero conv zero (flax's zeros initializers in the JAX model), and the
    UNet's shared blocks copied in (``init_from_unet``). ``vae_scale``
    gives the condition encoder's stride-2 stages."""
    device = next(unet.parameters()).device
    with device:
        net = ControlNet(unet.cfg, ControlNet.stages_for(vae_scale),
                         fused_sublayers=unet.fused_sublayers, int8=unet.int8)
    with torch.no_grad():
        init_flax_like(net, generator)
        for name, p in net.named_parameters():
            if name.startswith(('zero_', 'cond_embedding.conv_out.')):
                p.zero_()
    return init_from_unet(net, unet)


ControlNet.from_unet = staticmethod(build_controlnet)


def plugin_builder(target: str) -> Callable[..., nn.Module]:
    """The builder of a plugin config's ``_target_``: the located class's
    ``from_unet(generator, unet, vae_scale=, **spec)``, else
    ``build_controlnet`` where the target names a ControlNet; otherwise a
    ``ValueError`` (the JAX Trainer's dispatch)."""
    try:
        builder = getattr(locate(target), 'from_unet', None)
    except ImportError:
        builder = None
    if builder is None and 'ControlNet' in target:
        builder = build_controlnet
    if builder is None:
        raise ValueError(f'plugin {target!r} has no from_unet builder (see '
                         'models/controlnet.py build_controlnet)')
    return builder


def controlnet_from_state(state: Mapping[str, torch.Tensor], unet: UNet2DCondition,
                          vae_scale: int, dtype: torch.dtype, path: str = '') -> ControlNet:
    """A ControlNet of ``unet``'s config on its device holding a plugin's
    weights, in ``dtype`` but its time MLP (fp32), channels_last, for
    inference; a plugin of other names raises."""
    device = next(unet.parameters()).device
    with torch.device('meta'):
        net = ControlNet(unet.cfg, ControlNet.stages_for(vae_scale),
                         fused_sublayers=unet.fused_sublayers, int8=unet.int8).eval()
    names = {n for n, _ in net.named_parameters()}
    if set(state) != names:
        raise NotImplementedError(
            f'a plugin other than a ControlNet of this UNet ({path}: '
            f'{len(set(state) - names)} unknown names, {len(names - set(state))} missing) is '
            'not ported to the PyTorch package (ROADMAP.md queue 1 item 7)')
    held = {n: v.to(device, torch.float32 if n.startswith(ControlNet.FP32_CHILDREN) else dtype)
            for n, v in state.items()}
    held = {n: v.contiguous(memory_format=torch.channels_last) if v.dim() == 4 else v
            for n, v in held.items()}
    net.load_state_dict(held, strict=True, assign=True)
    return net.requires_grad_(False)
