"""Plain fp32 PyTorch models of Stable Diffusion 1.5 and SDXL: the UNet, the
VAE and the CLIP text encoders, as the published architectures define them
(diffusers' ``UNet2DConditionModel``, ``AutoencoderKL`` and transformers'
``CLIPTextModel``). No kernel, cache or fused path: every operation is a
plain ``torch`` call.

Parameter names and shapes follow the program's state dicts, so that one
seeded draw of weights (``hcpbench/weights.py``) fills both. Activations
are NCHW inside the UNet and VAE; ``UNet.forward`` takes and returns NHWC,
as the program's does. Departures from diffusers, each shared with the
program: LayerNorm epsilon 1e-6 in the transformer blocks (flax's
default), and the time (and SDXL add) embedding MLPs run in fp32, which
here is every layer's precision.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin], max period 10000 (diffusers
    ``Timesteps`` with flip_sin_to_cos=True, downscale_freq_shift=0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def attention(q, k, v, causal: bool = False, bias: Optional[torch.Tensor] = None):
    """softmax(q k^T / sqrt(d) + bias) v on [B, H, S, D]."""
    logits = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias
    if causal:
        keep = torch.ones(q.shape[-2], k.shape[-2], dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    return torch.matmul(logits.softmax(dim=-1), v)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float = 1e-5, silu: bool = False):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.group_norm(x, self.groups, self.weight, self.bias, self.eps)
        return F.silu(y) if self.silu else y


def conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1 if stride == 1 else 0)


# ---------------------------------------------------------------- UNet ----
class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, temb: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, silu=True)
        self.time_emb_proj = nn.Linear(temb, cout)
        self.conv1 = conv3(cin, cout)
        self.norm2 = GroupNorm(groups, cout, silu=True)
        self.conv2 = conv3(cout, cout)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x)) + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim or dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim or dim, dim, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x, ctx=None, res=None):
        """The sublayer's output, plus the residual ``res`` where given."""
        ctx = x if ctx is None else ctx
        B, S, C = x.shape
        h, d = self.heads, C // self.heads

        def split(y):
            return y.view(B, y.shape[1], h, d).transpose(1, 2)
        o = attention(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)))
        out = self.to_out(o.transpose(1, 2).reshape(B, S, C))
        return out if res is None else out + res


class GEGLU(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj = nn.Linear(dim, dim * mult * 2)
        self.out = nn.Linear(dim * mult, dim)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(value * F.gelu(gate))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, heads, ctx_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = GEGLU(dim)

    def forward(self, x, ctx):
        x = self.attn1(self.norm1(x), res=x)
        x = self.attn2(self.norm2(x), ctx, res=x)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, channels: int, heads: int, depth: int, ctx_dim: int, groups: int):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        for i in range(depth):
            setattr(self, f'transformer_blocks_{i}', TransformerBlock(channels, heads, ctx_dim))
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, ctx):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C))
        for i in range(self.depth):
            h = getattr(self, f'transformer_blocks_{i}')(h, ctx)
        return self.proj_out(h).view(B, H, W, C).permute(0, 3, 1, 2) + x


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3(channels, channels, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode='nearest'))


class UNet(nn.Module):
    """diffusers' UNet2DConditionModel; ``cfg`` holds the configuration
    file's ``unet`` entry."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = c = cfg
        chans = c['block_out_channels']
        ch0, n, groups = chans[0], len(chans), c['norm_num_groups']
        tdim = ch0 * 4
        self.time_embedding_linear_1 = nn.Linear(ch0, tdim)
        self.time_embedding_linear_2 = nn.Linear(tdim, tdim)
        self.text_time = c.get('addition_embed_type') == 'text_time'
        if self.text_time:
            self.add_embedding_linear_1 = nn.Linear(c['projection_class_embeddings_input_dim'],
                                                    tdim)
            self.add_embedding_linear_2 = nn.Linear(tdim, tdim)
        self.conv_in = conv3(c['in_channels'], ch0)

        def tfm(ch, level):
            return Transformer2D(ch, c['num_heads'][level],
                                 c['transformer_layers_per_block'][level],
                                 c['cross_attention_dim'], groups)
        skip, cur = [ch0], ch0
        for bi, (kind, out_c) in enumerate(zip(c['down_block_types'], chans)):
            for li in range(c['layers_per_block']):
                setattr(self, f'down_{bi}_res_{li}', ResnetBlock(cur, out_c, groups, tdim))
                cur = out_c
                if kind == 'CrossAttnDownBlock2D':
                    setattr(self, f'down_{bi}_attn_{li}', tfm(out_c, bi))
                skip.append(cur)
            if bi < n - 1:
                setattr(self, f'down_{bi}_downsample', Downsample(out_c))
                skip.append(cur)
        self.mid_res_0 = ResnetBlock(cur, chans[-1], groups, tdim)
        self.mid_attn = tfm(chans[-1], n - 1)
        self.mid_res_1 = ResnetBlock(chans[-1], chans[-1], groups, tdim)
        cur = chans[-1]
        for bi, kind in enumerate(c['up_block_types']):
            out_c = chans[n - 1 - bi]
            for li in range(c['layers_per_block'] + 1):
                setattr(self, f'up_{bi}_res_{li}',
                        ResnetBlock(cur + skip.pop(), out_c, groups, tdim))
                cur = out_c
                if kind == 'CrossAttnUpBlock2D':
                    setattr(self, f'up_{bi}_attn_{li}', tfm(out_c, n - 1 - bi))
            if bi < n - 1:
                setattr(self, f'up_{bi}_upsample', Upsample(out_c))
        self.conv_norm_out = GroupNorm(groups, cur, silu=True)
        self.conv_out = conv3(cur, c['out_channels'])

    def forward(self, sample, timesteps, ctx, pooled=None, time_ids=None):
        """sample [B, H, W, C] NHWC, timesteps [B], ctx [B, S, D]; SDXL also
        pooled [B, P] and time_ids [B, 6]. Returns NHWC."""
        c = self.cfg
        B = sample.shape[0]

        def mlp(x, l1, l2):
            return l2(F.silu(l1(x)))
        temb = mlp(timestep_embedding(timesteps, c['block_out_channels'][0]),
                   self.time_embedding_linear_1, self.time_embedding_linear_2)
        if self.text_time:
            tid = timestep_embedding(time_ids.reshape(-1), c['addition_time_embed_dim'])
            temb = temb + mlp(torch.cat([pooled, tid.reshape(B, -1)], dim=-1),
                              self.add_embedding_linear_1, self.add_embedding_linear_2)
        x = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [x]
        n = len(c['block_out_channels'])
        for bi, kind in enumerate(c['down_block_types']):
            for li in range(c['layers_per_block']):
                x = getattr(self, f'down_{bi}_res_{li}')(x, temb)
                if kind == 'CrossAttnDownBlock2D':
                    x = getattr(self, f'down_{bi}_attn_{li}')(x, ctx)
                skips.append(x)
            if bi < n - 1:
                x = getattr(self, f'down_{bi}_downsample')(x)
                skips.append(x)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x, temb), ctx), temb)
        for bi, kind in enumerate(c['up_block_types']):
            for li in range(c['layers_per_block'] + 1):
                x = getattr(self, f'up_{bi}_res_{li}')(torch.cat([x, skips.pop()], dim=1), temb)
                if kind == 'CrossAttnUpBlock2D':
                    x = getattr(self, f'up_{bi}_attn_{li}')(x, ctx)
            if bi < n - 1:
                x = getattr(self, f'up_{bi}_upsample')(x)
        return self.conv_out(self.conv_norm_out(x)).permute(0, 2, 3, 1)


# ----------------------------------------------------------------- VAE ----
class VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, 1e-6, silu=True)
        self.conv1 = conv3(cin, cout)
        self.norm2 = GroupNorm(groups, cout, 1e-6, silu=True)
        self.conv2 = conv3(cout, cout)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class VAEAttention(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        o = attention(self.to_q(h)[:, None], self.to_k(h)[:, None], self.to_v(h)[:, None])[:, 0]
        return x + self.to_out(o).view(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    """Present for its parameters, which the seeded draw covers; the
    txt2img cells never encode."""

    def __init__(self, c: dict):
        super().__init__()
        chans, groups, lpb = c['block_out_channels'], c['norm_num_groups'], c['layers_per_block']
        self.conv_in = conv3(c['in_channels'], chans[0])
        cur = chans[0]
        for bi, out_c in enumerate(chans):
            for li in range(lpb):
                setattr(self, f'down_{bi}_res_{li}', VAEResnet(cur, out_c, groups))
                cur = out_c
            if bi < len(chans) - 1:
                setattr(self, f'down_{bi}_downsample', nn.Conv2d(out_c, out_c, 3, stride=2))
        self.mid_res_0 = VAEResnet(cur, cur, groups)
        self.mid_attn = VAEAttention(cur, groups)
        self.mid_res_1 = VAEResnet(cur, cur, groups)
        self.conv_norm_out = GroupNorm(groups, cur, 1e-6, silu=True)
        self.conv_out = conv3(cur, 2 * c['latent_channels'])


class Decoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.cfg = c
        chans, groups = c['block_out_channels'], c['norm_num_groups']
        cur = chans[-1]
        self.conv_in = conv3(c['latent_channels'], cur)
        self.mid_res_0 = VAEResnet(cur, cur, groups)
        self.mid_attn = VAEAttention(cur, groups)
        self.mid_res_1 = VAEResnet(cur, cur, groups)
        for bi, out_c in enumerate(reversed(chans)):
            for li in range(c['layers_per_block'] + 1):
                setattr(self, f'up_{bi}_res_{li}', VAEResnet(cur, out_c, groups))
                cur = out_c
            if bi < len(chans) - 1:
                setattr(self, f'up_{bi}_upsample', conv3(out_c, out_c))
        self.conv_norm_out = GroupNorm(groups, cur, 1e-6, silu=True)
        self.conv_out = conv3(cur, c['out_channels'])

    def forward(self, z):
        c = self.cfg
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(self.conv_in(z))))
        n = len(c['block_out_channels'])
        for bi in range(n):
            for li in range(c['layers_per_block'] + 1):
                x = getattr(self, f'up_{bi}_res_{li}')(x)
            if bi < n - 1:
                x = getattr(self, f'up_{bi}_upsample')(F.interpolate(x, scale_factor=2,
                                                                     mode='nearest'))
        return self.conv_out(self.conv_norm_out(x))


class VAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg['latent_channels'], 2 * cfg['latent_channels'], 1)
        self.post_quant_conv = nn.Conv2d(cfg['latent_channels'], cfg['latent_channels'], 1)

    def decode_image(self, latents):
        """Final latents [B, h, w, 4] (scaled) -> image [B, H, W, 3] in [0, 1]."""
        z = (latents / self.cfg['scaling_factor']).permute(0, 3, 1, 2)
        x = self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)
        return (x * 0.5 + 0.5).clamp(0, 1)


# ---------------------------------------------------------------- CLIP ----
ACT = {'quick_gelu': lambda x: x * torch.sigmoid(1.702 * x), 'gelu': F.gelu}


class CLIPAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x):
        B, S, C = x.shape

        def split(y):
            return y.view(B, S, self.heads, C // self.heads).transpose(1, 2)
        o = attention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)),
                      causal=True)
        return self.out_proj(o.transpose(1, 2).reshape(B, S, C))


class CLIPLayer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d = c['hidden_size']
        self.act = ACT[c['hidden_act']]
        self.layer_norm1 = nn.LayerNorm(d, eps=c['layer_norm_eps'])
        self.self_attn = CLIPAttention(d, c['num_attention_heads'])
        self.layer_norm2 = nn.LayerNorm(d, eps=c['layer_norm_eps'])
        self.fc1 = nn.Linear(d, c['intermediate_size'])
        self.fc2 = nn.Linear(c['intermediate_size'], d)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class CLIPText(nn.Module):
    """transformers' CLIPTextModel (with ``projection_dim``: the pooled row's
    ``text_projection``, as CLIPTextModelWithProjection)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = c = cfg
        d = c['hidden_size']
        self.token_embedding = nn.Parameter(torch.zeros(c['vocab_size'], d))
        self.position_embedding = nn.Parameter(torch.zeros(c['max_position_embeddings'], d))
        for i in range(c['num_hidden_layers']):
            setattr(self, f'layers_{i}', CLIPLayer(c))
        self.final_layer_norm = nn.LayerNorm(d, eps=c['layer_norm_eps'])
        if c.get('projection_dim'):
            self.text_projection = nn.Linear(d, c['projection_dim'], bias=False)

    def forward(self, ids: torch.Tensor, eos_id: int):
        """ids [B, S] -> (final hidden, pooled, every layer's hidden states)."""
        x = self.token_embedding[ids] + self.position_embedding[:ids.shape[1]]
        states = [x]
        for i in range(self.cfg['num_hidden_layers']):
            x = getattr(self, f'layers_{i}')(x)
            states.append(x)
        last = self.final_layer_norm(x)
        pooled = last[torch.arange(ids.shape[0], device=ids.device),
                      (ids == eos_id).int().argmax(dim=-1)]
        if self.cfg.get('projection_dim'):
            pooled = self.text_projection(pooled)
        return last, pooled, states


def encode_text(encoders: Sequence[CLIPText], ids: torch.Tensor, eos_id: int, layer: int):
    """The UNet's context and the pooled embedding: each encoder's final
    hidden states (``layer`` 0) or the hidden states ``layer`` layers before
    the last, without the final LayerNorm (SDXL's penultimate layer),
    joined on the feature axis; pooled from the last encoder."""
    hidden, pooled = [], None
    for enc in encoders:
        last, pooled, states = enc(ids, eos_id)
        hidden.append(last if layer == 0 else states[-(layer + 1)])
    return torch.cat(hidden, dim=-1), pooled
