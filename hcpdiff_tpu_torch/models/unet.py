"""UNet2DCondition for SD1.5, SD2.1 and SDXL in PyTorch (counterpart of
``hcpdiff_tpu/models/unet.py``).

Module and parameter names are the JAX tree's paths (``down_0_res_0.norm1``,
``down_0_attn_0.transformer_blocks_0.attn1.to_q`` ...), so the weight bridge
(``ckpt/bridge.py``) is a rename plus transposes. ``forward`` takes and
returns NHWC, as the JAX model does; inside, activations are NCHW in
``torch.channels_last`` memory format. Every GroupNorm runs kernel D, the
self-attention of the two finest levels kernel A, and every feed-forward
kernels B and C (as ``_pallas_ff`` routes it on the TPU); convolutions and
the other projections are plain torch ops, as XLA ran them.

``fused_sublayers=True`` is the JAX package's configuration
``HCP_PALLAS_LN=1 HCP_PALLAS_PROJ=1 HCP_PALLAS_CONV=1`` (default off, as
there): each transformer block's three LayerNorms run in the prologues of
kernels G (self-attention q/k/v), I (cross-attention q) and H (GEGLU);
to_out, proj_in and proj_out run kernel C, with the residuals in its
epilogue; each resblock's two 3x3 convs run kernel J, with the
time-embedding add in conv1's epilogue and the skip add in conv2's. The
parameter names are the same in both configurations, so one JAX tree
loads into either, and the fused path reads every weight from its module
at call time (``functional_call`` and the remat recompute see the swapped
ones).

For training, ``remat=True`` recomputes each ResnetBlock2D and
Transformer2D in the backward (``torch.utils.checkpoint``) under the
policy ``HCP_REMAT_POLICY`` names, as in the JAX package
(``unet.py:630-646``): ``flash`` (the default) keeps the o and lse of
kernel A's forward and recomputes everything else, so the recompute
launches no A and kernels E and F read the very o and lse the forward
wrote (``remat``); ``full`` recomputes whole blocks, A included. ``forward`` may run under
``torch.func.functional_call`` with merged LoRA weights.

``forward`` also takes the JAX model's ``encoder_attention_mask`` (an
additive fp32 bias on the cross-attention logits, 0 where the mask is set
and the fp32 minimum elsewhere), ControlNet's residual taps
(``down_residuals``, ``mid_residual``) and the DeepCache protocol
(``return_deep``, ``deep_cache``; ``unet.py:648-790`` there).

SDXL's ``addition_embed_type='text_time'`` adds an embedding of the
pooled text embedding and the six ``time_ids`` (original size, crop,
target size) to the time embedding, through its own two-layer MLP
(``add_embedding_linear_1/2``), in fp32 as the time MLP.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.conv import conv3x3
from ..ops.flash_attention import keep_flash_outputs
from ..ops.matmul import fused_dense, geglu_dense, ln_dense, ln_geglu, ln_qkv
from .layers import GroupNorm, timestep_embedding


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = ('CrossAttnDownBlock2D',) * 3 + ('DownBlock2D',)
    up_block_types: Tuple[str, ...] = ('UpBlock2D',) + ('CrossAttnUpBlock2D',) * 3
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    addition_embed_type: Optional[str] = None       # 'text_time' for SDXL
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    mid_cross_attn: bool = True
    # to_q/to_k/to_v with biases: the host a pre-0.9 biased LoRA merges
    # into (the Visualizer rebuilds the UNet with it)
    qkv_bias: bool = False

    @classmethod
    def sd15(cls) -> 'UNetConfig':
        return cls()

    @classmethod
    def sd21(cls) -> 'UNetConfig':
        return cls(cross_attention_dim=1024, num_heads=(5, 10, 20, 20))

    @classmethod
    def sdxl(cls) -> 'UNetConfig':
        return cls(block_out_channels=(320, 640, 1280),
                   down_block_types=('DownBlock2D', 'CrossAttnDownBlock2D', 'CrossAttnDownBlock2D'),
                   up_block_types=('CrossAttnUpBlock2D', 'CrossAttnUpBlock2D', 'UpBlock2D'),
                   transformer_layers_per_block=(1, 2, 10),
                   num_heads=(5, 10, 20),
                   cross_attention_dim=2048,
                   addition_embed_type='text_time',
                   projection_class_embeddings_input_dim=2816)

    @classmethod
    def tiny(cls, cross_attention_dim: int = 32, **kw) -> 'UNetConfig':
        base = dict(block_out_channels=(32, 64),
                    down_block_types=('CrossAttnDownBlock2D', 'DownBlock2D'),
                    up_block_types=('UpBlock2D', 'CrossAttnUpBlock2D'),
                    layers_per_block=1,
                    transformer_layers_per_block=(1, 1),
                    num_heads=(2, 4),
                    cross_attention_dim=cross_attention_dim,
                    norm_num_groups=8)
        base.update(kw)
        return cls(**base)

    @classmethod
    def tiny_sdxl(cls, **kw) -> 'UNetConfig':
        base = dict(block_out_channels=(32, 64),
                    down_block_types=('DownBlock2D', 'CrossAttnDownBlock2D'),
                    up_block_types=('CrossAttnUpBlock2D', 'UpBlock2D'),
                    layers_per_block=1,
                    transformer_layers_per_block=(1, 1),
                    num_heads=(2, 4),
                    cross_attention_dim=32,
                    norm_num_groups=8,
                    addition_embed_type='text_time',
                    addition_time_embed_dim=8,
                    projection_class_embeddings_input_dim=8 * 6 + 32)
        base.update(kw)
        return cls(**base)


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1 if stride == 1 else 0)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int, temb_channels: int,
                 fused: bool = False):
        super().__init__()
        self.fused = fused
        self.norm1 = GroupNorm(groups, in_channels, fused_silu=True)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.conv1 = _conv3(in_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, fused_silu=True)
        self.conv2 = _conv3(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        t = self.time_emb_proj(F.silu(temb))
        if self.fused:
            # kernel J: the time-embedding add rides conv1's epilogue and
            # the skip add conv2's (unet.py:166-179 in the JAX package)
            h = conv3x3(self.norm1(x), self.conv1.weight, self.conv1.bias, row_bias=t)
            h = self.norm2(h)
            if self.conv_shortcut is not None:
                x = self.conv_shortcut(x)
            return conv3x3(h, self.conv2.weight, self.conv2.bias, res=x)
        h = self.conv1(self.norm1(x))
        h = h + t[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


REMAT_POLICIES = ('flash', 'full')


def resolve_remat_policy(policy: Optional[str] = None) -> str:
    """``policy``, or when None ``HCP_REMAT_POLICY`` (default ``flash``), as
    the JAX UNet reads it; raises on a name outside REMAT_POLICIES."""
    policy = policy or os.environ.get('HCP_REMAT_POLICY', 'flash')
    if policy not in REMAT_POLICIES:
        raise ValueError(f'HCP_REMAT_POLICY={policy!r}: expected one of {REMAT_POLICIES}')
    return policy


def remat(fn, *args, policy: str = 'flash'):
    """fn(*args), recomputed in the backward (``torch.utils.checkpoint``).
    Under ``flash`` the recompute takes each kernel-A forward's o and lse
    from the forward (``keep_flash_outputs``) and launches no A; under
    ``full`` it runs fn whole again. (PyTorch's selective checkpointing
    would keep them too, but its dispatch mode sees every op in Python: on
    an H100 it made an SD1.5 LoRA step slower than ``full``.)"""
    if policy == 'full':
        return checkpoint(fn, *args, use_reentrant=False)
    kept, ran = [], []

    def run(*a):
        with keep_flash_outputs(kept, replay=bool(ran)):
            out = fn(*a)
        ran.append(True)
        return out
    return checkpoint(run, *args, use_reentrant=False)


class CrossAttention(nn.Module):
    """to_q/to_k/to_v/to_out naming mirrors diffusers, as in the JAX model."""

    def __init__(self, query_dim: int, heads: int, context_dim: Optional[int] = None,
                 qkv_bias: bool = False):
        super().__init__()
        ctx_dim = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=qkv_bias)
        self.to_k = nn.Linear(ctx_dim, query_dim, bias=qkv_bias)
        self.to_v = nn.Linear(ctx_dim, query_dim, bias=qkv_bias)
        self.to_out = nn.Linear(query_dim, query_dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                res: Optional[torch.Tensor] = None,
                norm: Optional[nn.LayerNorm] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``norm`` given (the fused configuration): x arrives un-normalized
        and ``norm`` runs in the prologue of kernel G (self-attention) or I
        (cross-attention q; k and v are plain products of the context), and
        to_out is kernel C with ``res`` in its epilogue. ``bias`` is added
        to the attention logits (the encoder attention mask)."""
        ctx = x if context is None else context
        B, S, C = x.shape
        Sk = ctx.shape[1]
        h = self.heads
        d = C // h
        if norm is None:
            q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        elif context is None:
            q, k, v = ln_qkv(x, norm.weight, norm.bias, self.to_q.weight, self.to_k.weight,
                             self.to_v.weight, norm.eps)
        else:
            q = ln_dense(x, norm.weight, norm.bias, self.to_q.weight, norm.eps)
            k, v = self.to_k(ctx), self.to_v(ctx)
        # head split/merge are views: kernel A takes strides
        q = q.view(B, S, h, d).transpose(1, 2)
        k = k.view(B, Sk, h, d).transpose(1, 2)
        v = v.view(B, Sk, h, d).transpose(1, 2)
        o = attention(q, k, v, bias=bias).transpose(1, 2).reshape(B, S, C)
        if norm is not None:
            return fused_dense(o, self.to_out.weight, self.to_out.bias, res=res)
        out = self.to_out(o)
        return out if res is None else out + res


class GEGLUFeedForward(nn.Module):
    """proj's rows are [value | gate]; kernel B (H, with ``norm`` in its
    prologue, in the fused configuration) applies the gate in its epilogue
    and kernel C adds the block residual in its own."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj = nn.Linear(dim, inner * 2)
        self.out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None,
                norm: Optional[nn.LayerNorm] = None) -> torch.Tensor:
        if norm is None:
            h = geglu_dense(x, self.proj.weight, self.proj.bias)
        else:
            h = ln_geglu(x, norm.weight, norm.bias, self.proj.weight, self.proj.bias, norm.eps)
        return fused_dense(h, self.out.weight, self.out.bias, res=res)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int, fused: bool = False,
                 qkv_bias: bool = False):
        super().__init__()
        # kernels G and I compute bias-free q/k/v: a biased block takes the
        # unfused sublayers, as the JAX block does (unet.py:513)
        self.fused = fused and not qkv_bias
        # flax nn.LayerNorm's default epsilon
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, heads, qkv_bias=qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, heads, context_dim, qkv_bias=qkv_bias)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.fused:      # the LayerNorms run in the sublayers' prologues
            x = self.attn1(x, res=x, norm=self.norm1)
            x = self.attn2(x, context, res=x, norm=self.norm2, bias=context_bias)
            return self.ff(x, res=x, norm=self.norm3)
        x = self.attn1(self.norm1(x), res=x)
        x = self.attn2(self.norm2(x), context, res=x, bias=context_bias)
        return self.ff(self.norm3(x), res=x)


class Transformer2D(nn.Module):
    def __init__(self, channels: int, heads: int, depth: int, context_dim: int,
                 groups: int, fused: bool = False, qkv_bias: bool = False):
        super().__init__()
        self.depth = depth
        self.fused = fused
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        for i in range(depth):
            setattr(self, f'transformer_blocks_{i}',
                    BasicTransformerBlock(channels, heads, context_dim, fused, qkv_bias))
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        if self.fused:
            # kernel C on the [B, HW, C] view (free for channels_last), and
            # the block input rides proj_out's epilogue (unet.py:568-595)
            h = fused_dense(h, self.proj_in.weight, self.proj_in.bias)
            for i in range(self.depth):
                h = getattr(self, f'transformer_blocks_{i}')(h, context, context_bias)
            res = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
            h = fused_dense(h, self.proj_out.weight, self.proj_out.bias, res=res)
            return h.view(B, H, W, C).permute(0, 3, 1, 2)
        h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f'transformer_blocks_{i}')(h, context, context_bias)
        h = self.proj_out(h)
        return h.view(B, H, W, C).permute(0, 3, 1, 2) + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3(channels, channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # diffusers pads (0,1,0,1) then uses a VALID stride-2 conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode='nearest'))


class UNet2DCondition(nn.Module):
    # children the model runs in fp32 whatever its dtype (the time and add
    # embedding MLPs); ``to_compute_dtype`` and the checkpoint loader keep them fp32
    FP32_CHILDREN = ('time_embedding_linear_', 'add_embedding_linear_')

    def __init__(self, cfg: UNetConfig, remat: bool = False, fused_sublayers: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.cfg = c = cfg
        self.remat = remat
        # 'flash' or 'full'; None: HCP_REMAT_POLICY (default 'flash')
        self.remat_policy = resolve_remat_policy(remat_policy)
        self.fused_sublayers = fused = fused_sublayers
        ch0 = c.block_out_channels[0]
        tdim = ch0 * 4
        n = len(c.block_out_channels)
        self.time_embedding_linear_1 = nn.Linear(ch0, tdim)
        self.time_embedding_linear_2 = nn.Linear(tdim, tdim)
        if c.addition_embed_type == 'text_time':
            self.add_embedding_linear_1 = nn.Linear(c.projection_class_embeddings_input_dim, tdim)
            self.add_embedding_linear_2 = nn.Linear(tdim, tdim)
        elif c.addition_embed_type is not None:
            raise ValueError(f'addition_embed_type {c.addition_embed_type!r} is not supported')
        self.conv_in = _conv3(c.in_channels, ch0)

        def tfm(channels, level):
            return Transformer2D(channels, c.num_heads[level],
                                 c.transformer_layers_per_block[level],
                                 c.cross_attention_dim, c.norm_num_groups, fused, c.qkv_bias)

        skip_ch = [ch0]
        cur = ch0
        for bi, (btype, out_c) in enumerate(zip(c.down_block_types, c.block_out_channels)):
            for li in range(c.layers_per_block):
                setattr(self, f'down_{bi}_res_{li}',
                        ResnetBlock2D(cur, out_c, c.norm_num_groups, tdim, fused))
                cur = out_c
                if btype == 'CrossAttnDownBlock2D':
                    setattr(self, f'down_{bi}_attn_{li}', tfm(out_c, bi))
                skip_ch.append(cur)
            if bi < n - 1:
                setattr(self, f'down_{bi}_downsample', Downsample2D(out_c))
                skip_ch.append(cur)

        mid_c = c.block_out_channels[-1]
        self.mid_res_0 = ResnetBlock2D(cur, mid_c, c.norm_num_groups, tdim, fused)
        if c.mid_cross_attn:
            self.mid_attn = tfm(mid_c, n - 1)
        self.mid_res_1 = ResnetBlock2D(mid_c, mid_c, c.norm_num_groups, tdim, fused)
        cur = mid_c

        rev = list(reversed(c.block_out_channels))
        for bi, btype in enumerate(c.up_block_types):
            out_c = rev[bi]
            for li in range(c.layers_per_block + 1):
                setattr(self, f'up_{bi}_res_{li}',
                        ResnetBlock2D(cur + skip_ch.pop(), out_c, c.norm_num_groups, tdim,
                                      fused))
                cur = out_c
                if btype == 'CrossAttnUpBlock2D':
                    setattr(self, f'up_{bi}_attn_{li}', tfm(out_c, n - 1 - bi))
            if bi < n - 1:
                setattr(self, f'up_{bi}_upsample', Upsample2D(out_c))

        self.conv_norm_out = GroupNorm(c.norm_num_groups, cur, fused_silu=True)
        self.conv_out = _conv3(cur, c.out_channels)

    def to_compute_dtype(self, dtype: torch.dtype) -> 'UNet2DCondition':
        """Cast every weight to ``dtype`` except the time-embedding MLP's and
        (text_time) the add-embedding MLP's, which the model runs in fp32
        whatever the weights' dtype (as the JAX model keeps them), so they
        stay fp32."""
        self.to(dtype)
        for name, m in self.named_children():
            if name.startswith(self.FP32_CHILDREN):
                m.float()
        return self

    def _block(self, name: str, *args) -> torch.Tensor:
        """Run a ResnetBlock2D or Transformer2D, recomputed in the backward
        under ``remat`` (``remat_policy``: ``flash`` keeps kernel A's o and
        lse for the backward, ``full`` recomputes them too). The block's
        current parameters (under ``functional_call``, the swapped-in ones)
        ride into the recompute explicitly: it runs after
        ``functional_call`` has put the module's own parameters back."""
        block = getattr(self, name)
        if not (self.remat and torch.is_grad_enabled()):
            return block(*args)
        params = dict(block.named_parameters())
        return remat(lambda *a: functional_call(block, params, a), *args,
                     policy=self.remat_policy)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                pooled_text_emb: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                down_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_residual: Optional[torch.Tensor] = None,
                deep_cache: Optional[torch.Tensor] = None,
                return_deep: bool = False):
        """sample [B, H, W, C] NHWC, timesteps [B] (or a scalar),
        encoder_hidden_states [B, S, D]; under text_time also
        pooled_text_emb [B, P] and time_ids [B, 6]; returns fp32 NHWC.

        - ``encoder_attention_mask`` [B, S] (1 keep, 0 drop): every
          cross-attention's logits get 0 or the fp32 minimum;
        - ``down_residuals`` (NHWC, one a skip) and ``mid_residual``: added
          to the skips and to the mid block's output (ControlNet's taps);
        - ``return_deep``: also return the deep feature (NHWC, compute
          dtype) entering the last up level, after the level before's
          upsample;
        - ``deep_cache`` (that feature): run only down level 0 and the last
          up level, with the cached feature in place of everything between
          (DeepCache); a ValueError with residual taps, which live in the
          skipped levels."""
        c = self.cfg
        dtype = self.conv_in.weight.dtype
        B = sample.shape[0]
        shallow_only = deep_cache is not None
        if shallow_only and (down_residuals is not None or mid_residual is not None):
            raise ValueError('deep_cache is incompatible with ControlNet residual taps')
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(B)

        def mlp(x, lin1, lin2):
            x = F.linear(x, lin1.weight.float(), lin1.bias.float())
            return F.linear(F.silu(x), lin2.weight.float(), lin2.bias.float())

        # the time-embedding MLP (and SDXL's add-embedding MLP, added to
        # it) runs in fp32 whatever the weights' dtype, as the JAX model
        # runs it; the sum is cast after the MLPs
        temb = mlp(timestep_embedding(timesteps, c.block_out_channels[0]),
                   self.time_embedding_linear_1, self.time_embedding_linear_2)
        if c.addition_embed_type == 'text_time':
            if pooled_text_emb is None or time_ids is None:
                raise ValueError('a text_time UNet needs pooled_text_emb and time_ids')
            t_emb = timestep_embedding(time_ids.reshape(-1), c.addition_time_embed_dim)
            add = torch.cat([pooled_text_emb.float(), t_emb.reshape(B, -1)], dim=-1)
            temb = temb + mlp(add, self.add_embedding_linear_1, self.add_embedding_linear_2)
        temb = temb.to(dtype)
        ctx = encoder_hidden_states.to(dtype)
        ctx_bias = None
        if encoder_attention_mask is not None:
            ctx_bias = torch.where(encoder_attention_mask[:, None, None, :].bool(),
                                   0.0, torch.finfo(torch.float32).min).float()

        x = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        skips = [x]
        n = len(c.block_out_channels)
        for bi, btype in enumerate(c.down_block_types):
            if shallow_only and bi > 0:
                break
            for li in range(c.layers_per_block):
                x = self._block(f'down_{bi}_res_{li}', x, temb)
                if btype == 'CrossAttnDownBlock2D':
                    x = self._block(f'down_{bi}_attn_{li}', x, ctx, ctx_bias)
                skips.append(x)
            if bi < n - 1 and not shallow_only:
                x = getattr(self, f'down_{bi}_downsample')(x)
                skips.append(x)

        def up_level(bi, x):
            for li in range(c.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=1)
                x = self._block(f'up_{bi}_res_{li}', x, temb)
                if c.up_block_types[bi] == 'CrossAttnUpBlock2D':
                    x = self._block(f'up_{bi}_attn_{li}', x, ctx, ctx_bias)
            return x

        deep = None
        if shallow_only:
            x = deep_cache.to(dtype).permute(0, 3, 1, 2)
        else:
            if down_residuals is not None:
                skips = [s + r.to(s.dtype).permute(0, 3, 1, 2)
                         for s, r in zip(skips, down_residuals)]
                x = skips[-1] if len(down_residuals) == len(skips) else x
            x = self._block('mid_res_0', x, temb)
            if c.mid_cross_attn:
                x = self._block('mid_attn', x, ctx, ctx_bias)
            x = self._block('mid_res_1', x, temb)
            if mid_residual is not None:
                x = x + mid_residual.to(x.dtype).permute(0, 3, 1, 2)
            for bi in range(len(c.up_block_types) - 1):
                x = getattr(self, f'up_{bi}_upsample')(up_level(bi, x))
            deep = x.permute(0, 2, 3, 1)
        x = up_level(len(c.up_block_types) - 1, x)

        x = self.conv_out(self.conv_norm_out(x))
        out = x.permute(0, 2, 3, 1).float()
        return (out, deep) if return_deep else out
