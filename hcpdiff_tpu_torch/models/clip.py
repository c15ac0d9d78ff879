"""CLIP text encoder (SD1.5 CLIP-L, SD2.x OpenCLIP-H, SDXL bigG) in PyTorch
(counterpart of ``hcpdiff_tpu/models/clip.py``).

Module and parameter names are the JAX tree's (``layers_0.self_attn.q_proj``,
``token_embedding`` ...). The causal self-attention over 77 tokens runs the
plain attention path, as XLA ran it for the JAX model. With
``projection_dim`` set (SDXL's second encoder) the pooled EOS row goes
through a bias-free ``text_projection``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.attention import attention
from .layers import ACT


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = 'quick_gelu'
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    bos_token_id: int = 49406
    projection_dim: Optional[int] = None   # set for SDXL's second encoder

    @classmethod
    def sd15(cls) -> 'CLIPTextConfig':
        return cls()

    @classmethod
    def sd2(cls) -> 'CLIPTextConfig':
        return cls(hidden_size=1024, intermediate_size=4096,
                   num_hidden_layers=23, num_attention_heads=16,
                   hidden_act='gelu')

    @classmethod
    def sdxl_big_g(cls) -> 'CLIPTextConfig':
        return cls(hidden_size=1280, intermediate_size=5120,
                   num_hidden_layers=32, num_attention_heads=20,
                   hidden_act='gelu', projection_dim=1280)

    @classmethod
    def tiny(cls, **kw) -> 'CLIPTextConfig':
        base = dict(vocab_size=1000, hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=77, eos_token_id=999, bos_token_id=998)
        base.update(kw)
        return cls(**base)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, C = x.shape
        h = self.heads

        def split(y):
            return y.view(B, S, h, C // h).transpose(1, 2)

        o = attention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)),
                      causal=True)
        return self.out_proj(o.transpose(1, 2).reshape(B, S, C))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = ACT[cfg.hidden_act]
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class CLIPTextModel(nn.Module):
    """``forward`` returns (last_hidden, pooled, all_hidden_states tuple).

    ``emb_ext``: optional [n, D] rows of prompt-tuning words; an id at or
    above ``vocab_size`` takes row ``id - vocab_size`` of it
    (``embed_tokens``). ``embedding_multiplier``: optional [B, S] per-token
    scale (word attention weighting); the scaled rows are renormalised to
    keep the sequence's mean absolute value, as the JAX model does.
    """

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = c = cfg
        self.token_embedding = nn.Parameter(torch.zeros(c.vocab_size, c.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.zeros(c.max_position_embeddings, c.hidden_size))
        for i in range(c.num_hidden_layers):
            setattr(self, f'layers_{i}', CLIPLayer(c))
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        if c.projection_dim is not None:
            self.text_projection = nn.Linear(c.hidden_size, c.projection_dim, bias=False)

    def embed_tokens(self, input_ids: torch.Tensor, emb_ext: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """fp32 rows of the token table, or of ``emb_ext`` for ids at or
        above ``vocab_size`` (ids out of either range are clamped into it,
        as the JAX model clamps them)."""
        V = self.cfg.vocab_size
        x = self.token_embedding[input_ids.clamp(0, V - 1)].float()
        if emb_ext is not None and emb_ext.shape[0] > 0:
            ext = emb_ext.to(x)[(input_ids - V).clamp(0, emb_ext.shape[0] - 1)]
            x = torch.where((input_ids < V)[..., None], x, ext)
        return x

    def forward(self, input_ids: torch.Tensor,
                embedding_multiplier: Optional[torch.Tensor] = None,
                emb_ext: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
        c = self.cfg
        B, S = input_ids.shape
        x = self.embed_tokens(input_ids, emb_ext)
        if embedding_multiplier is not None:
            mean_pre = x.abs().mean(dim=(1, 2), keepdim=True)
            x = x * embedding_multiplier[..., None].float()
            mean_post = x.abs().mean(dim=(1, 2), keepdim=True)
            x = x * (mean_pre / mean_post.clamp_min(1e-9))
        x = (x + self.position_embedding[:S].float()).to(self.token_embedding.dtype)

        hidden_states = [x]
        for i in range(c.num_hidden_layers):
            x = getattr(self, f'layers_{i}')(x)
            hidden_states.append(x)
        last = self.final_layer_norm(x)

        eos_pos = (input_ids == c.eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(B, device=last.device), eos_pos]
        if c.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return last, pooled, tuple(hidden_states)
