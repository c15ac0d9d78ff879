"""Attention dispatch: kernel A for long self-attention, plain torch
elsewhere.

Counterpart of ``hcpdiff_tpu/ops/attention.py``, with its default rule
(:59-79) whole: the kernel takes attention whose query length is at least
1024 and a multiple of 128, with as many keys as queries and a head dim of
at most 512 (UNet self-attention at the 64x64 and 32x32 levels, VAE
mid-block attention), causal or not; with Sk == Sq the kernel's top-left
causal mask is the plain version's. Attention with a ``bias`` (the UNet's
encoder attention mask, on cross-attention) takes the plain version, as
the JAX rule sends it to XLA. Cross-attention over the 77 text tokens,
CLIP's causal attention over 77 tokens and the 16x16 / 8x8 levels run the
plain version, which the JAX package leaves to XLA. Nothing falls back: on a CUDA tensor (bf16 or
fp32) the kernel runs at any head dim the rule admits, zero-padded up to
a built one where D is not (``flash_attention.kernel_head_dim``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import attention_plain, flash_attention

FLASH_MIN_SEQ = 1024


def takes_kernel(Sq: int, Sk: int, D: int) -> bool:
    """The dispatch rule: does attention of Sq queries over Sk keys at head
    dim D run kernel A?"""
    return Sq >= FLASH_MIN_SEQ and Sq % 128 == 0 and Sk == Sq and D <= 512


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
              scale: Optional[float] = None, bias: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Multi-head attention on [B, H, S, D] tensors; ``bias`` is added to
    the logits."""
    if bias is not None:
        return attention_plain(q, k, v, scale, causal, bias=bias)
    if takes_kernel(q.shape[-2], k.shape[-2], q.shape[-1]):
        return flash_attention(q, k, v, scale, causal)
    return attention_plain(q, k, v, scale, causal)
