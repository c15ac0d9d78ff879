"""Attention forward on [B, H, S, D]: kernel A (``csrc/flash_attention.cu``)
and its plain PyTorch version.

Counterpart of ``hcpdiff_tpu/ops/flash_attention.py``'s forward kernels
(the transposed ``_flash_kernel_tq`` for D=40/80 and the K/V-streaming
``_flash_kernel_stream`` for the VAE's D=512): one kernel with an online
softmax covers both. It differs from the TPU kernels' no-max softmax only
where a row's scaled logits exceed ~55 nats (``NOMAX_CLAMP_NAT``), where
the TPU kernel clamps and this one stays exact.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import aligned16, check, library, require, require_cuda_bf16, stream_handle

# Head dims the kernel is instantiated for, after padding D up to a
# multiple of 16 (D=40 -> 48): the SD1.5 UNet's 40/80/160 and the VAE's 512.
PADDED_HEAD_DIMS = (48, 80, 160, 512)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale) v with fp32 logits and softmax and the
    probabilities cast back to q's dtype, as ``_xla_attention`` does it.
    ``causal`` masks keys past each query (aligned to the sequence ends)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        ql, kl = q.shape[-2], k.shape[-2]
        keep = torch.ones(ql, kl, dtype=torch.bool, device=q.device).tril(kl - ql)
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = logits.softmax(dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, Sq, D], k/v [B, H, Sk, D], any strides with a unit stride on
    D (so a head split ``x.view(B, S, H, D).transpose(1, 2)`` needs no
    copy). A CPU tensor takes the plain version; a CUDA tensor launches
    kernel A or raises. The kernel's output is returned as a [B, H, Sq, D]
    view of a [B, Sq, H, D] buffer, so merging heads back costs no copy."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == 'cpu':
        return attention_plain(q, k, v, scale)
    name = 'flash_attention'
    require_cuda_bf16(name, q, k, v)
    require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, name, 'expects [B, H, S, D] tensors')
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    require(k.shape == (B, H, Sk, D) and v.shape == k.shape and Sk > 0, name,
            f'shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}')
    require(D % 8 == 0 and -(-D // 16) * 16 in PADDED_HEAD_DIMS, name,
            f'head dim {D} not supported (padded dims {PADDED_HEAD_DIMS})')
    require(B * H <= 65535, name, f'B*H={B * H} exceeds the grid limit')
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = []
    for t in (q, k, v, out):
        require(t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
                and aligned16(t), name, 'rows must be 16-byte aligned with unit stride on D')
        strides += list(t.stride()[:3])
    strides_c = (ctypes.c_longlong * 12)(*strides)
    rc = library().hcp_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Sq, Sk, D,
        ctypes.cast(strides_c, ctypes.c_void_p), scale, stream_handle(q.device))
    check(rc, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
