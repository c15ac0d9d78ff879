"""Feed-forward GEMMs with fused epilogues: kernels B (``geglu_dense``) and
C (``fused_dense``), their plain PyTorch versions, and the
``torch.autograd.Function`` of each.

Counterpart of ``hcpdiff_tpu/ops/matmul.py``. Weights follow
``nn.Linear``'s [out, in] layout (the weight bridge transposes the JAX
[in, out] kernels), so ``y = x @ w.T``. Both kernels live in
``csrc/gemm.cu`` (see its header for the design). The backwards are the
JAX ``custom_vjp``s' (``matmul.py:231-238``, ``:259-266``, ``:369-381``):
plain large products in fp32, which XLA computes there and cuBLAS here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import (accum_dtype, aligned16, check, library, require, require_cuda_bf16,
                     stream_handle)

_DENSE, _DENSE_RES, _GEGLU = 0, 1, 2


def fused_dense_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                      res: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = F.linear(x, w, b)
    return y if res is None else y + res


def geglu_dense_plain(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    h, gate = F.linear(x, w, b).chunk(2, dim=-1)
    return h * F.gelu(gate)


def _launch(name: str, mode: int, x, w, b, res, n_out: int) -> torch.Tensor:
    require_cuda_bf16(name, x, w, b, res)
    K = x.shape[-1]
    require(x.is_contiguous() and w.is_contiguous() and aligned16(x) and aligned16(w),
            name, 'x and w must be contiguous and 16-byte aligned')
    require(w.dim() == 2 and w.shape[1] == K, name,
            f'w must be [N, K={K}], got {tuple(w.shape)}')
    require(K % 8 == 0 and n_out % 2 == 0, name,
            f'needs K % 8 == 0 and an even N, got K={K}, N={n_out}')
    if b is not None:
        require(b.shape == (w.shape[0],) and b.is_contiguous(), name,
                f'b must be [{w.shape[0]}]')
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], n_out, dtype=x.dtype, device=x.device)
    if res is not None:
        require(res.shape == out.shape and res.is_contiguous() and aligned16(res), name,
                f'res must be a contiguous {tuple(out.shape)} tensor')
    rc = library().hcp_gemm(
        mode, x.data_ptr(), w.data_ptr(), 0 if b is None else b.data_ptr(),
        0 if res is None else res.data_ptr(), out.data_ptr(), M, n_out, K,
        stream_handle(x.device))
    check(rc, name)
    return out


def _flat(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).to(dt)


def _linear_grads(ctx, x, w, dy2):
    """dx = dy W, dW = dy^T x, db = sum(dy) for the inputs that need them
    (``ctx.needs_input_grad``: frozen weights get no dW); dy2 is [M, N] in
    the accumulation dtype."""
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    dx = (dy2 @ w.to(dy2.dtype)).reshape(ctx.x_shape).to(ctx.x_dtype) if need_x else None
    dw = (dy2.t() @ _flat(x, dy2.dtype)).to(ctx.w_dtype) if need_w else None
    db = dy2.sum(dim=0).to(ctx.b_dtype) if need_b else None
    return dx, dw, db


class _FusedDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, res):
        if x.device.type == 'cpu':
            out = fused_dense_plain(x, w, b, res)
        else:
            out = _launch('fused_dense', _DENSE if res is None else _DENSE_RES,
                          x, w, b, res, w.shape[0])
            fused_dense.launches += 1
        need_x, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(x if need_w else None, w if need_x else None)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        ctx.w_dtype, ctx.b_dtype = w.dtype, None if b is None else b.dtype
        ctx.res_dtype = None if res is None else res.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw, db = _linear_grads(ctx, x, w, _flat(g, accum_dtype(g)))
        dres = g.to(ctx.res_dtype) if ctx.needs_input_grad[3] else None
        return dx, dw, db, dres


class _GegluDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        if x.device.type == 'cpu':
            out = geglu_dense_plain(x, w, b)
        else:
            require(w.shape[0] % 2 == 0, 'geglu_dense', 'w must have an even number of rows')
            out = _launch('geglu_dense', _GEGLU, x, w, b, None, w.shape[0] // 2)
            geglu_dense.launches += 1
        # the backward recomputes [h | gate] = x W^T + b, so it keeps x and W
        ctx.save_for_backward(x, w, b)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        ctx.w_dtype, ctx.b_dtype = w.dtype, None if b is None else b.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        dt = accum_dtype(g)
        y = F.linear(_flat(x, dt), w.to(dt), None if b is None else b.to(dt))
        h, gate = y.chunk(2, dim=-1)
        cdf = 0.5 * (1.0 + torch.erf(gate * math.sqrt(0.5)))
        dgelu = cdf + gate * torch.exp(-0.5 * gate * gate) * (0.5 * math.sqrt(2.0 / math.pi))
        g2 = _flat(g, dt)
        dy = torch.cat([g2 * gate * cdf, g2 * h * dgelu], dim=-1)
        return _linear_grads(ctx, x, w, dy)


def fused_dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T + b (+ res)`` with x [..., K], w [N, K], b [N], res [..., N].
    Differentiable. A CPU tensor takes the plain version; a CUDA tensor
    launches kernel C or raises."""
    return _FusedDense.apply(x, w, b, res)


def geglu_dense(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GEGLU front half, ``(x @ w[:n].T + b[:n]) * gelu(x @ w[n:].T + b[n:])``
    with exact (erf) GELU; x [..., K], w [2n, K] with the value rows first,
    b [2n]; returns [..., n]. Differentiable; the backward recomputes the
    GEMM in fp32 and differentiates it. A CPU tensor takes the plain
    version; a CUDA tensor launches kernel B or raises."""
    return _GegluDense.apply(x, w, b)


fused_dense.launches = 0
geglu_dense.launches = 0
