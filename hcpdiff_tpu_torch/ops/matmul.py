"""Feed-forward GEMMs with fused epilogues: kernels B (``geglu_dense``) and
C (``fused_dense``) and their plain PyTorch versions.

Counterpart of ``hcpdiff_tpu/ops/matmul.py``. Weights follow
``nn.Linear``'s [out, in] layout (the weight bridge transposes the JAX
[in, out] kernels), so ``y = x @ w.T``. Both kernels live in
``csrc/gemm.cu`` (see its header for the design).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ._build import aligned16, check, library, require, require_cuda_bf16, stream_handle

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


def fused_dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T + b (+ res)`` with x [..., K], w [N, K], b [N], res [..., N].
    A CPU tensor takes the plain version; a CUDA tensor launches kernel C
    or raises."""
    if x.device.type == 'cpu':
        return fused_dense_plain(x, w, b, res)
    out = _launch('fused_dense', _DENSE if res is None else _DENSE_RES,
                  x, w, b, res, w.shape[0])
    fused_dense.launches += 1
    return out


def geglu_dense(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GEGLU front half, ``(x @ w[:n].T + b[:n]) * gelu(x @ w[n:].T + b[n:])``
    with exact (erf) GELU; x [..., K], w [2n, K] with the value rows first,
    b [2n]; returns [..., n]. A CPU tensor takes the plain version; a CUDA
    tensor launches kernel B or raises."""
    if x.device.type == 'cpu':
        return geglu_dense_plain(x, w, b)
    require(w.shape[0] % 2 == 0, 'geglu_dense', 'w must have an even number of rows')
    out = _launch('geglu_dense', _GEGLU, x, w, b, None, w.shape[0] // 2)
    geglu_dense.launches += 1
    return out


fused_dense.launches = 0
geglu_dense.launches = 0
