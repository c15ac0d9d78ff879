"""Dynamic w8a8 int8 dense layers: kernels K (``quantize_rows``, the row
quantizer) and L (``int8_dense``: the int8 product and its dequantizing
epilogue), their plain PyTorch versions and the ``torch.autograd.Function``
of the layer.

Counterpart of ``hcpdiff_tpu/ops/int8.py``, which no Pallas kernel
computes: the JAX package leaves the int8 dot to XLA. The scheme is the
same, op for op:

  activations per row (token) symmetric:  s_x[m] = max(amax(x[m, :]), 1e-12) / 127
  weights     per output channel:         s_w[n] = max(amax(W[n, :]), 1e-12) / 127
  codes       round(v / s), half to even, clipped to +-127 (never -128)
  product     int8 x int8 -> int32, exact
  dequantize  (float(acc) * (s_x[m] * s_w[n])) rounded to x's dtype,
              then + bias in that dtype, then + residual

Weights follow ``nn.Linear``'s [N, K] layout, so the JAX package's
per-column weight quantizer is a per-row one here and one quantizer (K)
serves both operands. Both operands are quantized at every call, as in
the JAX package: the parameters stay the model's own, so checkpoints,
LoRA merges and the weight bridge see ordinary linear weights.

The backward is straight-through (``int8.py:61-72`` there): the exact
product's gradients in fp32, ``dx = g @ W`` and ``dW = g^T @ x``, cast to
their dtypes; the bias and residual get the gradients of plain adds.

On the card ``int8_dense`` launches K on x and on W, then L
(``csrc/int8_gemm.cu``, see its header): three launches a layer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ._build import KERNEL_DTYPES, aligned16, check, library, require, require_cuda, stream_handle
from ._plan import SMS

# csrc/int8_gemm.cu: the codes' rows are zero-padded to a multiple of this;
# its output tile and its HCP_INT8_TILES table, blocks an SM -> ring stages
CODE_ALIGN = 32
L_BM, L_BN = 128, 160
INT8_TILES = {1: 4, 2: 3}


def l_blocks_per_sm(M: int, N: int) -> int:
    """The tile kernel L runs for out[M, N]: two blocks an SM (3 stages)
    where the grid has at least a block for every SM, so one block's
    epilogue overlaps the other's loads and products; else one block an SM
    with a deeper ring (4 stages), whose K steps run alone. At the SD1.5
    shapes this picks the faster tile of the two at every shape where they
    differ by more than a few percent (tools/time_int8.py; PERF.md)."""
    tiles = -(-M // L_BM) * -(-N // L_BN)
    return 2 if tiles >= SMS else 1


def padded_k(K: int) -> int:
    """The row length of K's code buffer: K rounded up to CODE_ALIGN."""
    return -(-K // CODE_ALIGN) * CODE_ALIGN


def quantize_rows_plain(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of x2 [M, K]: (int8 codes [M, K], fp32 scales
    [M, 1]), as the JAX ``_quant_rows`` computes them (``torch.round``
    rounds half to even, as ``jnp.round`` does)."""
    xf = x2.float()
    amax = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-12)
    # by a tensor on x's device: a CUDA tensor divided by a Python scalar is
    # multiplied by the scalar's reciprocal, which is not the division
    s = amax / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _exact_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] @ wq [N, K]^T as int32, exactly: in float64, whose 53-bit
    mantissa holds every partial sum (|acc| <= 127^2 K < 2^53), so the sum
    is exact in any order and on any device (CUDA has no int32 matmul)."""
    return torch.matmul(xq.double(), wq.double().t()).to(torch.int32)


def int8_gemm_plain(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                    dtype: torch.dtype, b: Optional[torch.Tensor] = None,
                    res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel L's function: codes xq [M, K] and wq [N, K] (K may be padded
    with zeros), scales sx and sw ([M] or [M, 1], [N] or [N, 1]) ->
    ``dtype`` [M, N], then + b in that dtype, then + res [M, N]."""
    acc = _exact_product(xq, wq).float()
    out = (acc * (sx.reshape(-1, 1) * sw.reshape(1, -1))).to(dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    if res is not None:
        out = out + res
    return out


def int8_dense_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX ``int8_dense`` with the port's [N, K] weight: x [..., K], w
    [N, K], b [N], res broadcastable to [..., N]; returns x's dtype (or the
    residual's, where that is wider, as JAX promotes the add)."""
    K, N = x.shape[-1], w.shape[0]
    xq, sx = quantize_rows_plain(x.reshape(-1, K))
    wq, sw = quantize_rows_plain(w)
    out = int8_gemm_plain(xq, wq, sx, sw, x.dtype, b).reshape(*x.shape[:-1], N)
    return out if res is None else out + res


def _quantize_launch(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K: codes [M, padded_k(K)] (zeros past K) and scales [M]."""
    require(x2.device.type == 'cuda' and x2.dtype in KERNEL_DTYPES, 'quantize_rows',
            f'expects a bfloat16 or float32 CUDA tensor, got {x2.dtype} on {x2.device}')
    require(x2.dim() == 2 and x2.is_contiguous() and aligned16(x2), 'quantize_rows',
            'x must be a contiguous, 16-byte aligned [M, K] tensor')
    M, K = x2.shape
    require(K % 8 == 0, 'quantize_rows', f'needs K % 8 == 0, got K={K}')
    q = torch.empty(M, padded_k(K), dtype=torch.int8, device=x2.device)
    s = torch.empty(M, dtype=torch.float32, device=x2.device)
    if M:
        check(library().hcp_quantize_rows(x2.data_ptr(), q.data_ptr(), s.data_ptr(), M, K,
                                          int(x2.dtype == torch.float32),
                                          stream_handle(x2.device)), 'quantize_rows')
    return q, s


def quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of x2 [M, K] (bf16 or fp32). A CPU tensor
    takes the plain version: (codes [M, K], scales [M, 1]). A CUDA tensor
    launches kernel K or raises: (codes [M, padded_k(K)], zero past K,
    scales [M]), the layout kernel L reads."""
    if x2.device.type == 'cpu':
        return quantize_rows_plain(x2)
    out = _quantize_launch(x2)
    if x2.shape[0]:
        quantize_rows.launches += 1
    return out


def _dense_launch(x, w, b, res) -> torch.Tensor:
    """K on x and on w, then kernel L."""
    dt = require_cuda('int8_dense', x, b, res)
    require_cuda('int8_dense', w)
    K = x.shape[-1]
    N = w.shape[0]
    require(w.dim() == 2 and w.shape[1] == K, 'int8_dense',
            f'w must be [N, K={K}], got {tuple(w.shape)}')
    require(N % 2 == 0, 'int8_dense', f'needs an even N, got N={N}')
    require(b is None or (b.shape == (N,) and b.is_contiguous()), 'int8_dense',
            f'b must be [{N}]')
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty(*x.shape[:-1], N, dtype=dt, device=x.device)
    require(res is None or (res.shape == out.shape and res.is_contiguous() and aligned16(res)),
            'int8_dense', f'res must be a contiguous {tuple(out.shape)} tensor')
    if M == 0:
        return out
    xq, sx = quantize_rows(x2)
    wq, sw = quantize_rows(w.contiguous())
    gemm_launch(xq, wq, sx, sw, b, res, out)
    int8_dense.launches += 1
    return out


def gemm_launch(xq, wq, sx, sw, b, res, out, minb: Optional[int] = None) -> torch.Tensor:
    """Kernel L alone on K's outputs (codes [M, Kp] and [N, Kp], scales [M]
    and [N]) into ``out`` [..., N] (bf16 or fp32; b and res of its dtype),
    with the tile built for ``minb`` blocks an SM (INT8_TILES; default
    :func:`l_blocks_per_sm`). Counts no launch: ``int8_dense`` counts the
    layer's."""
    M, N = xq.shape[0], wq.shape[0]
    minb = l_blocks_per_sm(M, N) if minb is None else minb
    require(minb in INT8_TILES, 'int8_dense', f'no tile for {minb} blocks an SM')
    rc = library().hcp_int8_gemm(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        0 if b is None else b.data_ptr(), 0 if res is None else res.data_ptr(),
        out.data_ptr(), M, N, xq.shape[1], minb, int(out.dtype == torch.float32),
        stream_handle(out.device))
    check(rc, 'int8_dense')
    return out


class _Int8Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, res):
        if x.device.type == 'cpu':
            out = int8_dense_plain(x, w, b, res)
        else:
            out = _dense_launch(x, w, None if b is None else b.to(x.dtype), res)
        need_x, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(x if need_w else None, w if need_x else None)
        ctx.x_shape, ctx.x_dtype, ctx.w_dtype = x.shape, x.dtype, w.dtype
        ctx.b_dtype = None if b is None else b.dtype
        ctx.res_dtype = None if res is None else res.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b, need_res = ctx.needs_input_grad
        g2 = g.reshape(-1, g.shape[-1]).float()
        dx = (g2 @ w.float()).reshape(ctx.x_shape).to(ctx.x_dtype) if need_x else None
        dw = (g2.t() @ x.reshape(-1, x.shape[-1]).float()).to(ctx.w_dtype) if need_w else None
        db = g2.sum(dim=0).to(ctx.b_dtype) if need_b else None
        dres = g.to(ctx.res_dtype) if need_res else None
        return dx, dw, db, dres


def int8_dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
               res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T (+ b) (+ res)`` through dynamic w8a8 int8: x [..., K] (bf16
    or fp32), w [N, K] (any float dtype: it is quantized), b [N] (cast to
    x's dtype), res [..., N] in x's dtype. Differentiable, straight through
    the quantization. A CPU tensor takes the plain version; a CUDA tensor
    launches kernels K (twice) and L, or raises."""
    return _Int8Dense.apply(x, w, b, res)


quantize_rows.launches = 0
int8_dense.launches = 0
