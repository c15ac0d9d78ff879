"""Dynamic w8a8 int8 dense layers: kernels K (``quantize_rows``, the row
quantizer) and L (``int8_dense``: the int8 product and its dequantizing
epilogue; ``int8_geglu_dense``: the same with the GEGLU gate in its
epilogue), their plain PyTorch versions, the weights' code cache and the
``torch.autograd.Function`` of each layer.

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
serves both operands. The GEGLU layer is the JAX UNet's int8 ff.proj
(``hcpdiff_tpu/models/unet.py:463``): ``int8_dense`` over ``[Wv; Wg]``,
split, ``h * gelu(gate)`` (exact gelu) in x's dtype.

Weight codes are kept between calls (:func:`weight_codes`). The JAX
package quantizes its weights inside ``jit`` at every call; the codes
depend on the weight alone, so the result is the same. The parameters
stay the model's own, so checkpoints, LoRA merges and the weight bridge
see ordinary linear weights. The cache's one rule: it never returns codes
of values that have since changed. An entry is kept per weight tensor
object and is taken only while the tensor's version counter (bumped by
every in-place write: ``copy_``, an optimizer's step, ``load_state_dict``
without ``assign``), its data pointer, shape, strides, dtype and device
are those it was made from, and the storage it was made from is still
alive (so a pointer reused by a later ``.data =`` cannot match).
``load_state_dict(..., assign=True)`` and ZeRO/fsdp gathers give new
tensors or new storage, and so miss. A write that goes around the version
counter (an in-place op on ``w.data``, which autograd cannot see either)
is not seen: the port makes none. An inference tensor has no version
counter and is quantized at every call. The cache holds, for each live
weight it has seen, its codes ([N, K] int8 on the CPU, [N, padded_k(K)]
on the card) and fp32 scales, half the bytes of a bf16 weight; an entry
goes with its tensor. It holds no reference to the weight or its storage.

The backward is straight-through (``int8.py:61-72`` there): the exact
product's gradients in fp32, ``dx = g @ W`` and ``dW = g^T @ x``, cast to
their dtypes; the bias and residual get the gradients of plain adds. The
GEGLU layer's backward recomputes its two halves and takes the gradient
of ``h * gelu(gate)`` by autograd, then passes straight through the
product.

On the card a layer launches K on its activation and L once (on an
unchanged weight; K on the weight too at its first call and after each
change of its values): ``int8_dense`` and ``int8_geglu_dense`` count
their L launches, ``quantize_rows`` every K launch, and
``weight_codes.quantizations`` the weights quantized on either device.
"""
from __future__ import annotations

import functools
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.multiprocessing.reductions import StorageWeakRef

from ._build import KERNEL_DTYPES, aligned16, check, library, require, require_cuda, stream_handle
from ._plan import SMS

# csrc/int8_gemm.cu: the codes' rows are zero-padded to a multiple of this;
# L's tile (BM rows x BN weight rows: BN output columns, or BN / 2 through
# the GEGLU gate), its K step in channels and its ring's slots
CODE_ALIGN = 32
L_BM, L_BN, L_BK, L_STAGES = 128, 160, 128, 4


def l_tiles(M: int, N: int, geglu: bool = False) -> int:
    """Output tiles of kernel L for codes [M, Kp] and [N, Kp]: BM x BN, or
    BM x BN / 2 columns of the N / 2 the GEGLU L writes."""
    cols, nout = (L_BN // 2, N // 2) if geglu else (L_BN, N)
    return -(-M // L_BM) * -(-nout // cols)


def l_plan(M: int, N: int, geglu: bool = False) -> int:
    """Persistent blocks kernel L runs: one an SM, fewer where there are
    fewer tiles."""
    return min(l_tiles(M, N, geglu), SMS)


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


def _gate(h2: torch.Tensor) -> torch.Tensor:
    """``h * gelu(gate)`` (exact gelu) of the halves [h | gate] of h2."""
    h, gate = h2.chunk(2, dim=-1)
    return h * F.gelu(gate)


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


def int8_geglu_gemm_plain(xq, wq, sx, sw, dtype: torch.dtype,
                          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The GEGLU L's function on codes: :func:`int8_gemm_plain` over
    ``[Wv; Wg]`` (N rows), then ``h * gelu(gate)`` of its two halves in
    ``dtype``: [M, N / 2]."""
    return _gate(int8_gemm_plain(xq, wq, sx, sw, dtype, b))


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


def int8_geglu_dense_plain(x: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX UNet's int8 GEGLU: ``int8_dense(x, [Wv; Wg], b)``, split,
    ``h * gelu(gate)`` (exact): x [..., K], w [2 I, K], b [2 I] -> [..., I]
    in x's dtype."""
    return _gate(int8_dense_plain(x, w, b))


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


# id(weight) -> (weakref to it, key, weak reference to its storage, (codes, scales))
_CODES: Dict[int, tuple] = {}


def _key(w: torch.Tensor) -> tuple:
    return (w._version, w.data_ptr(), tuple(w.shape), w.stride(), w.dtype, w.device)


def _forget(table: dict, at: int, ref: weakref.ref) -> None:
    """The weakref callback: drop the entry of the weight that died."""
    entry = table.get(at)
    if entry is not None and entry[0] is ref:
        del table[at]


def weight_codes(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K's output for a weight [N, K] (:func:`quantize_rows` on
    ``w.contiguous()``: on the CPU the plain codes, on the card kernel K),
    kept between calls under the module docstring's rule: a weight is
    quantized once per version of its values."""
    if w.is_inference():
        weight_codes.quantizations += 1
        return quantize_rows(w.contiguous())
    at, key = id(w), _key(w)
    entry = _CODES.get(at)
    if (entry is not None and entry[0]() is w and entry[1] == key
            and not entry[2].expired()):
        return entry[3]
    codes = quantize_rows(w.contiguous())
    weight_codes.quantizations += 1
    ref = weakref.ref(w, functools.partial(_forget, _CODES, at))
    _CODES[at] = (ref, key, StorageWeakRef(w.untyped_storage()), codes)
    return codes


def _check_layer(kernel, x, w, b) -> None:
    K, N = x.shape[-1], w.shape[0]
    require(w.dim() == 2 and w.shape[1] == K, kernel,
            f'w must be [N, K={K}], got {tuple(w.shape)}')
    require(N % 2 == 0, kernel, f'needs an even N, got N={N}')
    require(b is None or (b.shape == (N,) and b.is_contiguous() and aligned16(b)), kernel,
            f'b must be a contiguous [{N}] tensor')


def _dense_launch(x, w, b, res) -> torch.Tensor:
    """K on x (and on w where its codes are not kept), then kernel L."""
    dt = require_cuda('int8_dense', x, b, res)
    require_cuda('int8_dense', w)
    _check_layer('int8_dense', x, w, b)
    K, N = x.shape[-1], w.shape[0]
    x2 = x.reshape(-1, K).contiguous()
    out = torch.empty(*x.shape[:-1], N, dtype=dt, device=x.device)
    require(res is None or (res.shape == out.shape and res.is_contiguous() and aligned16(res)),
            'int8_dense', f'res must be a contiguous {tuple(out.shape)} tensor')
    if x2.shape[0] == 0:
        return out
    xq, sx = quantize_rows(x2)
    wq, sw = weight_codes(w)
    gemm_launch(xq, wq, sx, sw, b, res, out)
    int8_dense.launches += 1
    return out


def _geglu_launch(x, w, b) -> torch.Tensor:
    """K on x (and on w where its codes are not kept), then the GEGLU L."""
    dt = require_cuda('int8_geglu_dense', x, b)
    require_cuda('int8_geglu_dense', w)
    _check_layer('int8_geglu_dense', x, w, b)
    K, N = x.shape[-1], w.shape[0]
    x2 = x.reshape(-1, K).contiguous()
    out = torch.empty(*x.shape[:-1], N // 2, dtype=dt, device=x.device)
    if x2.shape[0] == 0:
        return out
    xq, sx = quantize_rows(x2)
    wq, sw = weight_codes(w)
    gemm_launch(xq, wq, sx, sw, b, None, out, geglu=True)
    int8_geglu_dense.launches += 1
    return out


def gemm_launch(xq, wq, sx, sw, b, res, out, geglu: bool = False,
                _blocks: Optional[int] = None) -> torch.Tensor:
    """Kernel L alone on K's outputs (codes [M, Kp] and [N, Kp], scales [M]
    and [N]) into ``out`` [..., N] (GEGLU: [..., N / 2], no res; bf16 or
    fp32, b and res of its dtype), on :func:`l_plan`'s persistent blocks
    (``_blocks``: another count, for tests of the tile walk). Counts no
    launch: the layers count theirs."""
    M, N = xq.shape[0], wq.shape[0]
    blocks = l_plan(M, N, geglu) if _blocks is None else _blocks
    name = 'int8_geglu_dense' if geglu else 'int8_dense'
    require(blocks >= 1, name, f'needs a block, got {blocks}')
    rc = library().hcp_int8_gemm(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        0 if b is None else b.data_ptr(), 0 if res is None else res.data_ptr(),
        out.data_ptr(), M, N, xq.shape[1], int(geglu), blocks, int(out.dtype == torch.float32),
        stream_handle(out.device))
    check(rc, name)
    return out


def _dense_cpu(x, w, b, res) -> torch.Tensor:
    """The CPU route: the plain version with the weight's kept codes."""
    K, N = x.shape[-1], w.shape[0]
    xq, sx = quantize_rows_plain(x.reshape(-1, K))
    wq, sw = weight_codes(w)
    out = int8_gemm_plain(xq, wq, sx, sw, x.dtype, b).reshape(*x.shape[:-1], N)
    return out if res is None else out + res


def _halves(x, w, b) -> torch.Tensor:
    """The GEGLU layer's product before the gate: [..., 2 I] in x's dtype."""
    if x.device.type == 'cpu':
        return _dense_cpu(x, w, b, None)
    return _dense_launch(x, w, b, None)


def _straight_through(ctx, g):
    """dx, dW and db of the exact product for the output gradient g."""
    x, w = ctx.saved_tensors[:2]
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    g2 = g.reshape(-1, g.shape[-1]).float()
    dx = (g2 @ w.float()).reshape(ctx.x_shape).to(ctx.x_dtype) if need_x else None
    dw = (g2.t() @ x.reshape(-1, x.shape[-1]).float()).to(ctx.w_dtype) if need_w else None
    db = g2.sum(dim=0).to(ctx.b_dtype) if need_b else None
    return dx, dw, db


class _Int8Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, res):
        if x.device.type == 'cpu':
            out = _dense_cpu(x, w, b, res)
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
        dx, dw, db = _straight_through(ctx, g)
        dres = g.to(ctx.res_dtype) if ctx.needs_input_grad[3] else None
        return dx, dw, db, dres


class _Int8GegluDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        bx = None if b is None else b.to(x.dtype)
        if x.device.type == 'cpu':
            out = _gate(_dense_cpu(x, w, bx, None))
        else:
            out = _geglu_launch(x, w, bx)
        ctx.save_for_backward(x, w, bx)
        ctx.x_shape, ctx.x_dtype, ctx.w_dtype = x.shape, x.dtype, w.dtype
        ctx.b_dtype = None if b is None else b.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, bx = ctx.saved_tensors
        h, gate = _halves(x, w, bx).chunk(2, dim=-1)
        with torch.enable_grad():
            h, gate = h.detach().requires_grad_(True), gate.detach().requires_grad_(True)
            dh, dgate = torch.autograd.grad(h * F.gelu(gate), (h, gate), g)
        return _straight_through(ctx, torch.cat([dh, dgate], dim=-1))


def int8_dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
               res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T (+ b) (+ res)`` through dynamic w8a8 int8: x [..., K] (bf16
    or fp32), w [N, K] (any float dtype: it is quantized, its codes kept),
    b [N] (cast to x's dtype), res [..., N] in x's dtype. Differentiable,
    straight through the quantization. A CPU tensor takes the plain
    version; a CUDA tensor launches kernel K (on x; on w where its codes
    are not kept) and L, or raises."""
    return _Int8Dense.apply(x, w, b, res)


def int8_geglu_dense(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h * gelu(gate)`` (exact gelu) of ``int8_dense(x, w, b)``'s halves
    [h | gate]: x [..., K] (bf16 or fp32), w [2 I, K] = [Wv; Wg], b [2 I]
    -> [..., I] in x's dtype. Differentiable as :func:`int8_dense`. A CPU
    tensor takes the plain version; a CUDA tensor launches kernel K (on x;
    on w where its codes are not kept) and the GEGLU L, or raises."""
    return _Int8GegluDense.apply(x, w, b)


quantize_rows.launches = 0
int8_dense.launches = 0
int8_geglu_dense.launches = 0
weight_codes.quantizations = 0
