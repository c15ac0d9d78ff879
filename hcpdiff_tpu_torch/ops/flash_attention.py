"""Attention on [B, H, S, D] with its gradient: kernel A (forward, with an
optional logsumexp output, ``csrc/flash_attention.cu``), kernels E and F
(backward dQ and dK/dV, ``csrc/flash_attention_bwd_dq.cu`` and
``flash_attention_bwd_dkv.cu``), their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them. Every entry takes ``causal``:
keys past each query are masked.

Counterpart of every Pallas kernel of ``hcpdiff_tpu/ops/flash_attention.py``
inside the ``custom_vjp`` of ``_make_flash``. Kernel A replaces the
forwards: the transposed ``_flash_kernel_tq`` (D=40/80 under the JAX
defaults, with ``emit_lse`` for training), the classic K/V-resident
``_flash_kernel`` and its lse variant ``_flash_kernel_lse`` (every head dim
under ``HCP_FLASH_NOMAX=0``, and D=128-like head dims under the defaults)
and the K/V-streaming ``_flash_kernel_stream`` (the VAE's D=512). E and F
replace both backward pairs, the transposed ``_flash_bwd_dq/dkv_kernel_tq``
and the classic ``_flash_bwd_dq/dkv_kernel``. On the card the TPU's
layouts (a matter of lane padding) are one: the kernels read their
operands through strides.

Head dims: the kernels are built for padded head dims 48, 64, 80, 128, 160
and 512, causal or not, forward (with or without lse) and backward. Any
other D (16, 20, 96, 144, 192, ...) is zero-padded along D up to the next
built dim in the wrapper, run with the scale of the original D, and o, dq,
dk and dv are sliced back to D. That is exact: zero columns add nothing to
q k^T, and they give zero columns of o and of dS K, which are sliced away.
So on a CUDA tensor every entry takes any D <= 512, causal or not; a D >
512 raises (no entry falls back to the plain version on the card).

Kernel A's launch plan per padded head dim (key tile, ring stages, output
split, swizzle, blocks an SM) is the ``HCP_FLASH_PLANS`` table of
``csrc/flash_attention.cu``; E's and F's (below 512; at 512 they run the
D-chunked variants of ``csrc/flash_attention_bwd_chunked.cu``) are
``HCP_FLASH_DQ_PLANS`` and ``HCP_FLASH_DKV_PLANS``. All three are read and
checked on the CPU by ``tests/test_torch_port_flash_plan.py``.

Types: bf16 or fp32 tensors. An fp32 call rounds q, k, v (and dO) to bf16,
the TPU's default precision for an fp32 product, and writes o, dq, dk and
dv in fp32; lse and delta are fp32 either way.

Softmax: one exact online softmax with a running max, the classic kernels'
``HCP_FLASH_NOMAX=0`` function. The TPU's default no-max softmax differs
only where a row's scaled logits exceed ~55 nats (``NOMAX_CLAMP_NAT``),
where it clamps and this one stays exact; so the backward recomputes P from
the exact lse and needs no clamp.

Causal: the kernels' mask is top-left aligned (key <= query), as the TPU
kernels' is, and a CUDA tensor with ``causal`` and Sq != Sk raises; the JAX
dispatcher admits causal attention to its kernels only with Sk == Sq. The
plain versions keep ``_xla_attention``'s bottom-right ``tril(kl - ql)``,
which is the same mask when Sq == Sk.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import accum_dtype, aligned16, check, library, require, require_cuda, stream_handle

# Head dims the kernels are instantiated for, after padding D up to a
# multiple of 16 (D=40 -> 48): SD1.5's 40/80/160, SD2.1's and SDXL's 64,
# 128 (which the JAX defaults send to the classic kernels) and the VAE's
# 512 (E and F there: a D-chunked variant). Kernel A has one launch plan
# for each, the HCP_FLASH_PLANS table of csrc/flash_attention.cu, and E
# and F one below 512 (HCP_FLASH_DQ_PLANS, HCP_FLASH_DKV_PLANS).
PADDED_HEAD_DIMS = (48, 64, 80, 128, 160, 512)


def kernel_head_dim(name: str, D: int) -> int:
    """The head dim the kernels run a call of head dim D at: D itself where
    D % 8 == 0 and D padded to a multiple of 16 is built (the kernels pad
    inside their tiles), else the smallest built dim above D, to which the
    wrapper zero-pads the operands; raises where there is none (D > 512)."""
    if D % 8 == 0 and -(-D // 16) * 16 in PADDED_HEAD_DIMS:
        return D
    above = [d for d in PADDED_HEAD_DIMS if d >= D]
    require(bool(above), name, f'head dim {D} exceeds the built dims {PADDED_HEAD_DIMS}')
    return min(above)


def pad_head_dim(t: torch.Tensor, Dp: int) -> torch.Tensor:
    """t [..., D] zero-padded along D to Dp (t itself when D == Dp)."""
    return t if t.shape[-1] == Dp else F.pad(t, (0, Dp - t.shape[-1]))


def _logits(q: torch.Tensor, k: torch.Tensor, scale: float, causal: bool,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q k^T * scale (+ bias) in fp32 (or wider); ``causal`` sets the keys
    past each query (aligned to the sequence ends) to the dtype's minimum."""
    dt = accum_dtype(q)
    logits = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.to(dt)
    if causal:
        ql, kl = q.shape[-2], k.shape[-2]
        keep = torch.ones(ql, kl, dtype=torch.bool, device=q.device).tril(kl - ql)
        logits = logits.masked_fill(~keep, torch.finfo(dt).min)
    return logits


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, causal: bool = False,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v with fp32 logits and softmax and the
    probabilities cast back to q's dtype, as ``_xla_attention`` does it.
    ``bias`` (broadcast to [B, H, Sq, Sk]: the encoder attention mask's
    [B, 1, 1, Sk]) is added to the logits; ``causal`` masks keys past each
    query (aligned to the sequence ends)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    probs = _logits(q, k, scale, causal, bias).softmax(dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, scale: float,
                        causal: bool = False) -> torch.Tensor:
    """Row logsumexp of the scaled (masked) logits, [B, H, Sq], in natural log."""
    return torch.logsumexp(_logits(q, k, scale, causal), dim=-1)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O), [B, H, Sq] contiguous, in fp32 (as
    ``_flash_backward_tq`` computes it under XLA, :914-915)."""
    dt = accum_dtype(o)
    return (do.to(dt) * o.to(dt)).sum(dim=-1).contiguous()


def _plain_p_ds(q, k, v, lse, do, delta, scale, causal):
    """Recomputed P = exp(S*scale - lse) and dS = P*(dO V^T - delta)*scale;
    under ``causal`` P (and so dS) is 0 past each query."""
    dt = accum_dtype(q)
    p = _logits(q, k, scale, causal).sub_(lse.to(dt)[..., None]).exp_()
    ds = torch.matmul(do.to(dt), v.to(dt).transpose(-1, -2))
    ds = ds.sub_(delta.to(dt)[..., None]).mul_(p).mul_(scale)
    return p, ds


def flash_bwd_dq_plain(q, k, v, lse, do, delta, scale: float,
                       causal: bool = False) -> torch.Tensor:
    """Plain version of kernel E: dQ = dS K, computed explicitly in fp32."""
    _, ds = _plain_p_ds(q, k, v, lse, do, delta, scale, causal)
    return torch.matmul(ds, k.to(ds.dtype)).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, lse, do, delta, scale: float, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel F: dK = dS^T Q, dV = P^T dO, in fp32."""
    p, ds = _plain_p_ds(q, k, v, lse, do, delta, scale, causal)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(ds.dtype)).to(k.dtype)
    dv = torch.matmul(p.transpose(-1, -2), do.to(p.dtype)).to(v.dtype)
    return dk, dv


def flash_attention_backward_plain(q, k, v, o, lse, do, scale: float, causal: bool = False):
    """dq, dk, dv of softmax(q k^T * scale) v from the forward's o and lse,
    computed explicitly in fp32: the function kernels E and F are held
    against."""
    delta = attention_delta(o, do)
    dq = flash_bwd_dq_plain(q, k, v, lse, do, delta, scale, causal)
    return (dq, *flash_bwd_dkv_plain(q, k, v, lse, do, delta, scale, causal))


def _rows_aligned(t: torch.Tensor) -> bool:
    """Unit stride on D and 16-byte aligned rows: the layout the kernels read."""
    return t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3]) and aligned16(t)


def _strides(name: str, tensors) -> ctypes.Array:
    """(batch, head, seq) strides of [B, H, S, D] tensors."""
    strides = []
    for t in tensors:
        require(_rows_aligned(t), name, 'rows must be 16-byte aligned with unit stride on D')
        strides += list(t.stride()[:3])
    return (ctypes.c_longlong * len(strides))(*strides)


def _kernel_operands(name: str, q, k, v, do, causal: bool):
    """Check a call's tensors and return (dtype, D, Dp, operands): q, k, v
    (and dO) rounded to bf16 and zero-padded along D to the dim Dp the
    kernel runs at."""
    dt = require_cuda(name, q, k, v, do)
    require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, name, 'expects [B, H, S, D] tensors')
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    require(k.shape == (B, H, Sk, D) and v.shape == k.shape and Sk > 0, name,
            f'shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}')
    require(do is None or do.shape == q.shape, name, f'dO must be {tuple(q.shape)}')
    Dp = kernel_head_dim(name, D)
    require(B * H <= 65535, name, f'B*H={B * H} exceeds the grid limit')
    require(not causal or Sk == Sq, name,
            f'causal needs as many keys as queries (the mask is top-left aligned), '
            f'got Sq={Sq}, Sk={Sk}')
    ops = [None if t is None else pad_head_dim(t.to(torch.bfloat16), Dp) for t in (q, k, v, do)]
    return dt, D, Dp, ops


def _check_stats(name: str, q, lse, delta) -> None:
    for t in (lse, delta):
        require(t.shape == q.shape[:3] and t.dtype == torch.float32 and t.is_contiguous()
                and t.device == q.device, name, 'lse/delta must be contiguous fp32 [B, H, Sq]')


def _like_heads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An empty [B, H, S, D] tensor of ``dtype`` laid out as [B, S, H, D],
    so merging heads back costs no copy."""
    B, H, S, D = t.shape
    return torch.empty(B, S, H, D, dtype=dtype, device=t.device).transpose(1, 2)


def _launch_forward(q, k, v, scale: float, causal: bool, with_lse: bool):
    name = 'flash_attention'
    dt, D, Dp, (q, k, v, _) = _kernel_operands(name, q, k, v, None, causal)
    if scale < 0:           # the kernel's running max needs scale >= 0: q (-k)^T * -scale
        k, scale = -k, -scale
    B, H, Sq, _ = q.shape
    out = _like_heads(q, dt)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device) if with_lse
           else None)
    rc = library().hcp_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(), B, H, Sq, k.shape[2], Dp,
        ctypes.cast(_strides(name, (q, k, v, out)), ctypes.c_void_p), scale, int(causal),
        int(dt == torch.float32), stream_handle(q.device))
    check(rc, name)
    flash_attention.launches += 1
    if with_lse:
        flash_attention_lse.launches += 1
    return out[..., :D], lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward that also returns the row logsumexp: (o [B, H, Sq, D],
    lse [B, H, Sq] fp32, natural log). A CPU tensor takes the plain
    versions; a CUDA tensor launches kernel A with its lse output or raises.
    No gradient: :func:`flash_attention` is the differentiable entry."""
    if q.device.type == 'cpu':
        return (attention_plain(q, k, v, scale, causal),
                attention_lse_plain(q, k, scale, causal))
    return _launch_forward(q, k, v, scale, causal, with_lse=True)


def flash_attention_bwd_dq(q, k, v, lse, do, delta, scale: float,
                           causal: bool = False) -> torch.Tensor:
    """dQ from q, k, v, dO [B, H, S, D] and fp32 lse, delta [B, H, Sq]. A
    CPU tensor takes the plain version; a CUDA tensor launches kernel E or
    raises."""
    if q.device.type == 'cpu':
        return flash_bwd_dq_plain(q, k, v, lse, do, delta, scale, causal)
    name = 'flash_attention_bwd_dq'
    dt, D, Dp, (q, k, v, do) = _kernel_operands(name, q, k, v, do, causal)
    _check_stats(name, q, lse, delta)
    B, H, Sq, _ = q.shape
    dq = _like_heads(q, dt)
    rc = library().hcp_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, H, Sq, k.shape[2], Dp,
        ctypes.cast(_strides(name, (q, k, v, do, dq)), ctypes.c_void_p), scale, int(causal),
        int(dt == torch.float32), stream_handle(q.device))
    check(rc, name)
    flash_attention_bwd_dq.launches += 1
    return dq[..., :D]


def flash_attention_bwd_dkv(q, k, v, lse, do, delta, scale: float, causal: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), as :func:`flash_attention_bwd_dq`; kernel F on the card."""
    if q.device.type == 'cpu':
        return flash_bwd_dkv_plain(q, k, v, lse, do, delta, scale, causal)
    name = 'flash_attention_bwd_dkv'
    dt, D, Dp, (q, k, v, do) = _kernel_operands(name, q, k, v, do, causal)
    _check_stats(name, q, lse, delta)
    B, H, Sq, _ = q.shape
    dk, dv = _like_heads(k, dt), _like_heads(v, dt)
    rc = library().hcp_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Sq, k.shape[2], Dp,
        ctypes.cast(_strides(name, (q, k, v, do, dk, dv)), ctypes.c_void_p), scale,
        int(causal), int(dt == torch.float32), stream_handle(q.device))
    check(rc, name)
    flash_attention_bwd_dkv.launches += 1
    return dk[..., :D], dv[..., :D]


# The remat policy 'flash' (models/unet.py:remat): while a checkpointed
# block runs forward, each forward with lse keeps its (o, lse); while the
# checkpoint recomputes the block in the backward, each takes the pair the
# forward kept in place of launching A again, so kernels E and F read the o
# and lse kernel A wrote. Thread-local: the recompute runs on the autograd
# engine's thread.
_KEPT = threading.local()


@contextlib.contextmanager
def keep_flash_outputs(kept: list, replay: bool):
    """Within the block, each forward with lse appends its (o, lse) to
    ``kept`` or, with ``replay``, takes the next pair of ``kept`` instead."""
    outer = getattr(_KEPT, 'state', None)
    _KEPT.state = [kept, replay, 0]
    try:
        yield
    finally:
        _KEPT.state = outer


def _forward_lse(q, k, v, scale: float, causal: bool):
    """flash_attention_lse, or the pair a forward kept (keep_flash_outputs)."""
    state = getattr(_KEPT, 'state', None)
    if state is None:
        return flash_attention_lse(q, k, v, scale, causal)
    kept, replay, i = state
    if replay:
        state[2] += 1
        return kept[i]
    kept.append(flash_attention_lse(q, k, v, scale, causal))
    return kept[-1]


class _FlashAttention(torch.autograd.Function):
    """Forward: kernel A (with lse when a gradient will be taken) or the
    plain versions on the CPU. Backward: kernels E and F, or their plain
    versions on the CPU. Saves q, k, v, o and lse, as the JAX ``fwd``
    (:1071-1085) does, and ``causal``; in a recompute under the remat
    policy 'flash' o and lse are the ones the forward kept."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, needs_grad: bool):
        if needs_grad:
            o, lse = _forward_lse(q, k, v, scale, causal)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.scale, ctx.causal = scale, causal
            return o
        if q.device.type == 'cpu':
            return attention_plain(q, k, v, scale, causal)
        return _launch_forward(q, k, v, scale, causal, with_lse=False)[0]

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # dO arrives with whatever strides autograd gives it: the kernels take
        # them when they can, and a contiguous copy otherwise
        if do.device.type != 'cpu' and not _rows_aligned(do):
            do = do.contiguous()
        delta = attention_delta(o, do)
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        args = (q, k, v, lse, do, delta, ctx.scale, ctx.causal)
        dq = flash_attention_bwd_dq(*args) if need_q else None
        dk = dv = None
        if need_k or need_v:
            dk, dv = flash_attention_bwd_dkv(*args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, causal: bool = False) -> torch.Tensor:
    """q [B, H, Sq, D], k/v [B, H, Sk, D], any strides with a unit stride on
    D (so a head split ``x.view(B, S, H, D).transpose(1, 2)`` needs no
    copy). ``causal`` masks keys past each query (on the card only with
    Sq == Sk). Differentiable. A CPU tensor takes the plain versions; a
    CUDA tensor launches kernel A (and E, F in the backward) or raises. The
    kernel's output is returned as a [B, H, Sq, D] view of a [B, Sq, H, D]
    buffer, so merging heads back costs no copy."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, scale, bool(causal), needs_grad)


flash_attention.launches = 0            # kernel A, with or without lse
flash_attention_lse.launches = 0        # kernel A with its lse output
flash_attention_bwd_dq.launches = 0     # kernel E
flash_attention_bwd_dkv.launches = 0    # kernel F
