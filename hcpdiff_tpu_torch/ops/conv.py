"""3x3 stride-1 SAME convolution with a fused epilogue (bias, per-sample row
bias, residual): kernel J, its plain PyTorch version, its launch plan and
its ``torch.autograd.Function``.

Counterpart of ``hcpdiff_tpu/ops/conv.py``. The UNet's resblocks fuse
their time-embedding add into conv1 (``row_bias``) and their skip add into
conv2 (``res``). Layouts are PyTorch's: x [B, Cin, H, W] and res
[B, Cout, H, W] in ``torch.channels_last`` memory (NHWC bytes, which is
what the kernel reads), the ``nn.Conv2d`` weight [Cout, Cin, 3, 3], which
the kernel reads as OHWI, the memory of a channels_last weight. The TPU
kernel's VMEM gate (``_fits``, which sent large images to XLA) has no
counterpart: kernel J (``csrc/conv.cu``) takes every shape. The backward is
the vjp of ``_conv3_ref`` (``conv.py:150-160``, ``:183-185``) in fp32.

Kernel J takes bf16 or fp32 tensors. An fp32 call rounds x and w to bf16
(the TPU's default precision for an fp32 product: bf16 operands, fp32
accumulation) and keeps bias, row_bias, res and the output in fp32, so
the result is rounded once.

The launch plan (:func:`conv_plan`, plain Python) picks the kernel's
column tile BN and a split of K over ``splits`` blocks for each shape;
see its docstring.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import accum_dtype, aligned16, check, library, require, require_cuda, stream_handle
from ._plan import BM, SMS, WAVE_FILL, TilePlan, split_workspace

# csrc/conv.cu: channels per K step (BM output pixels per block), the
# column tiles it is built for, and the most K splits a plan takes
BK_CHANNELS = 64
BN_CHOICES = (320, 160, 128)
MAX_SPLITS = 8
# the plan's cost model: seconds per output column of one block's K step
# (2 * BM * 64 FLOPs at half of one SM's share of 989 TFLOP/s), the fixed
# per-step share in columns (the A tile's copies and the step's barrier),
# and the rate at which split partial sums are written and read back
_STEP_S = 2 * BM * BK_CHANNELS / (0.5 * 989e12 / SMS)
_STEP_FIXED_COLUMNS = 64
_REDUCE_BYTES_PER_S = 2.5e12


@dataclasses.dataclass(frozen=True)
class ConvPlan(TilePlan):
    """How kernel J covers out[M = B*H*W, N = Cout] (``TilePlan``); a K step
    is one tap of 64 input channels, zero-padded past Cin: ``ksteps = 9 *
    ceil(Cin / 64)``."""


@functools.lru_cache(maxsize=None)
def conv_plan(B: int, H: int, W: int, Cin: int, Cout: int) -> ConvPlan:
    """BN and the K split for one conv shape (cached: the UNet asks for the
    same few shapes at every step).

    BN is one of BN_CHOICES that divides Cout (SD1.5's 320, 640 and 1280:
    160 or 320); where none does, those wasting the fewest columns of the
    last tile. Among those and splits S <= MAX_SPLITS, the plan takes the
    least estimated time: waves of blocks x K steps a block x (BN + a fixed
    share) for the products, plus the split partial sums' traffic. S > 1 is
    taken only where the unsplit grid is short of a wave (WAVE_FILL * SMS
    blocks) and the split grid reaches one."""
    M = B * H * W
    ksteps = 9 * -(-Cin // BK_CHANNELS)
    waste = {bn: -(-Cout // bn) * bn - Cout for bn in BN_CHOICES}
    wave = WAVE_FILL * SMS
    best = None
    for bn in BN_CHOICES:
        if waste[bn] != min(waste.values()):
            continue
        tiles = -(-M // BM) * -(-Cout // bn)
        for s in range(1, min(MAX_SPLITS, ksteps) + 1):
            if s > 1 and (tiles >= wave or tiles * s < wave):
                continue
            est = (math.ceil(tiles * s / SMS) * -(-ksteps // s) * (bn + _STEP_FIXED_COLUMNS)
                   * _STEP_S)
            if s > 1:
                est += 2 * 4 * s * M * Cout / _REDUCE_BYTES_PER_S
            key = (est, -bn, s)
            if best is None or key < best[0]:
                best = (key, bn, s)
    return ConvPlan(best[1], best[2], M, Cout, ksteps)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                  row_bias: Optional[torch.Tensor] = None,
                  res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """As ``_conv3_ref``: the conv and the adds in fp32, one rounding."""
    dt = accum_dtype(x)
    out = F.conv2d(x.to(dt), w.to(dt), None if b is None else b.to(dt), padding=1)
    if row_bias is not None:
        out = out + row_bias.to(dt)[:, :, None, None]
    if res is not None:
        out = out + res.to(dt)
    return out.to(x.dtype)


def _launch(x, w, b, row_bias, res, plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """x, w and res are taken in channels_last memory; a tensor in another
    layout (a merged LoRA weight, say) is copied into it first. ``plan``
    defaults to :func:`conv_plan` of the shape."""
    name = 'conv3x3'
    dt = require_cuda(name, x, w, b, row_bias, res)
    require(x.dim() == 4 and w.dim() == 4, name, 'x and w must be 4-d')
    B, Cin, H, W = x.shape
    Cout = w.shape[0]
    require(w.shape == (Cout, Cin, 3, 3), name,
            f'w must be [Cout, {Cin}, 3, 3], got {tuple(w.shape)}')
    require(Cin % 8 == 0 and Cout % 2 == 0, name,
            f'needs Cin % 8 == 0 and an even Cout, got Cin={Cin}, Cout={Cout}')
    cl = torch.channels_last
    x = x.to(torch.bfloat16).contiguous(memory_format=cl)
    w = w.to(torch.bfloat16).contiguous(memory_format=cl)
    out = torch.empty(B, Cout, H, W, dtype=dt, device=x.device, memory_format=cl)
    if res is not None:
        require(res.shape == out.shape, name, f'res must be {tuple(out.shape)}')
        res = res.contiguous(memory_format=cl)
    require(b is None or (b.shape == (Cout,) and b.is_contiguous()), name, f'b must be [{Cout}]')
    require(row_bias is None or (row_bias.shape == (B, Cout) and row_bias.is_contiguous()),
            name, f'row_bias must be a contiguous [{B}, {Cout}] tensor')
    require(all(aligned16(t) for t in (x, w, out) + ((res,) if res is not None else ())),
            name, 'x, w and res must be 16-byte aligned')
    plan = conv_plan(B, H, W, Cin, Cout) if plan is None else plan
    require(plan.bn in BN_CHOICES and 1 <= plan.splits <= plan.ksteps, name,
            f'no kernel instance for {plan}')
    ws = split_workspace(plan, x.device)
    rc = library().hcp_conv3x3(
        x.data_ptr(), w.data_ptr(), *[0 if t is None else t.data_ptr()
                                      for t in (b, row_bias, res)],
        out.data_ptr(), 0 if ws is None else ws.data_ptr(), B, H, W, Cin, Cout, plan.bn,
        plan.splits, int(dt == torch.float32), stream_handle(x.device))
    check(rc, name)
    return out


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, row_bias, res):
        if x.device.type == 'cpu':
            out = conv3x3_plain(x, w, b, row_bias, res)
        else:
            out = _launch(x, w, b, row_bias, res)
            conv3x3.launches += 1
        need_x, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(x if need_w else None, w if need_x else None)
        ctx.x_shape, ctx.w_shape = x.shape, w.shape
        ctx.dtypes = [None if t is None else t.dtype for t in (x, w, b, row_bias, res)]
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        dt = accum_dtype(g)
        g32 = g.to(dt)
        grads = [
            torch.nn.grad.conv2d_input(ctx.x_shape, w.to(dt), g32, padding=1) if need[0] else None,
            torch.nn.grad.conv2d_weight(x.to(dt), ctx.w_shape, g32, padding=1) if need[1] else None,
            g32.sum(dim=(0, 2, 3)) if need[2] else None,
            g32.sum(dim=(2, 3)) if need[3] else None,
            g32 if need[4] else None,
        ]
        return tuple(None if d is None else d.to(t) for d, t in zip(grads, ctx.dtypes))


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
            row_bias: Optional[torch.Tensor] = None,
            res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv of x [B, Cin, H, W] with w [Cout, Cin, 3, 3],
    plus b [Cout], row_bias [B, Cout] (broadcast over pixels) and res
    [B, Cout, H, W], added in fp32 and rounded once. Differentiable. A CPU
    tensor takes the plain version; a CUDA tensor (bf16, or fp32 with x and
    w rounded to bf16) launches kernel J (output in channels_last memory)
    or raises."""
    return _Conv3x3.apply(x, w, b, row_bias, res)


conv3x3.launches = 0
