"""GroupNorm (fp32 statistics) + affine + optional SiLU on channels-last
tensors: kernel D, its launch plan, its plain PyTorch version and its
``torch.autograd.Function``.

Counterpart of ``hcpdiff_tpu/ops/groupnorm.py``. There the Pallas kernel
ran only where C % 128 == 0 and the [S, C] block fit VMEM; here one kernel
(``csrc/groupnorm.cu``: one cooperative launch a call, each block's rows
read into shared memory by bulk copies, a barrier a sample between the
statistics and the normalisation, see its header) takes every shape of
the slice, so every GroupNorm of the UNet and VAE on a CUDA tensor goes
through it, bf16 or fp32 (an fp32 x is read, normalised and written in
fp32), with bf16 or fp32 scale and bias read as they are.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import (KERNEL_DTYPES, accum_dtype, aligned16, check, library, require,
                     require_cuda, stream_handle)
from ._plan import SMS

# csrc/groupnorm.cu's HCP_GN_LIMITS table (the CPU tests hold the two equal)
GN_LIMITS = {'MAX_THREADS': 640, 'BLOCKS_PER_SM': 1, 'MAX_SMEM': 232448, 'MAX_SLOTS': 32,
             'CHUNK_BYTES': 32768}
MAX_TX_BYTES = (1 << 20) - 1     # an mbarrier's transaction count: the most a chunk holds


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def gn_smem(threads: int, groups: int, slots: int, slot_bytes: int) -> int:
    """Shared memory of a block, as csrc/groupnorm.cu's smem_layout: the
    mbarriers, the threads' [8, threads + 2] float2 (sum, sum of squares),
    [2, groups] fp32 mean and rstd, and the chunk slots."""
    return (_align128(8 * GN_LIMITS['MAX_SLOTS']) + _align128(64 * (threads + 2))
            + _align128(8 * groups) + slots * slot_bytes)


@dataclasses.dataclass(frozen=True)
class GnPlan:
    """Kernel D's launch for x [B, S, C]: a grid of B * blocks blocks, one
    an SM at most, all resident at once; block k of a sample owns rows
    [k * rows, min(S, (k + 1) * rows)), read in chunks of chunk_rows rows
    into `slots` slots of shared memory; `rpp` rows are read at once by
    C / 8 * rpp threads (``threads``: rounded up to whole warps)."""
    B: int
    S: int
    C: int
    itemsize: int
    groups: int
    blocks: int
    rows: int
    chunk_rows: int
    slots: int
    rpp: int
    threads: int
    smem: int

    @property
    def grid(self) -> int:
        return self.B * self.blocks

    def span(self, k: int):
        """The rows [start, stop) of a sample that block k owns."""
        return k * self.rows, min(self.S, (k + 1) * self.rows)

    @property
    def per_sm(self) -> int:
        """Blocks an SM (the grid is resident at once)."""
        return GN_LIMITS['BLOCKS_PER_SM']

    @property
    def chunks(self) -> int:
        """Chunks of a full block's span."""
        return -(-self.rows // self.chunk_rows)

    @property
    def regime(self) -> str:
        """'resident': every chunk of a span stays in the slots, so x is read
        once; 're-read': pass 2 reads the chunks the slots lost again."""
        return 'resident' if self.slots >= self.chunks else 're-read'


@functools.lru_cache(maxsize=None)
def gn_plan(B: int, S: int, C: int, itemsize: int, groups: int = 32, sms: int = SMS,
            chunk_bytes: int = GN_LIMITS['CHUNK_BYTES'], blocks: int = 0) -> GnPlan:
    """Kernel D's plan for x [B, S, C] of ``itemsize``-byte elements on a
    card of ``sms`` SMs (cached). Each sample gets as many blocks as the
    card holds at once (sms * BLOCKS_PER_SM / B; ``blocks`` > 0 caps it),
    but no more than S, and spans of equal rows with none empty; a span is
    cut into chunks of about ``chunk_bytes`` of equal rows, and the slots
    are as many chunks as fit the shared memory left (at most MAX_SLOTS).
    Raises ValueError for a shape outside the kernel's contract: C % 8 or C
    % groups nonzero, C / 8 > MAX_THREADS, or more samples than the card
    holds blocks."""
    name = 'group_norm_silu'
    lim = GN_LIMITS
    vr = C // 8
    require(S >= 1 and C % 8 == 0 and groups >= 1 and C % groups == 0 and 1 <= vr
            and vr <= lim['MAX_THREADS'], name,
            f'C={C} must be a multiple of 8 and of groups={groups}, at most '
            f'{8 * lim["MAX_THREADS"]}, and S={S} at least 1')
    capacity = sms * lim['BLOCKS_PER_SM']
    require(1 <= B <= capacity, name, f'batch {B} exceeds the {capacity} blocks the card holds')
    rpp = lim['MAX_THREADS'] // vr
    threads = -(-vr * rpp // 32) * 32
    rows = -(-S // min(capacity // B, blocks or capacity, S))
    blocks = -(-S // rows)
    row_bytes = C * itemsize
    nchunks = -(-rows * row_bytes // chunk_bytes)
    chunk_rows = -(-rows // nchunks)
    nchunks = -(-rows // chunk_rows)
    slot_bytes = chunk_rows * row_bytes
    slots = min(nchunks, (lim['MAX_SMEM'] - gn_smem(threads, groups, 0, 0))
                // slot_bytes, lim['MAX_SLOTS'])
    require(slots >= 1 and slot_bytes <= MAX_TX_BYTES, name,
            f'a row of C={C} does not fit a chunk slot')
    return GnPlan(B, S, C, itemsize, groups, blocks, rows, chunk_rows, slots, rpp, threads,
                  gn_smem(threads, groups, slots, slot_bytes))


def group_norm_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          groups: int = 32, eps: float = 1e-5,
                          apply_silu: bool = True) -> torch.Tensor:
    """Plain version: fp32 statistics, E[x^2] - E[x]^2 clamped at 0, as
    ``_gn_silu_xla_direct`` computes them. x: [B, ..., C]."""
    B, C = x.shape[0], x.shape[-1]
    dt = accum_dtype(x)
    xg = x.reshape(B, -1, groups, C // groups).to(dt)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg.square().mean(dim=(1, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * scale.to(dt) + bias.to(dt)
    if apply_silu:
        y = F.silu(y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the barrier's words (4 a sample: two counts and a generation; zero at
# first, then kept by the kernel) of each (device, stream): calls on one
# stream never overlap
_COUNTERS: dict = {}


def _counters(device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(4 * _sm_count(device.index) * GN_LIMITS['BLOCKS_PER_SM'],
                                     dtype=torch.int32, device=device)
    return _COUNTERS[key]


def _launch(x, scale, bias, groups: int, eps: float, apply_silu: bool,
            plan: Optional[GnPlan] = None) -> torch.Tensor:
    """One launch of kernel D, or one a slice of as many samples as the card
    holds blocks where the batch is larger; ``plan`` (one launch) defaults to
    :func:`gn_plan` of the shape."""
    name = 'group_norm_silu'
    dt = require_cuda(name, x)
    B, C = x.shape[0], x.shape[-1]
    S = math.prod(x.shape[1:-1])
    require(x.dim() >= 3 and x.is_contiguous() and aligned16(x), name,
            f'x must be a contiguous 16-byte-aligned [B, ..., C] tensor, got {tuple(x.shape)}')
    require(scale.shape == (C,) and bias.shape == (C,) and scale.dtype == bias.dtype
            and scale.dtype in KERNEL_DTYPES and scale.is_contiguous() and bias.is_contiguous()
            and scale.device == x.device and bias.device == x.device, name,
            'scale/bias must be contiguous [C] tensors of one dtype, bfloat16 or float32, '
            'on the same device')
    sms = _sm_count(x.device.index)
    step = B if plan is not None else sms * GN_LIMITS['BLOCKS_PER_SM']
    y = torch.empty_like(x)
    stream = stream_handle(x.device)
    for b0 in range(0, B, step):
        xs, ys = x[b0:b0 + step], y[b0:b0 + step]
        nb = xs.shape[0]
        p = plan or gn_plan(nb, S, C, x.element_size(), groups, sms)
        require((p.B, p.S, p.C, p.itemsize, p.groups) == (nb, S, C, x.element_size(), groups),
                name, f'{p} is not for this call')
        partial = torch.empty(p.grid * 2 * groups, dtype=torch.float32, device=x.device)
        rc = library().hcp_group_norm(
            xs.data_ptr(), scale.data_ptr(), bias.data_ptr(), ys.data_ptr(), partial.data_ptr(),
            _counters(x.device, stream).data_ptr(), nb, S, C, groups, p.blocks, p.rows,
            p.chunk_rows, p.slots, p.rpp, p.threads, p.smem, float(eps),
            int(bool(apply_silu)), int(dt == torch.float32), int(scale.dtype == torch.float32),
            stream)
        check(rc, name)
        group_norm_silu.launches += 1
    return y


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups: int, eps: float, apply_silu: bool):
        if x.device.type == 'cpu':
            y = group_norm_silu_plain(x, scale, bias, groups, eps, apply_silu)
        else:
            y = _launch(x, scale, bias, groups, eps, apply_silu)
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, apply_silu)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        dt = accum_dtype(g)
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().to(dt).requires_grad_(n) for t, n in zip(saved, need)]
            y = group_norm_silu_plain(*ins, *ctx.args)
            grads = iter(torch.autograd.grad(y, [t for t in ins if t.requires_grad], g.to(dt)))
        return (*(next(grads).to(t.dtype) if n else None for t, n in zip(saved, need)),
                None, None, None)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True) -> torch.Tensor:
    """x: [B, ..., C] channels-last (for an NCHW tensor in
    ``torch.channels_last`` format, pass ``x.permute(0, 2, 3, 1)``);
    scale/bias: [C]. Differentiable. A CPU tensor takes the plain version;
    a CUDA tensor launches kernel D or raises."""
    return _GroupNormSiLU.apply(x, scale, bias, groups, eps, apply_silu)


group_norm_silu.launches = 0
