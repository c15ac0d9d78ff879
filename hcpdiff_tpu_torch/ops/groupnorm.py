"""GroupNorm (fp32 statistics) + affine + optional SiLU on channels-last
tensors: kernel D, its plain PyTorch version and its
``torch.autograd.Function``.

Counterpart of ``hcpdiff_tpu/ops/groupnorm.py``. There the Pallas kernel
ran only where C % 128 == 0 and the [S, C] block fit VMEM; here one kernel
(``csrc/groupnorm.cu``, split-S two-pass design, see its header) takes
every shape of the slice, so every GroupNorm of the UNet and VAE on a CUDA
tensor goes through it, bf16 or fp32 (an fp32 x is read, normalised and
written in fp32).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import accum_dtype, aligned16, check, library, require, require_cuda, stream_handle

# Blocks per sample are chosen so that a pass has about four blocks per SM
# of the H100 (132 SMs), whatever the batch, but no block gets fewer than
# _MIN_ROWS rows of x.
_TARGET_BLOCKS = 4 * 132
_MIN_ROWS = 32
_THREADS = 256     # csrc/groupnorm.cu: THREADS; the kernel needs groups <= THREADS


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


def _launch(x, scale, bias, groups: int, eps: float, apply_silu: bool) -> torch.Tensor:
    name = 'group_norm_silu'
    dt = require_cuda(name, x)
    B, C = x.shape[0], x.shape[-1]
    S = math.prod(x.shape[1:-1])
    require(x.dim() >= 3 and x.is_contiguous() and aligned16(x), name,
            f'x must be a contiguous 16-byte-aligned [B, ..., C] tensor, got {tuple(x.shape)}')
    require(C % 8 == 0 and C % groups == 0 and groups <= _THREADS, name,
            f'C={C} must be a multiple of 8 and of groups={groups} (at most {_THREADS})')
    require(scale.shape == (C,) and bias.shape == (C,) and scale.device == x.device
            and bias.device == x.device, name, 'scale/bias must be [C] on the same device')
    nsplit = max(1, min(-(-S // _MIN_ROWS), -(-_TARGET_BLOCKS // B)))
    rows = -(-S // nsplit)
    nsplit = -(-S // rows)
    workspace = torch.empty(B * nsplit * groups * 2, dtype=torch.float32, device=x.device)
    scale32 = scale.float().contiguous()
    bias32 = bias.float().contiguous()
    y = torch.empty_like(x)
    rc = library().hcp_group_norm(
        x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), y.data_ptr(),
        workspace.data_ptr(), B, S, C, groups, nsplit, rows, float(eps),
        int(bool(apply_silu)), int(dt == torch.float32), stream_handle(x.device))
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
