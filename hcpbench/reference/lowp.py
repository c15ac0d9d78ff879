"""The reference computed one precision below the configuration's, for the
control of a cell whose program has no lower-precision path of its own that
runs: while ``LowerPrecision(dtype)`` is active, every ``F.linear`` and
``F.conv2d`` (each Linear and Conv2d layer of the reference models) takes
its input and weight rounded to the format below ``dtype``, and its output's
gradient rounded to that format's gradient format before the backward's
products use it. Attention's products and every other operation stay as
they are.

Below bf16 and fp16 is fp8, as H100 training recipes run it: E4M3 for the
forward's operands and E5M2 for gradients, each tensor scaled by its own
largest magnitude onto the format's largest finite value. Below fp32 is
bf16.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
BELOW = {torch.bfloat16: FP8, torch.float16: FP8,
         torch.float32: (torch.bfloat16, torch.bfloat16)}


def rounded(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """x rounded to ``fmt`` and back to its own dtype; an fp8 format is
    scaled per tensor by the largest magnitude."""
    if fmt not in FP8:
        return x.to(fmt).to(x.dtype)
    amax = x.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = torch.finfo(fmt).max / amax
    return ((x.float() * scale).to(fmt).float() / scale).to(x.dtype)


class _Rounded(torch.autograd.Function):
    """Forward: the operand rounded; backward: the gradient passed as it is
    (the product's own backward already takes the rounded operands)."""

    @staticmethod
    def forward(ctx, x, fmt):
        return rounded(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _operand(x: torch.Tensor, fmt) -> torch.Tensor:
    return _Rounded.apply(x, fmt) if x.requires_grad else rounded(x, fmt)


def _grad_rounded(y: torch.Tensor, fmt) -> torch.Tensor:
    if y.requires_grad:
        y.register_hook(lambda g: rounded(g, fmt))
    return y


class LowerPrecision:
    """``with LowerPrecision(torch.bfloat16):`` computes every Linear and
    Conv2d layer in fp8 (see the module's docstring)."""

    def __init__(self, dtype: torch.dtype):
        self.fmts: Tuple[torch.dtype, torch.dtype] = BELOW[dtype]
        self.saved = None

    def __enter__(self):
        fwd, bwd = self.fmts
        linear, conv2d = F.linear, F.conv2d
        self.saved = (linear, conv2d)

        def q_linear(x, w, b=None):
            return _grad_rounded(linear(_operand(x, fwd), _operand(w, fwd), b), bwd)

        def q_conv2d(x, w, b=None, *a, **k):
            return _grad_rounded(conv2d(_operand(x, fwd), _operand(w, fwd), b, *a, **k), bwd)
        F.linear, F.conv2d = q_linear, q_conv2d
        return self

    def __exit__(self, *exc):
        F.linear, F.conv2d = self.saved
        return False
