"""Seeded random weights, made on the models' device in a few large calls.

One model's parameters, taken in sorted-name order, are one flat draw of
standard normal numbers in the dtype they are served in, from a generator
on the device seeded with (run seed, model name). Each parameter's slice is
then scaled in one multiply over the whole draw:

- a matrix or convolution kernel (two or more dimensions) by fan_in^-1/2
  (LeCun normal), a table whose name ends in ``embedding`` by 0.02;
- a one-dimensional ``weight`` (a norm's scale) becomes 1 + 0.02 n, a
  ``bias`` 0.02 n, so that scales and biases are not trivially 1 and 0.

The program's modules and the reference's have the same parameter names
and shapes, so the same seed fills both with the same numbers; the
reference takes them in fp32 (exact, from the served dtype).
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch
import torch.nn as nn


def model_seed(seed: int, name: str) -> int:
    """A 63-bit seed of (run seed, model name)."""
    digest = hashlib.sha256(f'{int(seed)}/{name}'.encode()).digest()
    return int.from_bytes(digest[:8], 'little') >> 1


def scale_of(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(multiplier, offset) of one parameter's standard normal draw."""
    if len(shape) >= 2:
        if name.endswith('embedding'):
            return 0.02, 0.0
        return math.prod(shape[1:]) ** -0.5, 0.0
    return (0.02, 1.0) if name.endswith('weight') else (0.02, 0.0)


@torch.no_grad()
def draw(module: nn.Module, seed: int, name: str, dtype: torch.dtype,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor} for every parameter of ``module``, as views
    of one flat draw of ``dtype`` on ``device``."""
    params = sorted((n, tuple(p.shape)) for n, p in module.named_parameters())
    sizes = [math.prod(s) for _, s in params]
    gen = torch.Generator(device=device).manual_seed(model_seed(seed, name))
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
    coefs = [scale_of(n, s) for n, s in params]
    mult = torch.tensor([m for m, _ in coefs], dtype=dtype, device=device)
    flat.mul_(mult.repeat_interleave(torch.tensor(sizes, device=device)))
    out, pos = {}, 0
    for (n, s), size, (_, offset) in zip(params, sizes, coefs):
        out[n] = flat[pos:pos + size].view(s)
        if offset:
            out[n].add_(offset)
        pos += size
    return out


@torch.no_grad()
def fill(module: nn.Module, seed: int, name: str, dtype: torch.dtype) -> nn.Module:
    """Copy the draw into ``module``'s own parameters (each keeps its dtype
    and device) and free the draw."""
    device = next(module.parameters()).device
    values = draw(module, seed, name, dtype, device)
    for n, p in module.named_parameters():
        p.copy_(values[n])
    return module
