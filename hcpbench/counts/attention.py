"""Attention ``softmax(q k^T * scale + bias) v`` on [B, H, S, D] tensors."""
from __future__ import annotations

import math


def pairs(sq: int, sk: int, causal: bool) -> int:
    """Query-key pairs the function needs: all of them, or under a causal
    mask aligned to the sequence ends those at or before each query."""
    if not causal:
        return sq * sk
    return sum(min(sk, sk - sq + i + 1) for i in range(sq) if sk - sq + i + 1 > 0)


def forward(q, k, v, causal: bool = False, scale=None, bias=None):
    """(operations, bytes, dtype): the two products, each input read once
    and the output written once."""
    B, H, sq, d = q.shape
    sk, dv = k.shape[-2], v.shape[-1]
    n = pairs(sq, sk, causal)
    flops = 2 * B * H * n * (d + dv)
    elems = B * H * (sq * d + sk * d + sk * dv + sq * dv)
    nbytes = elems * q.element_size()
    if bias is not None:
        nbytes += math.prod(bias.shape) * bias.element_size()
    return flops, nbytes, q.dtype


def backward(q, k, v, causal: bool = False, scale=None, bias=None):
    """(operations, bytes, dtype) of the gradient: the four products dV =
    P^T dO, dP = dO V^T, dQ = dS K and dK = dS^T Q; q, k, v, o and dO read
    once, dQ, dK and dV written once. A recompute of P is the kernel's
    choice and is not counted."""
    B, H, sq, d = q.shape
    sk, dv = k.shape[-2], v.shape[-1]
    n = pairs(sq, sk, causal)
    flops = 2 * B * H * n * (2 * d + 2 * dv)
    elems = B * H * (2 * sq * d + 2 * sk * d + 2 * sk * dv + 2 * sq * dv)
    return flops, elems * q.element_size(), q.dtype
