"""The feed-forward products of ``ops/matmul.py``: dense ``x @ w.T + b
(+ res)`` and GEGLU ``(x @ w[:n].T + b[:n]) * gelu(x @ w[n:].T + b[n:])``.
Operations are 2 M N K from the shapes at the entry; each input is read
once and the output written once."""
from __future__ import annotations

import math


def _mk(x):
    K = x.shape[-1]
    return math.prod(x.shape) // K, K


def dense(x, w, b=None, res=None):
    M, K = _mk(x)
    N = w.shape[0]
    elems = M * K + N * K + (N if b is not None else 0) + M * N
    elems += M * N if res is not None else 0
    return 2 * M * N * K, elems * x.element_size(), x.dtype


def geglu(x, w, b=None):
    M, K = _mk(x)
    N = w.shape[0]
    elems = M * K + N * K + (N if b is not None else 0) + M * N // 2
    return 2 * M * N * K, elems * x.element_size(), x.dtype


def _backward(x, w, b, n_dy: int, res=None):
    """The gradients the call needs, by which inputs take one: dX = dY W
    and dW = dY^T X (2 M N K each), db and dres from dY; dY and the inputs
    that a needed product uses read once, each gradient written once."""
    M, K = _mk(x)
    N = w.shape[0]
    need_x, need_w = x.requires_grad, w.requires_grad
    flops = 2 * M * N * K * (need_x + need_w)
    elems = M * n_dy
    elems += (M * K if need_w else 0) + (N * K if need_x else 0)
    elems += (M * K if need_x else 0) + (N * K if need_w else 0)
    elems += N if b is not None and b.requires_grad else 0
    elems += M * N if res is not None and res.requires_grad else 0
    return flops, elems * x.element_size(), x.dtype


def dense_backward(x, w, b=None, res=None):
    return _backward(x, w, b, w.shape[0], res)


def geglu_backward(x, w, b=None):
    """As ``dense_backward`` over the [M, N] pre-activation, whose gradient
    comes from the [M, N/2] output's; the pre-activation itself is the
    kernel's to keep or recompute and is not counted."""
    return _backward(x, w, b, w.shape[0] // 2)
