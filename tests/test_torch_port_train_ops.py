"""The gradients of the PyTorch port's kernel modules against the JAX
package's, on the CPU, in fp32.

On a CPU tensor each port ``autograd.Function`` runs its kernels' plain
versions (forward and backward); the CUDA kernels A, E and F are held
against the same plain versions on the card (tests/test_torch_port_cuda.py,
chip_smoke.py). The JAX references run their Pallas kernels in interpret
mode. Tolerances bound the difference of two fp32 computations of the same
function (summation order, and the Pallas kernels' exp2 and rational erf):
1e-5 on lse (values ~6), 1e-4 elsewhere, and gradcheck's defaults in
float64 for the Functions' own backwards.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from hcpdiff_tpu.ops import flash_attention as jfa
from hcpdiff_tpu.ops import groupnorm as jgn
from hcpdiff_tpu.ops import matmul as jmm
from hcpdiff_tpu_torch.ops import flash_attention as tfa
from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu
from hcpdiff_tpu_torch.ops.matmul import fused_dense, geglu_dense
from tests.torch_port_common import one_torch_thread  # noqa: F401


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _jax_forward_lse(q, k, v, scale):
    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_forward_tq(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False,
                                       scale, 128, 128, emit_lse=True)
    return np.asarray(o), np.asarray(lse)[..., 0]


def test_flash_forward_lse_matches_pallas():
    """(a) o and lse against _flash_forward_tq(emit_lse=True) (#1's lse
    variant), B1 H2 S256 D40, two 128-blocks each way."""
    rng = np.random.default_rng(10)
    q, k, v = (_np(rng, 1, 2, 256, 40) for _ in range(3))
    scale = 40 ** -0.5
    ref_o, ref_lse = _jax_forward_lse(q, k, v, scale)
    before = tfa.flash_attention_lse.launches
    o, lse = tfa.flash_attention_lse(_t(q), _t(k), _t(v), scale)
    assert tfa.flash_attention_lse.launches == before   # CPU: the plain versions
    assert lse.shape == (1, 2, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5)
    np.testing.assert_allclose(o.numpy(), ref_o, atol=1e-4)


@pytest.mark.parametrize('D', [40, 80])
def test_flash_backward_matches_pallas(D):
    """(b) the plain backward and the Function's gradients against
    _flash_backward_tq (#5) in interpret mode. Logits stay far below the
    no-max clamp, where the two backwards compute the same function."""
    rng = np.random.default_rng(11 + D)
    q, k, v, g = (_np(rng, 1, 2, 256, D) for _ in range(4))
    scale = D ** -0.5
    o, lse = _jax_forward_lse(q, k, v, scale)
    with pltpu.force_tpu_interpret_mode():
        ref = jfa._flash_backward_tq(*(jnp.asarray(a) for a in (q, k, v, o)),
                                     jnp.asarray(lse)[..., None], jnp.asarray(g), False, scale,
                                     128, 128)
    plain = tfa.flash_attention_backward_plain(_t(q), _t(k), _t(v), _t(o), _t(lse), _t(g),
                                               scale)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    tfa.flash_attention(tq, tk, tv).backward(_t(g))
    for r, p, a in zip(ref, plain, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-4)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4)


def _jax_vjp(jfn, args, g):
    """Output and gradients of ``jfn`` (jax.vjp, Pallas in interpret mode)
    with cotangent g."""
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
        ref = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(r) for r in ref]


def test_geglu_dense_gradients_match_jax():
    """(c) B: the port recomputes the GEMM in fp32 and differentiates it,
    as _make_geglu_dense's bwd does through XLA."""
    rng = np.random.default_rng(20)
    x, w, b = _np(rng, 2, 64, 64), _np(rng, 64, 256, scale=0.125), _np(rng, 256, scale=0.1)
    g = _np(rng, 2, 64, 128)
    out, ref = _jax_vjp(lambda x_, w_, b_: jmm.geglu_dense(x_, w_, b_, bm=128, bn=128),
                        (x, w, b), g)
    # the JAX weight is [K, 2n]; the port's [2n, K]
    tx, tw, tb = _t(x, True), _t(w.T, True), _t(b, True)
    y = geglu_dense(tx, tw, tb)
    np.testing.assert_allclose(y.detach().numpy(), out, atol=1e-4)
    y.backward(_t(g))
    np.testing.assert_allclose(tx.grad.numpy(), ref[0], atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), ref[1].T, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), ref[2], atol=1e-4)


@pytest.mark.parametrize('with_res', [False, True])
def test_fused_dense_gradients_match_jax(with_res):
    """(c) C: dx = g W, dW = g^T x, db = sum g in fp32, dres = g
    (_make_fused_dense(_res)'s bwd)."""
    rng = np.random.default_rng(21)
    x, w, b = _np(rng, 2, 64, 128), _np(rng, 128, 128, scale=128 ** -0.5), _np(rng, 128)
    res, g = _np(rng, 2, 64, 128), _np(rng, 2, 64, 128)
    args = (x, w, b) + ((res,) if with_res else ())

    def jfn(x_, w_, b_, *r):
        return jmm.fused_dense(x_, w_, b_, bm=128, bn=128, res=r[0] if r else None)
    out, ref = _jax_vjp(jfn, args, g)
    tx, tw, tb = _t(x, True), _t(w.T, True), _t(b, True)
    tres = _t(res, True) if with_res else None
    y = fused_dense(tx, tw, tb, res=tres)
    np.testing.assert_allclose(y.detach().numpy(), out, atol=1e-4)
    y.backward(_t(g))
    np.testing.assert_allclose(tx.grad.numpy(), ref[0], atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), ref[1].T, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), ref[2], atol=1e-4)
    if with_res:
        np.testing.assert_allclose(tres.grad.numpy(), ref[3], atol=1e-6)


def test_fused_dense_frozen_weight_gets_no_grad():
    """ctx.needs_input_grad: a frozen W and b get no gradient computed."""
    x = torch.randn(4, 16, requires_grad=True)
    w, b = torch.randn(8, 16), torch.randn(8)
    fused_dense(x, w, b).sum().backward()
    assert x.grad is not None and w.grad is None and b.grad is None


@pytest.mark.parametrize('silu', [True, False])
def test_group_norm_silu_gradients_match_jax(silu):
    """(c) D: the port recomputes the plain version in fp32 and
    differentiates it, as _make_gn_pallas's bwd does through XLA."""
    rng = np.random.default_rng(22)
    x = _np(rng, 2, 4, 4, 128, scale=2.0) + 0.5
    scale, bias = 1.0 + _np(rng, 128, scale=0.1), _np(rng, 128, scale=0.1)
    g = _np(rng, 2, 4, 4, 128)
    out, ref = _jax_vjp(
        lambda x_, s_, b_: jgn.group_norm_silu(x_, s_, b_, groups=32, eps=1e-6,
                                               apply_silu=silu, use_pallas=True),
        (x, scale, bias), g)
    tx, ts, tb = _t(x, True), _t(scale, True), _t(bias, True)
    y = group_norm_silu(tx, ts, tb, 32, 1e-6, silu)
    np.testing.assert_allclose(y.detach().numpy(), out, atol=1e-5)
    y.backward(_t(g))
    for a, r in zip((tx, ts, tb), ref):
        np.testing.assert_allclose(a.grad.numpy(), r, atol=1e-4)


def _f64(*shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen, dtype=torch.float64).requires_grad_(True)


@pytest.mark.parametrize('name', ['flash_attention', 'geglu_dense', 'fused_dense',
                                  'fused_dense_res', 'group_norm_silu'])
def test_function_gradcheck_float64(name):
    """(d) each Function's CPU backward against finite differences."""
    if name == 'flash_attention':
        fn, args = tfa.flash_attention, [_f64(1, 2, 12, 8, seed=i) for i in range(3)]
    elif name == 'geglu_dense':
        fn, args = geglu_dense, [_f64(2, 3, 8, seed=0), _f64(6, 8, seed=1), _f64(6, seed=2)]
    elif name.startswith('fused_dense'):
        res = [_f64(2, 3, 6, seed=3)] if name.endswith('res') else [None]
        fn = fused_dense
        args = [_f64(2, 3, 8, seed=0), _f64(6, 8, seed=1), _f64(6, seed=2)] + res
    else:
        def fn(x, s, b):
            return group_norm_silu(x, s, b, 4, 1e-5, True)
        args = [_f64(2, 3, 3, 8, seed=0), _f64(8, seed=1), _f64(8, seed=2)]
    assert torch.autograd.gradcheck(fn, args)
