"""The port's fused-sublayer path (kernels G, H, I, J and the UNet's
``fused_sublayers=True``) against the JAX package's Pallas kernels and its
``HCP_PALLAS_LN/PROJ/CONV`` UNet, in fp32 on the CPU.

The JAX side runs its Pallas kernels in interpret mode; the port's
wrappers take their plain versions on CPU tensors. Tolerances: the kernel
outputs at the JAX package's own tests' bounds for these kernels
(tests/test_matmul.py:142-197, tests/test_conv.py:12-40: atol 3e-4, 5e-4
for the GEGLU one, rtol 1e-4), which cover two fp32 computations of the
same function in different summation orders and the Pallas GEGLU's
rational erf; gradients at those tests' vjp bound (atol 1e-2, rtol 1e-3);
the whole tiny UNet at tests/test_conv.py:93's bound (atol 1e-3, rtol
1e-4). Also here: kernel D's function held against the streaming
GroupNorm pair (#13), which kernel D replaces.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu.ops import conv as jconv
from hcpdiff_tpu.ops import groupnorm as jgn
from hcpdiff_tpu.ops import matmul as jmm
from hcpdiff_tpu_torch.ckpt.bridge import load_params
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.ops.conv import conv3x3
from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu
from hcpdiff_tpu_torch.ops.matmul import ln_dense, ln_geglu, ln_qkv
from tests.torch_port_common import random_params, one_torch_thread  # noqa: F401

ATOL, ATOL_GEGLU, RTOL = 3e-4, 5e-4, 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-2, 1e-3
PALLAS_SWITCHES = ('HCP_PALLAS_CONV', 'HCP_PALLAS_LN', 'HCP_PALLAS_PROJ', 'HCP_PALLAS_FORCE')


def _np(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a.transpose(0, 3, 1, 2))


def _oihw(w):
    return _t(w.transpose(3, 2, 0, 1))


def _ln_case(name, rng):
    """JAX wrapper, port wrapper, JAX args and the port's args (weights as
    [out, in]) at tests/test_matmul.py's shapes."""
    if name == 'ln_qkv':
        x = _np(rng, 2, 128, 96)
        g, b = _np(rng, 96, scale=0.1, shift=1.0), _np(rng, 96, scale=0.1)
        ws = [_np(rng, 96, 96, scale=0.1) for _ in range(3)]
        return jmm.ln_qkv, ln_qkv, [x, g, b, *ws], [x, g, b, *[w.T for w in ws]]
    if name == 'ln_geglu':
        x = _np(rng, 3, 64, 64)
        g, b = _np(rng, 64, scale=0.1, shift=1.1), _np(rng, 64, scale=0.05)
        w, bb = _np(rng, 64, 2 * 128, scale=0.1), _np(rng, 2 * 128, scale=0.1)
        return jmm.ln_geglu, ln_geglu, [x, g, b, w, bb], [x, g, b, w.T, bb]
    x = _np(rng, 4, 64, 96)
    g, b = _np(rng, 96, scale=0.1, shift=0.9), _np(rng, 96, scale=0.02)
    w = _np(rng, 96, 128, scale=0.1)
    return jmm.ln_dense, ln_dense, [x, g, b, w], [x, g, b, w.T]


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize('name', ['ln_qkv', 'ln_geglu', 'ln_dense'])
def test_ln_gemm_matches_pallas(name):
    """G, H, I plain versions vs the Pallas kernels #9-#11 (eps 1e-5, the
    wrappers' default)."""
    jfn, tfn, jargs, targs = _ln_case(name, np.random.default_rng(40))
    with pltpu.force_tpu_interpret_mode():
        ref = _tuple(jfn(*map(jnp.asarray, jargs)))
    out = _tuple(tfn(*map(_t, targs)))
    atol = ATOL_GEGLU if name == 'ln_geglu' else ATOL
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=atol, rtol=RTOL)


@pytest.mark.parametrize('name', ['ln_qkv', 'ln_geglu', 'ln_dense'])
def test_ln_gemm_grads_match_jax_vjp(name):
    """The autograd.Function's gradients (every input) vs jax.vjp of the
    JAX wrapper (its custom_vjp: the vjp of the fp32 _ref)."""
    rng = np.random.default_rng(41)
    jfn, tfn, jargs, targs = _ln_case(name, rng)
    with pltpu.force_tpu_interpret_mode():
        outs, vjp = jax.vjp(jfn, *map(jnp.asarray, jargs))
        cot = tuple(_np(rng, *o.shape) for o in _tuple(outs))
        jgrads = vjp(cot if isinstance(outs, tuple) else cot[0])
    leaves = [_t(a).requires_grad_(True) for a in targs]
    tgrads = torch.autograd.grad(_tuple(tfn(*leaves)), leaves, [_t(c) for c in cot])
    for i, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        ref = np.asarray(jg)
        if ref.ndim == 2 and i >= 3:          # weights: the port's are [out, in]
            ref = ref.T
        np.testing.assert_allclose(tg.numpy(), ref, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize('B,H,W,Cin,Cout,epilogue', [
    (2, 8, 8, 32, 64, 'bias'), (1, 16, 16, 64, 32, 'bias'), (2, 8, 12, 16, 48, 'bias'),
    (2, 8, 8, 16, 32, 'row_bias+res')])
def test_conv3x3_matches_pallas(B, H, W, Cin, Cout, epilogue):
    """J's plain version vs the Pallas kernel #14 at tests/test_conv.py's
    shapes; NHWC/HWIO there, channels_last NCHW/OIHW here."""
    rng = np.random.default_rng(42)
    x, w, b = _np(rng, B, H, W, Cin), _np(rng, 3, 3, Cin, Cout, scale=0.1), _np(rng, Cout, scale=0.1)
    rb = _np(rng, B, Cout) if epilogue != 'bias' else None
    res = _np(rng, B, H, W, Cout) if epilogue != 'bias' else None
    with pltpu.force_tpu_interpret_mode():
        ref = jconv.conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            row_bias=None if rb is None else jnp.asarray(rb),
                            res=None if res is None else jnp.asarray(res))
    out = conv3x3(_nchw(x).to(memory_format=torch.channels_last), _oihw(w), _t(b),
                  None if rb is None else _t(rb), None if res is None else _nchw(res))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_conv3x3_grads_match_jax_vjp():
    rng = np.random.default_rng(43)
    B, H, W, Cin, Cout = 2, 8, 8, 16, 32
    args = [_np(rng, B, H, W, Cin), _np(rng, 3, 3, Cin, Cout, scale=0.1),
            _np(rng, Cout, scale=0.1), _np(rng, B, Cout), _np(rng, B, H, W, Cout)]
    g = _np(rng, B, H, W, Cout)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x, w, b, rb, r: jconv.conv3x3(x, w, b, row_bias=rb, res=r),
                         *map(jnp.asarray, args))
        jgrads = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    x, w, b, rb, res = args
    leaves = [_nchw(x), _oihw(w), _t(b), _t(rb), _nchw(res)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tgrads = torch.autograd.grad(conv3x3(*leaves), leaves, _nchw(g))
    refs = [jgrads[0].transpose(0, 3, 1, 2), jgrads[1].transpose(3, 2, 0, 1), jgrads[2],
            jgrads[3], jgrads[4].transpose(0, 3, 1, 2)]
    for tg, ref in zip(tgrads, refs):
        np.testing.assert_allclose(tg.numpy(), ref, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_fused_unet_matches_jax_all_pallas(monkeypatch):
    """The tiny UNet with fused_sublayers=True vs the JAX UNet with
    HCP_PALLAS_CONV/LN/PROJ(/FORCE)=1 under interpret mode, as
    tests/test_conv.py:93 runs it; one JAX tree loads strictly into both
    port configurations, and the unfused one agrees as well."""
    cfg = junet.UNetConfig.tiny()
    jm = junet.UNet2DCondition(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(44)
    x = _np(rng, 2, 8, 8, 4)
    ctx = _np(rng, 2, 77, cfg.cross_attention_dim)
    t = np.array([40, 700])
    params = random_params(jm, jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                           jnp.zeros((1, 77, cfg.cross_attention_dim)), seed=45)
    for k in PALLAS_SWITCHES:
        monkeypatch.setenv(k, '1')
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(jm.apply)({"params": params}, x, t, ctx))
    for fused in (True, False):
        tm = load_params(tunet.UNet2DCondition(tunet.UNetConfig.tiny(), fused_sublayers=fused),
                         params)
        with torch.no_grad():
            out = tm(_t(x), _t(t), _t(ctx))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize('silu', [True, False])
def test_group_norm_matches_streaming_pallas(silu):
    """#13: the streaming two-pass GroupNorm (HCP_GN_STREAMING on the TPU)
    computes what kernel D computes; D's plain version vs the Pallas pair
    at a shape the JAX routing would stream (S = 1024, a multiple of the
    512-row tile). atol as tests/test_torch_port_ops.py's GroupNorm."""
    rng = np.random.default_rng(46)
    B, S, C, G = 2, 1024, 64, 8
    x = _np(rng, B, S, C, scale=2.0, shift=0.5)
    scale, bias = _np(rng, C, scale=0.1, shift=1.0), _np(rng, C, scale=0.1)
    with pltpu.force_tpu_interpret_mode():
        ref = jgn._gn_silu_streaming_raw(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                         G, 1e-6, silu, S, C, 512)
    out = group_norm_silu(_t(x), _t(scale), _t(bias), G, 1e-6, silu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
