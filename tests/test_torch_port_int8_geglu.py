"""The port's int8 GEGLU layer (``ops/int8.py:int8_geglu_dense``, the
GEGLU L's plain version and CPU route) against the JAX UNet's int8 ff.proj
(``int8_dense`` over [Wv; Wg], split, exact ``jax.nn.gelu``), and the
weights' code cache (``weight_codes``), on the CPU.

The JAX functions run op by op (``jax.disable_jit``), as
test_torch_port_int8.py runs them: under ``jit`` XLA rewrites the scale's
division by 127 as a product with 1/127.

Tolerances: the product's two halves are the ``int8_dense`` outputs, equal
to JAX's within one ulp (test_torch_port_int8.py); the gate is
``T(h * T(gelu(gate)))``, where the two packages' erf differ by an ulp of
erf and JAX rounds each op of a bf16 gelu to bf16 while PyTorch rounds
once. Near gate -> -inf, ``1 + erf`` cancels, so an erf ulp becomes ``eps
|h gate| / 2`` of the output. So the output is held to ``2 ulp_T(ref) +
eps_T |h gate|`` (eps_T = 2^-23 in fp32, 2^-7 in bf16), which 20 seeds meet
with a margin of 1.6. The plain version and the CPU route are bitwise
equal. Gradients (fp32): rtol 1e-5, the straight-through products summed
in two orders and PyTorch's gelu backward against JAX's autodiff of the
erf formula.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.ops import int8 as jint8
from hcpdiff_tpu_torch.ops import int8 as tint8
from tests.torch_port_common import one_torch_thread  # noqa: F401

DTYPES = {'fp32': (jnp.float32, torch.float32, 23), 'bf16': (jnp.bfloat16, torch.bfloat16, 7)}
GRAD_RTOL = 1e-5


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_geglu(x, k, b):
    h = jint8.int8_dense(x, k, b)
    h, gate = jnp.split(h, 2, axis=-1)
    return h * jax.nn.gelu(gate, approximate=False), h, gate


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('bias', [True, False])
def test_int8_geglu_dense_matches_jax(dtype, bias):
    """x [3, 5, 40] (a row of zeros among them), the JAX kernel [40, 48] =
    the port's [Wv; Wg] [48, 40], fp32 bias: the port's route and plain
    version against the JAX UNet's int8 GEGLU."""
    jdt, tdt, bits = DTYPES[dtype]
    rng = np.random.default_rng(11 + bias)
    x = _np(rng, 3, 5, 40)
    x[2, 1] = 0.0
    k = _np(rng, 40, 48, scale=40 ** -0.5)
    b = _np(rng, 48, scale=0.5) if bias else None
    with jax.disable_jit():
        ref, h, gate = _jax_geglu(jnp.asarray(x).astype(jdt), jnp.asarray(k),
                                  None if b is None else jnp.asarray(b))
    ref, h, gate = (np.asarray(a.astype(jnp.float32), np.float64) for a in (ref, h, gate))
    args = (_t(x).to(tdt), _t(k.T), None if b is None else _t(b))
    out = tint8.int8_geglu_dense(*args)
    plain = tint8.int8_geglu_dense_plain(*args)
    assert out.dtype == tdt and out.shape == (3, 5, 24)
    assert torch.equal(out, plain)
    _, e = np.frexp(np.maximum(np.abs(ref), 2.0 ** -126))
    tol = 2.0 ** (e - bits) + 2.0 ** -bits * np.abs(h * gate)
    got = out.double().numpy()
    assert (np.abs(got - ref) <= tol).all(), float(np.max(np.abs(got - ref) / tol))
    # the zero row: h and gate are the bias halves alone (within two ulps: the
    # CPU's vectorized erf on a row and on the whole tensor may differ)
    b2 = torch.zeros(48, dtype=tdt) if b is None else _t(b).to(tdt)
    expect = b2[:24] * torch.nn.functional.gelu(b2[24:])
    torch.testing.assert_close(out[2, 1], expect, rtol=2.0 ** (1 - bits), atol=0.0)


def test_int8_geglu_dense_grads_match_jax_vjp():
    """Gradients of x, the weight and the bias (fp32) against ``jax.vjp``
    of the JAX int8 GEGLU for a seeded cotangent: straight through the
    quantization, through ``h * gelu(gate)`` by autodiff."""
    rng = np.random.default_rng(5)
    x, k, b, cot = _np(rng, 2, 6, 40), _np(rng, 40, 48, scale=0.2), _np(rng, 48), _np(rng, 2, 6, 24)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda x, k, b: _jax_geglu(x, k, b)[0], *map(jnp.asarray, (x, k, b)))
        refs = vjp(jnp.asarray(cot))
    ins = [_t(a).requires_grad_(True) for a in (x, k.T, b)]
    tint8.int8_geglu_dense(*ins).backward(_t(cot))
    for got, ref, name in zip([i.grad for i in ins], refs, ('x', 'w', 'b')):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref.T if name == 'w' else ref, rtol=GRAD_RTOL,
                                   atol=1e-6, err_msg=name)


# ------------------------------------------------------------ the code cache

def _layer(seed=0, n=48, k=40):
    torch.manual_seed(seed)
    return torch.nn.Linear(k, n)


def _x(seed=1):
    return torch.from_numpy(_np(np.random.default_rng(seed), 2, 7, 40))


def _count(fn):
    before = tint8.weight_codes.quantizations
    out = fn()
    return out, tint8.weight_codes.quantizations - before


def test_weight_codes_quantize_once_per_version():
    """Repeated calls on an unchanged weight quantize it once, through
    either layer, and give the plain version's output."""
    lin, x = _layer(), _x()
    with torch.no_grad():
        outs, n = _count(lambda: [tint8.int8_dense(x, lin.weight, lin.bias) for _ in range(3)])
        assert n == 1
        for out in outs:
            assert torch.equal(out, tint8.int8_dense_plain(x, lin.weight, lin.bias))
        out, n = _count(lambda: tint8.int8_geglu_dense(x, lin.weight, lin.bias))
        assert n == 0 and torch.equal(out, tint8.int8_geglu_dense_plain(x, lin.weight, lin.bias))
        # the same weight under another tensor object (a detached view) is another entry
        _, n = _count(lambda: tint8.int8_dense(x, lin.weight.detach(), lin.bias))
        assert n == 1


def _write_copy(lin, new):
    with torch.no_grad():
        lin.weight.copy_(new)
    return lin


def _write_data(lin, new):
    lin.weight.data = new.clone()
    return lin


def _write_assign(lin, new):
    lin.load_state_dict({'weight': new.clone(), 'bias': lin.bias.detach().clone()}, assign=True)
    return lin


def _write_gather(lin, new):
    """ZeRO-3's release and gather (trainer/assemble.py): the parameter's
    data is emptied, then set to a freshly gathered copy."""
    t = lin.weight
    t.data = torch.empty(0, dtype=t.dtype)
    t.data = new.reshape(-1).view(t.shape if t.numel() else new.shape).clone()
    return lin


def _write_optimizer(lin, new):
    opt = torch.optim.SGD(lin.parameters(), lr=0.5)
    opt.zero_grad()
    tint8.int8_dense(_x(3), lin.weight, lin.bias).square().sum().backward()
    opt.step()
    return lin


@pytest.mark.parametrize('write', [_write_copy, _write_data, _write_assign, _write_gather,
                                   _write_optimizer],
                         ids=['copy_', 'data', 'load_state_dict_assign', 'zero_gather',
                              'optimizer_step'])
def test_weight_codes_miss_after_a_write(write):
    """Each way the port changes a weight's values makes the next call
    quantize it anew, and the output is the plain version's on the new
    values."""
    lin, x = _layer(), _x()
    new = torch.from_numpy(_np(np.random.default_rng(9), 48, 40, scale=0.3))
    with torch.no_grad():
        tint8.int8_dense(x, lin.weight, lin.bias)
        _, n = _count(lambda: tint8.int8_dense(x, lin.weight, lin.bias))
        assert n == 0
    lin = write(lin, new)
    with torch.no_grad():
        out, n = _count(lambda: tint8.int8_dense(x, lin.weight, lin.bias))
        assert n == 1
        assert torch.equal(out, tint8.int8_dense_plain(x, lin.weight, lin.bias))
        _, n = _count(lambda: tint8.int8_dense(x, lin.weight, lin.bias))
        assert n == 0


def test_weight_codes_a_reused_address_misses():
    """``.data =`` keeps the parameter's version counter: once the storage
    the codes were made from is freed, an allocation at the same address
    with other values must not match. Fresh tensors of the weight's size
    are allocated until one lands on the freed address (the CPU allocator
    reuses freed blocks); with or without that, the call quantizes anew."""
    lin, x = _layer(), _x()
    a = torch.from_numpy(_np(np.random.default_rng(2), 48, 40))
    lin.weight.data = a
    with torch.no_grad():
        tint8.int8_dense(x, lin.weight, lin.bias)
    at = a.data_ptr()
    lin.weight.data = torch.zeros(48, 40)
    del a
    gc.collect()
    keep = []
    for i in range(64):
        c = torch.full((48, 40), float(i + 1)) / 7.0
        if c.data_ptr() == at:
            break
        keep.append(c)
    lin.weight.data = c
    with torch.no_grad():
        out, n = _count(lambda: tint8.int8_dense(x, lin.weight, lin.bias))
    assert n == 1 and torch.equal(out, tint8.int8_dense_plain(x, c, lin.bias))


def test_weight_codes_inference_tensors_and_lifetime():
    """An inference tensor has no version counter: quantized at every
    call. An entry goes with its weight."""
    x = _x()
    with torch.inference_mode():
        w = torch.randn(48, 40)
        _, n = _count(lambda: [tint8.int8_dense(x, w) for _ in range(2)])
    assert n == 2
    lin = _layer()
    with torch.no_grad():
        tint8.int8_dense(x, lin.weight)
    at = id(lin.weight)
    assert at in tint8._CODES
    del lin
    gc.collect()
    assert at not in tint8._CODES
