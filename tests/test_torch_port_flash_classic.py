"""The port's attention (kernels A, E and F's plain versions and their
``autograd.Function``) against the JAX package's classic-layout Pallas
kernels, on the CPU, in fp32: ``_flash_kernel`` (#2, through
``_flash_forward``), ``_flash_kernel_lse`` (#4, ``_flash_forward_lse``) and
``_flash_bwd_dq_kernel`` / ``_flash_bwd_dkv_kernel`` (#6,
``_flash_backward``), causal and not, in interpret mode.

B=1, H=2, S=256 with 128-row blocks, so each kernel runs two blocks each
way and the causal loop bound skips a block. Each test asserts the routing
predicate under which the JAX package reaches the kernel it calls.
Tolerances bound two fp32 computations of the same function (summation
order, the Pallas kernels' exp2): 1e-4 on o and the gradients, 1e-5 on
lse (values ~6).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from hcpdiff_tpu.ops import attention as jattn
from hcpdiff_tpu.ops import flash_attention as jfa
from hcpdiff_tpu_torch.ops import attention as tattn
from hcpdiff_tpu_torch.ops import flash_attention as tfa
from tests.torch_port_common import one_torch_thread  # noqa: F401

B, H, S, BLOCK = 1, 2, 256, 128


def _np(rng, D, scale=1.0):
    return (scale * rng.standard_normal((B, H, S, D))).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _classic_route(D, nomax):
    """The JAX forward and backward take the classic kernels for this D."""
    assert not jfa._use_tq(D, nomax == '1')
    assert jfa._resident_fwd_bytes(BLOCK, BLOCK, S, D, 4) <= jfa._SCOPED_VMEM_BUDGET


def _jax_forward_lse(q, k, v, causal, scale):
    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_forward_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                        scale, BLOCK, BLOCK)
    return np.asarray(o), np.asarray(lse)[..., 0]


@pytest.mark.parametrize('causal', [False, True])
def test_forward_matches_flash_kernel(monkeypatch, causal):
    """(a) #2 at D=128 under the default env (no-max softmax, the head dim
    the transposed kernel does not take)."""
    monkeypatch.delenv('HCP_FLASH_NOMAX', raising=False)
    monkeypatch.delenv('HCP_FLASH_TQ', raising=False)
    D = 128
    _classic_route(D, '1')
    rng = np.random.default_rng(30 + causal)
    q, k, v = _np(rng, D), _np(rng, D), _np(rng, D)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal, scale, BLOCK, BLOCK))
    out = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(tfa.attention_plain(_t(q), _t(k), _t(v), scale, causal).numpy(),
                               ref, atol=1e-4)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('D', [40, 64])
def test_forward_lse_matches_flash_kernel_lse(monkeypatch, D, causal):
    """(b) #4 under HCP_FLASH_NOMAX=0 (the exact-softmax route, which takes
    every head dim to the classic kernels): o and lse."""
    monkeypatch.setenv('HCP_FLASH_NOMAX', '0')
    _classic_route(D, '0')
    rng = np.random.default_rng(40 + D + causal)
    q, k, v = _np(rng, D), _np(rng, D), _np(rng, D)
    scale = D ** -0.5
    ref_o, ref_lse = _jax_forward_lse(q, k, v, causal, scale)
    before = tfa.flash_attention_lse.launches
    o, lse = tfa.flash_attention_lse(_t(q), _t(k), _t(v), scale, causal)
    assert tfa.flash_attention_lse.launches == before      # CPU: the plain versions
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5)
    np.testing.assert_allclose(o.numpy(), ref_o, atol=1e-4)


def _jax_backward(q, k, v, g, causal, scale):
    o, lse = _jax_forward_lse(q, k, v, causal, scale)
    with pltpu.force_tpu_interpret_mode():
        ref = jfa._flash_backward(*(jnp.asarray(a) for a in (q, k, v, o)),
                                  jnp.asarray(lse)[..., None], jnp.asarray(g), causal, scale,
                                  BLOCK, BLOCK)
    return o, lse, [np.asarray(r) for r in ref]


def _port_grads(q, k, v, g, causal):
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(_t(g))
    return out.detach().numpy(), [tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()]


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('D,nomax', [(64, '0'), (128, '1')])
def test_backward_matches_flash_bwd_kernels(monkeypatch, D, nomax, causal):
    """(c) #6: D=64 under HCP_FLASH_NOMAX=0, D=128 under the defaults (the
    no-max clamp does not engage at these logits). The Function's
    gradients and the plain backward, from the JAX forward's o and lse."""
    monkeypatch.setenv('HCP_FLASH_NOMAX', nomax)
    _classic_route(D, nomax)
    rng = np.random.default_rng(50 + D + causal)
    q, k, v, g = (_np(rng, D) for _ in range(4))
    scale = D ** -0.5
    o, lse, ref = _jax_backward(q, k, v, g, causal, scale)
    plain = tfa.flash_attention_backward_plain(_t(q), _t(k), _t(v), _t(o), _t(lse), _t(g),
                                               scale, causal)
    _, grads = _port_grads(q, k, v, g, causal)
    for r, p, a in zip(ref, plain, grads):
        np.testing.assert_allclose(p.numpy(), r, atol=1e-4)
        np.testing.assert_allclose(a, r, atol=1e-4)


@pytest.mark.parametrize('causal', [False, True])
def test_beyond_the_no_max_clamp(monkeypatch, causal):
    """(d) q x 30 at D=40: scaled logits reach ~100 nats, past the no-max
    clamp (NOMAX_CLAMP_NAT, 55), where only the exact softmax is right.
    Under HCP_FLASH_NOMAX=0 the classic kernels are exact, and so is the
    port. Logits of ~100 carry fp32 rounding of ~1e-5 nats (the kernels
    also fold log2 e into q), which P, o and the gradients carry as a
    relative error: each is held to 1e-4 * max|ref|."""
    monkeypatch.setenv('HCP_FLASH_NOMAX', '0')
    D = 40
    _classic_route(D, '0')
    rng = np.random.default_rng(60 + causal)
    q, k, v, g = _np(rng, D, 30.0), _np(rng, D), _np(rng, D), _np(rng, D)
    scale = D ** -0.5
    logits = np.einsum('bhqd,bhkd->bhqk', q, k) * scale
    assert logits.max() > 1.5 * jfa.NOMAX_CLAMP_NAT
    o, lse, ref = _jax_backward(q, k, v, g, causal, scale)
    out, grads = _port_grads(q, k, v, g, causal)
    _, port_lse = tfa.flash_attention_lse(_t(q), _t(k), _t(v), scale, causal)
    for got, want in zip([out, port_lse.numpy(), *grads], [o, lse, *ref]):
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_dispatch_matches_the_jax_rule(monkeypatch):
    """(e) ops/attention.py sends a call to the kernel exactly when the JAX
    dispatcher (on a TPU backend, default env) sends it to flash
    attention: self-attention, causal or not, at Sq >= 1024, Sq % 128 == 0
    and D <= 512. Both sides run on stubs (no attention is computed)."""
    for var in ('HCP_FLASH_ATTN', 'HCP_FLASH_XATTN', 'HCP_FLASH_VAE'):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jfa, 'flash_attention',
                        lambda q, k, v, causal=False, scale=None: jax_calls.append(causal) or v)
    monkeypatch.setattr(tattn, 'flash_attention',
                        lambda q, k, v, scale=None, causal=False: port_calls.append(causal) or v)
    monkeypatch.setattr(tattn, 'attention_plain', lambda q, k, v, scale=None, causal=False: v)
    monkeypatch.setattr(jattn, '_xla_attention', lambda q, k, v, *a: v)
    cases = [(Sq, Sk, D, causal) for Sq, Sk in ((77, 77), (256, 256), (1024, 1024), (1024, 77),
                                                (1100, 1100), (1152, 1152), (4096, 4096),
                                                (4096, 1024))
             for D in (40, 64, 128, 512, 640) for causal in (False, True)]
    routed = 0
    for Sq, Sk, D, causal in cases:
        jax.eval_shape(lambda q, k, v: jattn.attention(q, k, v, causal=causal),
                       *(jax.ShapeDtypeStruct((1, 1, s, D), jnp.float32) for s in (Sq, Sk, Sk)))
        tattn.attention(torch.empty(1, 1, Sq, D), torch.empty(1, 1, Sk, D),
                        torch.empty(1, 1, Sk, D), causal=causal)
        assert port_calls == jax_calls, (Sq, Sk, D, causal)
        routed += len(port_calls)
        if port_calls:
            assert port_calls == [causal]
        jax_calls.clear()
        port_calls.clear()
    assert routed == 2 * 3 * 4          # 3 self-attention lengths x 4 head dims x causal
