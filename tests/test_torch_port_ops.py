"""The PyTorch port's kernel modules (hcpdiff_tpu_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor each port wrapper takes its plain PyTorch version (the
CUDA kernels run only on the card; tests/test_torch_port_cuda.py holds
them against these plain versions there). Everything is fp32, so the
tolerances bound the difference of two fp32 computations of the same
function: summation order, plus the Pallas GEGLU's rational erf
(|error| <= 1.5e-7).
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
from hcpdiff_tpu_torch.ops import attention as tattn
from hcpdiff_tpu_torch.ops.flash_attention import flash_attention
from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu
from hcpdiff_tpu_torch.ops.matmul import fused_dense, geglu_dense
from tests.torch_port_common import one_torch_thread  # noqa: F401


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize('path,D', [('tq', 40), ('stream', 512)])
def test_flash_attention_matches_pallas(path, D):
    """D=40 through the transposed kernel (UNet self-attention, #1) and
    D=512 through the K/V-streaming kernel (VAE mid attention, #3), both
    over two K/V blocks. Logits stay far below the no-max clamp."""
    rng = np.random.default_rng(0)
    B, H, S = 1, 2 if D == 40 else 1, 256
    q, k, v = (_np(rng, B, H, S, D) for _ in range(3))
    scale = D ** -0.5
    forward = jfa._flash_forward_tq if path == 'tq' else jfa._flash_forward_stream
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False,
                                scale, 128, 128, emit_lse=False))
    before = flash_attention.launches
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert flash_attention.launches == before      # CPU tensors take the plain version
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_attention_dispatch_rule(monkeypatch):
    """The JAX package's default rule (ops/attention.py:59-79): the kernel
    takes self-attention (causal or not) with Sq >= 1024, Sq % 128 == 0 and
    D <= 512; everything else is plain torch. (The port has no attention
    bias, which the rule also sends to plain torch.)"""
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, 'flash_attention',
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))

    def run(Sq, Sk, D, **kw):
        q = torch.zeros(1, 1, Sq, D)
        kv = torch.zeros(1, 1, Sk, D)
        tattn.attention(q, kv, kv, **kw)
        return bool(calls and calls.pop() == q.shape)

    assert run(1024, 1024, 40)                 # UNet 32x32 level
    assert run(1024, 1024, 512)                # VAE mid block at 32x32 latents
    assert not run(1024, 77, 40)               # cross-attention
    assert not run(256, 256, 160)              # 16x16 level
    assert not run(1152, 1152, 640)            # D > 512
    assert not run(1100, 1100, 40)             # Sq % 128 != 0
    assert run(1024, 1024, 40, causal=True)    # causal with Sk == Sq
    assert not run(77, 77, 64, causal=True)    # CLIP's causal attention


@pytest.mark.parametrize('M,K,inner', [(256, 64, 128), (128, 96, 160)])
def test_geglu_dense_matches_pallas(M, K, inner):
    rng = np.random.default_rng(2)
    x, w, b = _np(rng, M, K), _np(rng, K, 2 * inner, scale=K ** -0.5), _np(rng, 2 * inner)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jmm.geglu_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                         bm=128, bn=128))
    # the port takes nn.Linear's [out, in] layout; the value rows come first
    out = geglu_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('with_res', [False, True])
@pytest.mark.parametrize('bk', [0, 128])
def test_fused_dense_matches_pallas(bk, with_res):
    """bk=0: the K-resident kernel; bk=128 < K: the K-streamed kernel (#8)."""
    rng = np.random.default_rng(3)
    M, K, N = 256, 512, 128
    x, w, b = _np(rng, 2, M // 2, K), _np(rng, K, N, scale=K ** -0.5), _np(rng, N)
    res = _np(rng, 2, M // 2, N) if with_res else None
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jmm.fused_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                         bm=128, bn=128, bk=bk,
                                         res=None if res is None else jnp.asarray(res)))
    out = fused_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b),
                      res=None if res is None else torch.from_numpy(res))
    assert out.shape == (2, M // 2, N)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize('silu', [True, False])
def test_group_norm_silu_matches_pallas(silu):
    """C % 128 == 0: the one-block-per-sample Pallas kernel (#12)."""
    rng = np.random.default_rng(4)
    x = _np(rng, 2, 4, 4, 128, scale=2.0) + 0.5
    scale, bias = 1.0 + _np(rng, 128, scale=0.1), _np(rng, 128, scale=0.1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jgn.group_norm_silu(jnp.asarray(x), jnp.asarray(scale),
                                             jnp.asarray(bias), groups=32, eps=1e-6,
                                             apply_silu=silu, use_pallas=True))
    out = group_norm_silu(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
                          32, 1e-6, silu)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_group_norm_silu_matches_xla_path():
    """C=32 (no Pallas on the TPU either): the XLA formulation."""
    rng = np.random.default_rng(5)
    x = _np(rng, 2, 8, 8, 32)
    scale, bias = 1.0 + _np(rng, 32, scale=0.1), _np(rng, 32, scale=0.1)
    ref = np.asarray(jgn.group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                         groups=8, use_pallas=False))
    out = group_norm_silu(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
