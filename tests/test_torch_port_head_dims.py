"""Head dims outside the kernels' built set, on the CPU.

On a CUDA tensor the attention wrappers zero-pad q, k, v (and dO) along D
up to the next built head dim (``flash_attention.kernel_head_dim``,
``pad_head_dim``), run the kernel with the original D's scale and slice o,
dq, dk and dv back to D. Here the same helpers pad the inputs of the plain
versions: padded-then-sliced results equal the unpadded ones within 1e-6
(fp32; zero columns add exact zeros to q k^T, so only summation order can
differ). Then the tiny UNet at a 32x32 latent (level-0 self-attention at
S = 1024 with D = 32 / 2 = 16) routes that attention to
``flash_attention`` and matches the JAX package's tiny UNet at the repo's
fp32 UNet parity bound (atol 5e-4, tests/test_torch_port_models.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu_torch.ckpt.bridge import load_params
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.ops import attention as tattn
from hcpdiff_tpu_torch.ops import flash_attention as fa
from tests.torch_port_common import random_params, one_torch_thread  # noqa: F401

PAD_ATOL = 1e-6


def test_kernel_head_dim_choices():
    """Built dims run as they are (the kernel pads D to a multiple of 16 in
    its tiles); any other D pads to the next built dim; every entry (causal,
    lse and the backward too) stops at 512."""
    want = {16: 48, 20: 48, 40: 40, 44: 48, 80: 80, 96: 128, 120: 120, 144: 160, 160: 160,
            192: 512, 256: 512, 320: 512, 512: 512}
    assert {D: fa.kernel_head_dim('A', D) for D in want} == want
    for D in (576, 640):
        with pytest.raises(ValueError):
            fa.kernel_head_dim('A', D)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('D', [16, 20, 96, 144])
def test_padded_head_dim_is_exact(D, causal):
    rng = np.random.default_rng(D)
    B, H, S = 1, 2, 96
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(np.float32))
                   for _ in range(4))
    scale = D ** -0.5
    Dp = fa.kernel_head_dim('E', D)
    assert Dp > D
    qp, kp, vp, dop = (fa.pad_head_dim(t, Dp) for t in (q, k, v, do))
    assert qp.shape[-1] == Dp and bool((qp[..., D:] == 0).all())

    o = fa.attention_plain(q, k, v, scale, causal)
    lse = fa.attention_lse_plain(q, k, scale, causal)
    delta = fa.attention_delta(o, do)
    ref = (o, lse, fa.flash_bwd_dq_plain(q, k, v, lse, do, delta, scale, causal),
           *fa.flash_bwd_dkv_plain(q, k, v, lse, do, delta, scale, causal))
    dkp, dvp = fa.flash_bwd_dkv_plain(qp, kp, vp, lse, dop, delta, scale, causal)
    got = (fa.attention_plain(qp, kp, vp, scale, causal)[..., :D],
           fa.attention_lse_plain(qp, kp, scale, causal),
           fa.flash_bwd_dq_plain(qp, kp, vp, lse, dop, delta, scale, causal)[..., :D],
           dkp[..., :D], dvp[..., :D])
    for name, g, r in zip(('o', 'lse', 'dq', 'dk', 'dv'), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=PAD_ATOL, err_msg=name)


def test_tiny_unet_at_32x32_routes_self_attention_to_the_kernel(monkeypatch):
    cfg = junet.UNetConfig.tiny()
    jm = junet.UNet2DCondition(cfg, dtype=jnp.float32)
    params = random_params(jm, jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                           jnp.zeros((1, 77, cfg.cross_attention_dim)), seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim)).astype(np.float32)
    t = np.array([300, 20])
    ref = np.asarray(jax.jit(jm.apply)({'params': params}, x, t, ctx))

    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, 'flash_attention',
                        lambda q, *a, **kw: calls.append(tuple(q.shape)) or real(q, *a, **kw))
    tm = load_params(tunet.UNet2DCondition(tunet.UNetConfig.tiny()), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    # level 0's self-attention: 2 heads of D = 16 over the 32 * 32 pixels,
    # in the down block's one transformer and the up block's two
    heads = tunet.UNetConfig.tiny().num_heads[0]
    assert calls == [(2, heads, 1024, 32 // heads)] * 3
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4)
