"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided in
a fixture, never at import). The card's machine has no JAX, so run this
file without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Both sides are bf16 with fp32 accumulation and each rounds its output to
bf16 once, at a different place, so they may differ by about two bf16
ulps of the output: |kernel - plain| <= ATOL + RTOL * |plain|.
"""
import pytest
import torch

from hcpdiff_tpu_torch.ops.flash_attention import attention_plain, flash_attention
from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
from hcpdiff_tpu_torch.ops.matmul import (fused_dense, fused_dense_plain, geglu_dense,
                                          geglu_dense_plain)

ATOL, RTOL = 1e-2, 1.6e-2
pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.Generator(device='cuda').manual_seed(0)


def _rn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, device='cuda', generator=gen) * scale).to(torch.bfloat16)


def _close(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    assert bool((err <= ATOL + RTOL * ref.float().abs()).all()), float(err.max())


@pytest.mark.parametrize('shape', [(2, 8, 1024, 40), (2, 8, 256, 80), (1, 1, 1024, 512),
                                   (1, 2, 200, 160), (1, 2, 300, 40)])
def test_flash_attention(gen, shape):
    q, k, v = (_rn(gen, *shape) for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    _close(out, attention_plain(q, k, v))


def test_flash_attention_head_split_views(gen):
    x = _rn(gen, 2, 1024, 320)
    q = x.view(2, 1024, 8, 40).transpose(1, 2)
    _close(flash_attention(q, q, q), attention_plain(q, q, q))


@pytest.mark.parametrize('M,K,N', [(4096, 320, 1280), (1000, 640, 2560), (2048, 5120, 1280)])
def test_gemm_kernels(gen, M, K, N):
    x = _rn(gen, M, K)
    w, b = _rn(gen, 2 * N, K, scale=K ** -0.5), _rn(gen, 2 * N)
    _close(geglu_dense(x, w, b), geglu_dense_plain(x, w, b))
    w1, b1, res = _rn(gen, N, K, scale=K ** -0.5), _rn(gen, N), _rn(gen, M, N)
    _close(fused_dense(x, w1, b1), fused_dense_plain(x, w1, b1))
    _close(fused_dense(x, w1, b1, res), fused_dense_plain(x, w1, b1, res))


@pytest.mark.parametrize('B,S,C,G', [(2, 4096, 320, 32), (2, 256, 1280, 32),
                                     (1, 512 * 512, 128, 32), (3, 100, 64, 8)])
@pytest.mark.parametrize('silu', [True, False])
def test_group_norm(gen, B, S, C, G, silu):
    x = _rn(gen, B, S, C, scale=3.0) + 1.0
    scale = torch.rand(C, device='cuda', generator=gen) + 0.5
    bias = torch.randn(C, device='cuda', generator=gen)
    _close(group_norm_silu(x, scale, bias, G, 1e-5, silu),
           group_norm_silu_plain(x, scale, bias, G, 1e-5, silu))


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = _rn(gen, 2, 8, 64, 40)
    with pytest.raises(ValueError):
        flash_attention(x.float(), x.float(), x.float())        # fp32
    with pytest.raises(ValueError):
        flash_attention(x[..., :32], x[..., :32], x[..., :32])  # head dim 32
    with pytest.raises(ValueError):
        fused_dense(_rn(gen, 4, 30), _rn(gen, 8, 30))            # K % 8 != 0
    with pytest.raises(ValueError):
        group_norm_silu(_rn(gen, 2, 16, 30), torch.ones(30, device='cuda'),
                        torch.zeros(30, device='cuda'), 3)       # C % 8 != 0
