"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided in
a fixture, never at import). The card's machine has no JAX, so run this
file without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Both sides are bf16 with fp32 accumulation and each rounds its output to
bf16 once, at a different place, so they may differ by about two bf16
ulps of the output: |kernel - plain| <= ATOL + RTOL * |plain|.

Gradients: kernels E and F round P and dS to bf16 before their second
tensor-core product (relative 2^-9 each) and sum up to Sk or Sq such
terms, which the fp32 plain backward does not; an element near zero can
then miss the bound above by more than its own size, so they are held to
|kernel - plain| <= GRAD_ATOL_REL * max|plain| + RTOL * |plain|. The lse
is fp32 on both sides: LSE_ATOL.
"""
import pytest
import torch

from hcpdiff_tpu_torch.ops import flash_attention as fa
from hcpdiff_tpu_torch.ops import matmul as mm
from hcpdiff_tpu_torch.ops.conv import conv3x3, conv3x3_plain
from hcpdiff_tpu_torch.ops.flash_attention import attention_plain, flash_attention
from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
from hcpdiff_tpu_torch.ops.matmul import (fused_dense, fused_dense_plain, geglu_dense,
                                          geglu_dense_plain)

ATOL, RTOL = 1e-2, 1.6e-2
GRAD_ATOL_REL, LSE_ATOL = 1e-2, 1e-3
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


def _close_grad(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    torch.cuda.synchronize()
    ref = ref.float()
    err = (out.float() - ref).abs()
    bound = GRAD_ATOL_REL * ref.abs().max() + RTOL * ref.abs()
    assert bool((err <= bound).all()), float(err.max())


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


@pytest.mark.parametrize('shape', [(2, 8, 1024, 40), (2, 8, 256, 80), (1, 2, 300, 40),
                                   (1, 1, 1024, 512)])
def test_flash_attention_lse(gen, shape):
    q, k, v = (_rn(gen, *shape) for _ in range(3))
    scale = shape[-1] ** -0.5
    before = fa.flash_attention_lse.launches
    o, lse = fa.flash_attention_lse(q, k, v, scale)
    assert fa.flash_attention_lse.launches == before + 1
    _close(o, attention_plain(q, k, v, scale))
    ref = fa.attention_lse_plain(q, k, scale)
    torch.cuda.synchronize()
    assert lse.shape == ref.shape and lse.dtype == torch.float32
    assert float((lse - ref).abs().max()) <= LSE_ATOL


@pytest.mark.parametrize('shape', [(2, 8, 1024, 40), (2, 8, 1024, 80), (1, 2, 300, 40),
                                   (1, 2, 200, 80)])
def test_flash_backward_kernels(gen, shape):
    """E and F against the plain backward, with dO a head-split view as
    autograd hands it over (strides taken, no copy)."""
    B, H, S, D = shape
    q, k, v = (_rn(gen, *shape) for _ in range(3))
    do = _rn(gen, B, S, H * D).view(B, S, H, D).transpose(1, 2)
    scale = D ** -0.5
    o, lse = fa.flash_attention_lse(q, k, v, scale)
    delta = fa.attention_delta(o, do)
    before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, lse, do, delta, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, scale)
    assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    for out, ref in zip((dq, dk, dv), fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                                         scale)):
        _close_grad(out, ref)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('shape', [(2, 10, 1024, 64), (1, 2, 512, 128), (2, 4, 512, 160),
                                   (1, 2, 300, 120), (1, 2, 300, 40)])
def test_flash_classic_head_dims_and_causal(gen, shape, causal):
    """A, A with lse, E and F at the head dims the classic route adds (64,
    128, 160; 120 pads to 128) and a ragged S, causal and not, against
    their plain versions; then the Function's gradients (ctx keeps causal)
    against the plain version's, differentiated in fp32."""
    B, H, S, D = shape
    q, k, v = (_rn(gen, *shape) for _ in range(3))
    do = _rn(gen, B, S, H * D).view(B, S, H, D).transpose(1, 2)
    scale = D ** -0.5
    counters = (flash_attention, fa.flash_attention_lse, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    _close(flash_attention(q, k, v, scale, causal), attention_plain(q, k, v, scale, causal))
    o, lse = fa.flash_attention_lse(q, k, v, scale, causal)
    _close(o, attention_plain(q, k, v, scale, causal))
    ref = fa.attention_lse_plain(q, k, scale, causal)
    torch.cuda.synchronize()
    assert float((lse - ref).abs().max()) <= LSE_ATOL
    delta = fa.attention_delta(o, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, lse, do, delta, scale, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, scale, causal)
    assert [c.launches for c in counters] == [before[0] + 2, before[1] + 1, before[2] + 1,
                                              before[3] + 1]
    for out, ref in zip((dq, dk, dv), fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                                         scale, causal)):
        _close_grad(out, ref)
    _, got = _grads(lambda *a: flash_attention(*a, causal=causal), [q, k, v], do)
    _, ref = _grads(lambda *a: attention_plain(*a, causal=causal), [q.float(), k.float(),
                                                                     v.float()], do.float())
    for a, r in zip(got, ref):
        _close_grad(a, r.to(a.dtype))


def test_flash_causal_needs_as_many_keys_as_queries(gen):
    """The kernels' causal mask is top-left aligned, so causal with Sq != Sk
    raises; without causal, Sq != Sk runs."""
    q, kv = _rn(gen, 1, 2, 256, 64), _rn(gen, 1, 2, 128, 64)
    lse = torch.zeros(1, 2, 256, device='cuda')
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv, causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention_lse(q, kv, kv, 0.125, causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dq(q, kv, kv, lse, q, lse, 0.125, causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dkv(q, kv, kv, lse, q, lse, 0.125, causal=True)
    _close(flash_attention(q, kv, kv), attention_plain(q, kv, kv))


def _grads(fn, args, g):
    """Output and input gradients of fn(*args) with cotangent g."""
    leaves = [a.detach().requires_grad_(True) if a is not None else None for a in args]
    out = fn(*leaves)
    out.backward(g)
    return out, [a.grad for a in leaves if a is not None]


def test_kernel_outputs_carry_grad_fn(gen):
    """The autograd fault: every kernel's output on a grad-requiring CUDA
    input has a grad_fn, and its gradients match the plain version's
    (differentiated by autograd in fp32 on the same bf16 inputs)."""
    qkv = [_rn(gen, 2, 8, 1024, 40) for _ in range(3)]
    x, w, b = _rn(gen, 512, 320), _rn(gen, 2560, 320, scale=320 ** -0.5), _rn(gen, 2560)
    w1, b1, res = _rn(gen, 1280, 320, scale=320 ** -0.5), _rn(gen, 1280), _rn(gen, 512, 1280)
    xg = _rn(gen, 2, 256, 320, scale=3.0) + 1.0
    sc = (torch.rand(320, device='cuda', generator=gen) + 0.5).to(torch.bfloat16)
    bi = torch.randn(320, device='cuda', generator=gen).to(torch.bfloat16)
    cases = [
        (flash_attention, lambda q, k, v: attention_plain(q, k, v), qkv),
        (geglu_dense, geglu_dense_plain, [x, w, b]),
        (fused_dense, fused_dense_plain, [x, w1, b1, res]),
        (lambda *a: group_norm_silu(*a, 32, 1e-5, True),
         lambda *a: group_norm_silu_plain(*a, 32, 1e-5, True), [xg, sc, bi]),
    ]
    for kernel, plain, args in cases:
        out = kernel(*[a.detach().requires_grad_(True) for a in args])
        assert out.grad_fn is not None
        g = _rn(gen, *out.shape)
        _, got = _grads(kernel, args, g)
        _, ref = _grads(plain, [a.float() for a in args], g.float())
        for a, r in zip(got, ref):
            _close_grad(a, r.to(a.dtype))


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


def _ln_inputs(gen, M, K):
    """LayerNorm input, scale and shift (bf16)."""
    return _rn(gen, M, K, scale=2.0) + 0.5, 1.0 + _rn(gen, K, scale=0.1), _rn(gen, K, scale=0.1)


@pytest.mark.parametrize('M,K', [(4096, 320), (1000, 640), (512, 1280), (300, 32)])
def test_ln_gemm_kernels(gen, M, K):
    """G, H and I against their plain versions (eps 1e-6, as the UNet
    passes it), on a ragged M and at the UNet's widths."""
    x, g, b = _ln_inputs(gen, M, K)
    ws = [_rn(gen, K, K, scale=K ** -0.5) for _ in range(3)]
    w2, b2 = _rn(gen, 8 * K, K, scale=K ** -0.5), _rn(gen, 8 * K)
    before = (mm.ln_qkv.launches, mm.ln_dense.launches, mm.ln_geglu.launches)
    for out, ref in zip(mm.ln_qkv(x, g, b, *ws, 1e-6), mm.ln_qkv_plain(x, g, b, *ws, 1e-6)):
        _close(out, ref)
    _close(mm.ln_dense(x, g, b, ws[0], 1e-6), mm.ln_dense_plain(x, g, b, ws[0], 1e-6))
    _close(mm.ln_geglu(x, g, b, w2, b2, 1e-6), mm.ln_geglu_plain(x, g, b, w2, b2, 1e-6))
    assert (mm.ln_qkv.launches, mm.ln_dense.launches, mm.ln_geglu.launches) == tuple(
        n + 1 for n in before)


@pytest.mark.parametrize('B,Cin,H,W,Cout', [(2, 320, 64, 64, 320), (2, 640, 16, 16, 1280),
                                            (8, 2560, 8, 8, 1280), (1, 96, 5, 7, 64)])
def test_conv3x3_kernel(gen, B, Cin, H, W, Cout):
    """J against its plain version with each epilogue; a weight that is not
    channels_last (a merged LoRA weight) is copied into it, not refused."""
    cl = torch.channels_last
    x = _rn(gen, B, Cin, H, W).to(memory_format=cl)
    w = _rn(gen, Cout, Cin, 3, 3, scale=(9 * Cin) ** -0.5).to(memory_format=cl)
    b, rb = _rn(gen, Cout), _rn(gen, B, Cout)
    res = _rn(gen, B, Cout, H, W).to(memory_format=cl)
    before = conv3x3.launches
    out = conv3x3(x, w, b)
    assert conv3x3.launches == before + 1 and out.is_contiguous(memory_format=cl)
    _close(out, conv3x3_plain(x, w, b))
    _close(conv3x3(x, w, b, rb, res), conv3x3_plain(x, w, b, rb, res))
    _close(conv3x3(x, w.contiguous(), None, rb), conv3x3_plain(x, w, None, rb))


def test_fused_kernel_outputs_carry_grad_fn(gen):
    """G-J: each output on grad-requiring CUDA inputs has a grad_fn, and
    the gradients of every input match the plain version's (differentiated
    by autograd in fp32 on the same bf16 inputs)."""
    x, g, b = _ln_inputs(gen, 2 * 256, 320)
    x = x.view(2, 256, 320)
    ws = [_rn(gen, 320, 320, scale=320 ** -0.5) for _ in range(3)]
    w2, b2 = _rn(gen, 2560, 320, scale=320 ** -0.5), _rn(gen, 2560)
    cl = torch.channels_last
    xc = _rn(gen, 2, 320, 16, 16).to(memory_format=cl)
    wc = _rn(gen, 640, 320, 3, 3, scale=2880 ** -0.5).to(memory_format=cl)
    conv_args = [xc, wc, _rn(gen, 640), _rn(gen, 2, 640),
                 _rn(gen, 2, 640, 16, 16).to(memory_format=cl)]
    outs = mm.ln_qkv(*[a.detach().requires_grad_(True) for a in (x, g, b, *ws)], 1e-6)
    assert all(o.grad_fn is not None for o in outs)
    cases = [
        (lambda *a: torch.cat(mm.ln_qkv(*a, 1e-6), dim=-1),
         lambda *a: torch.cat(mm.ln_qkv_plain(*a, 1e-6), dim=-1), [x, g, b, *ws]),
        (lambda *a: mm.ln_dense(*a, 1e-6), lambda *a: mm.ln_dense_plain(*a, 1e-6),
         [x, g, b, ws[0]]),
        (lambda *a: mm.ln_geglu(*a, 1e-6), lambda *a: mm.ln_geglu_plain(*a, 1e-6),
         [x, g, b, w2, b2]),
        (conv3x3, conv3x3_plain, conv_args),
    ]
    for kernel, plain, args in cases:
        out = kernel(*[a.detach().requires_grad_(True) for a in args])
        assert out.grad_fn is not None
        gout = _rn(gen, *out.shape)
        _, got = _grads(kernel, args, gout)
        _, ref = _grads(plain, [a.float() for a in args], gout.float())
        for a, r in zip(got, ref):
            _close_grad(a, r.to(a.dtype))


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
    x, g, b = _ln_inputs(gen, 4, 36)
    with pytest.raises(ValueError):                               # K % 8 != 0
        mm.ln_dense(x, g, b, _rn(gen, 8, 36))
    with pytest.raises(ValueError):                               # fp32 LayerNorm scale
        mm.ln_dense(x[:, :32].contiguous(), g[:32].float(), b[:32], _rn(gen, 8, 32))
    with pytest.raises(ValueError):                               # Cin % 8 != 0
        conv3x3(_rn(gen, 1, 12, 4, 4), _rn(gen, 8, 12, 3, 3))
    q = _rn(gen, 1, 2, 256, 512)
    lse = torch.zeros(1, 2, 256, device='cuda')
    with pytest.raises(ValueError):                               # no backward at D=512
        fa.flash_attention_bwd_dq(q, q, q, lse, q, lse, 1.0)
    with pytest.raises(ValueError):                               # head dim 96
        flash_attention(q[..., :96], q[..., :96], q[..., :96])
    with pytest.raises(ValueError):                               # causal at D=512
        flash_attention(q, q, q, causal=True)
