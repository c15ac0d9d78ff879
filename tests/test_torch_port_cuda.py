"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided in
a fixture, never at import). The card's machine has no JAX, so run this
file without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Both sides are bf16 with fp32 accumulation and each rounds its output to
bf16 once, at a different place, so they may differ by about two bf16
ulps of the output: |kernel - plain| <= ATOL + RTOL * |plain|.

fp32 calls: the tensor-core kernels compute the fp32 function with their
matrix operands rounded to bf16 (x and the weights; q, k, v and dO; in G,
H and I also the LayerNorm scale and shift and the normalized rows, which
are the product's operand), the TPU's default precision for an fp32
product, and read the epilogue's inputs and write their output in fp32.
They are held to the same ATOL + RTOL against the fp32 plain versions on
those rounded operands (``_fp32_reference``); kernel D computes in fp32
throughout and is held to GN_F32_TOL * (1 + |plain|).

Gradients: kernels E and F round P and dS to bf16 before their second
tensor-core product (relative 2^-9 each) and sum up to Sk or Sq such
terms, which the fp32 plain backward does not; an element near zero can
then miss the bound above by more than its own size, so they are held to
|kernel - plain| <= GRAD_ATOL_REL * max|plain| + RTOL * |plain|, and
``test_flash_backward_every_plan`` also holds each whole gradient to
GRAD_REL_L2 relative L2 error. The lse is fp32 on both sides: LSE_ATOL.
"""
import copy
import dataclasses

import pytest
import torch

from hcpdiff_tpu_torch.models.layers import init_flax_like
from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from hcpdiff_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from hcpdiff_tpu_torch.ops import conv as cv
from hcpdiff_tpu_torch.ops import flash_attention as fa
from hcpdiff_tpu_torch.ops import groupnorm as gn
from hcpdiff_tpu_torch.ops import matmul as mm
from hcpdiff_tpu_torch.ops.conv import conv3x3, conv3x3_plain
from hcpdiff_tpu_torch.ops.flash_attention import attention_plain, flash_attention
from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
from hcpdiff_tpu_torch.ops.matmul import (fused_dense, fused_dense_plain, geglu_dense,
                                          geglu_dense_plain)

ATOL, RTOL = 1e-2, 1.6e-2
GRAD_ATOL_REL, LSE_ATOL = 1e-2, 1e-3
# E and F's dq, dk and dv, relative L2 over the whole tensor: the larger of
# 1e-2 and twice the worst value of the mma.sync kernels E and F replaced,
# 2.73e-3 at every shape here and in chip_smoke.py (tools/bwd_errors.py on
# that checkout, H100 80GB HBM3); so 1e-2
GRAD_REL_L2 = 1e-2
# A's o at long sequences, relative L2 over the whole tensor (rounding o and
# P to bf16 gives a few 1e-3)
O_REL_L2 = 1e-2
# kernel D in fp32 against its fp32 plain version: both sum in fp32 in
# different orders (D's statistics end in double)
GN_F32_TOL = 1e-5
# a whole network on the card against fp32 on the CPU: relative L2 error
MODEL_REL_TOL = 5e-2
pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    # fp32 references on the card compute in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


def _rn(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, device='cuda', generator=gen) * scale).to(dtype)


def _r(t):
    """t with its values rounded to bf16 (an fp32 call's matrix operand)."""
    return t.to(torch.bfloat16).to(t.dtype)


def _close(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    assert bool((err <= ATOL + RTOL * ref.float().abs()).all()), float(err.max())


def _grad_rel_l2(out, ref):
    """Relative L2 error of a gradient on the card against its plain version."""
    return float((out.float() - ref.float()).norm() / ref.float().norm())


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


def test_flash_remat_keeps_the_forward_outputs(gen, monkeypatch):
    """Kernel A under the ``flash`` remat policy (``models/unet.py:remat``):
    the forward launches A with lse once, the recompute launches nothing,
    and E and F read the o and lse of that launch, which equal a direct
    launch's bit for bit."""
    from hcpdiff_tpu_torch.models.unet import remat
    shape = (2, 5, 1024, 64)
    q, k, v = (_rn(gen, *shape).requires_grad_(True) for _ in range(3))
    scale = shape[-1] ** -0.5
    with torch.no_grad():
        o_ref, lse_ref = fa.flash_attention_lse(q, k, v, scale)
    read = []
    bwd_dq = fa.flash_attention_bwd_dq

    def recorded_dq(q_, k_, v_, lse, do, delta, *rest):
        read.append(lse)
        fa.flash_attention_bwd_dq = bwd_dq      # the launch counts on the wrapper's own
        return bwd_dq(q_, k_, v_, lse, do, delta, *rest)
    monkeypatch.setattr(fa, 'flash_attention_bwd_dq', recorded_dq)
    before = (flash_attention.launches, fa.flash_attention_lse.launches)
    out = remat(lambda *a: flash_attention(*a) * 1.0, q, k, v, policy='flash')
    assert (flash_attention.launches, fa.flash_attention_lse.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, fa.flash_attention_lse.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    assert torch.equal(out.detach(), o_ref) and len(read) == 1
    assert torch.equal(read[0], lse_ref)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('S', [1000, 4000])
@pytest.mark.parametrize('D', fa.PADDED_HEAD_DIMS)
def test_flash_every_plan(gen, D, S, causal):
    """A, with and without lse, at every padded head dim it is built for
    (each its own plan: tiles, ring, swizzle, output split), causal and
    not, at a ragged S (the masks of the last tile and of the diagonal), on
    head-split views of [B, S, H * D] buffers (strides, no copy). o is also
    held to O_REL_L2 relative L2 over the whole tensor: at S = 4000 |o| is
    ~0.02, so ATOL alone would pass an error of half of o."""
    B, H = 1, 2
    q, k, v = (_rn(gen, B, S, H * D).view(B, S, H, D).transpose(1, 2) for _ in range(3))
    scale = D ** -0.5
    counters = (flash_attention, fa.flash_attention_lse)
    before = [c.launches for c in counters]
    ref = attention_plain(q, k, v, scale, causal)
    for out in (flash_attention(q, k, v, scale, causal),
                fa.flash_attention_lse(q, k, v, scale, causal)[0]):
        _close(out, ref)
        assert float((out.float() - ref.float()).norm() / ref.float().norm()) <= O_REL_L2
    _, lse = fa.flash_attention_lse(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert float((lse - fa.attention_lse_plain(q, k, scale, causal)).abs().max()) <= LSE_ATOL
    assert [c.launches for c in counters] == [before[0] + 3, before[1] + 2]


@pytest.mark.parametrize('shape', [(2, 8, 1024, 40), (2, 8, 1024, 80), (1, 2, 300, 40),
                                   (1, 2, 200, 80), (1, 2, 300, 512)])
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


@pytest.mark.parametrize('shape', [(1, 10, 4096, 64), (1, 20, 1024, 64)])
def test_flash_sdxl_training_shapes(gen, shape):
    """A with lse, E and F at an SDXL LoRA step's self-attention shapes at
    batch 1 (D = 64: levels 1 and 2 of a 1024 px latent) against the plain
    forward, lse and backward; one launch of each a call."""
    B, H, S, D = shape
    q, k, v, do = (_rn(gen, B, S, H * D).view(B, S, H, D).transpose(1, 2) for _ in range(4))
    scale = D ** -0.5
    counters = (fa.flash_attention_lse, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    o, lse = fa.flash_attention_lse(q, k, v, scale)
    ref = attention_plain(q, k, v, scale)
    _close(o, ref)
    assert float((o.float() - ref.float()).norm() / ref.float().norm()) <= O_REL_L2
    assert float((lse - fa.attention_lse_plain(q, k, scale)).abs().max()) <= LSE_ATOL
    delta = fa.attention_delta(o, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, lse, do, delta, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, scale)
    assert [c.launches for c in counters] == [b + 1 for b in before]
    for out, ref in zip((dq, dk, dv), fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                                         scale)):
        _close_grad(out, ref)
        assert _grad_rel_l2(out, ref) <= GRAD_REL_L2


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('S', [1000, 4000])
@pytest.mark.parametrize('D', fa.PADDED_HEAD_DIMS)
def test_flash_backward_every_plan(gen, D, S, causal):
    """E and F at every padded head dim they are built for (each its own
    plan: tiles, ring, swizzle, output split; 512 the D-chunked variants),
    causal and not, at a ragged S (the masks of the last tile and of the
    diagonal), on head-split views of [B, S, H * D] buffers for q, k, v and
    dO (strides, no copy), against the plain backward: each gradient
    within _close_grad and within GRAD_REL_L2 relative L2 over the whole
    tensor; one launch of E and one of F a call."""
    B, H = 1, 2
    q, k, v, do = (_rn(gen, B, S, H * D).view(B, S, H, D).transpose(1, 2) for _ in range(4))
    scale = D ** -0.5
    o, lse = fa.flash_attention_lse(q, k, v, scale, causal)
    delta = fa.attention_delta(o, do)
    counters = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    dq = fa.flash_attention_bwd_dq(q, k, v, lse, do, delta, scale, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, scale, causal)
    assert [c.launches for c in counters] == [before[0] + 1, before[1] + 1]
    for out, ref in zip((dq, dk, dv), fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                                         scale, causal)):
        _close_grad(out, ref)
        assert _grad_rel_l2(out, ref) <= GRAD_REL_L2


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('shape', [(2, 10, 1024, 64), (1, 2, 512, 128), (2, 4, 512, 160),
                                   (1, 2, 300, 120), (1, 2, 300, 40), (1, 2, 320, 512)])
def test_flash_classic_head_dims_and_causal(gen, shape, causal):
    """A, A with lse, E and F at the head dims the classic route adds (64,
    128, 160; 120 pads to 128), and at 512 (E and F's D-chunked variant),
    and a ragged S, causal and not, against
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
    raises; without causal, Sq != Sk runs, forward and backward (E streams
    Sk keys, F Sq queries), with more queries than keys and fewer."""
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
    for q, kv in ((q, kv), (kv, q)):
        do = _rn(gen, *q.shape)
        o, lse = fa.flash_attention_lse(q, kv, kv, 0.125)
        delta = fa.attention_delta(o, do)
        got = (fa.flash_attention_bwd_dq(q, kv, kv, lse, do, delta, 0.125),
               *fa.flash_attention_bwd_dkv(q, kv, kv, lse, do, delta, 0.125))
        for out, ref in zip(got, fa.flash_attention_backward_plain(q, kv, kv, o, lse, do,
                                                                    0.125)):
            _close_grad(out, ref)


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


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('M,K,N', [
    (4096, 320, 1280), (1000, 640, 2560), (2048, 5120, 1280), (300, 5120, 1280),
    (1000, 32, 128), (300, 64, 64), (1000, 64, 100), (300, 32, 200), (1000, 64, 98),
    (300, 5120, 130)])
def test_gemm_kernels(gen, M, K, N, dtype):
    """B and C (with and without a residual) against their plain versions:
    ragged M (1000, 300; split K at [300, 5120]), K of 32 and 64 (channels
    zero-filled up to the 64-channel K step), N that no built tile divides
    (100, 200), and N % 4 == 2 (98 unsplit, 130 split: the epilogue's
    column pairs), in bf16 and fp32."""
    x = _rn(gen, M, K, dtype=dtype)
    w, b = _rn(gen, 2 * N, K, scale=K ** -0.5, dtype=dtype), _rn(gen, 2 * N, dtype=dtype)
    before = (geglu_dense.launches, fused_dense.launches)
    _close(geglu_dense(x, w, b), geglu_dense_plain(_r(x), _r(w), b))
    w1, b1 = _rn(gen, N, K, scale=K ** -0.5, dtype=dtype), _rn(gen, N, dtype=dtype)
    res = _rn(gen, M, N, dtype=dtype)
    _close(fused_dense(x, w1, b1), fused_dense_plain(_r(x), _r(w1), b1))
    _close(fused_dense(x, w1, b1, res), fused_dense_plain(_r(x), _r(w1), b1, res))
    _close(fused_dense(x, w1), fused_dense_plain(_r(x), _r(w1)))
    assert (geglu_dense.launches, fused_dense.launches) == (before[0] + 1, before[1] + 3)


# x [M, K] and the weight's rows of the default UNet's B (w [8C, C]) and C
# with the block residual (w [C, 4C]) at each level, batch 4 under CFG
FFN_MAIN_SHAPES = [('B', 32768, 320, 2560), ('B', 8192, 640, 5120), ('B', 2048, 1280, 10240),
                   ('B', 512, 1280, 10240), ('C', 32768, 1280, 320), ('C', 8192, 2560, 640),
                   ('C', 2048, 5120, 1280), ('C', 512, 5120, 1280)]


@pytest.mark.parametrize('kind,M,K,rows', FFN_MAIN_SHAPES)
def test_gemm_main_path_shapes(gen, kind, M, K, rows):
    x, w = _rn(gen, M, K), _rn(gen, rows, K, scale=K ** -0.5)
    b = _rn(gen, rows)
    if kind == 'B':
        _close(geglu_dense(x, w, b), geglu_dense_plain(x, w, b))
    else:
        res = _rn(gen, M, rows)
        _close(fused_dense(x, w, b, res), fused_dense_plain(x, w, b, res))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_gemm_every_tile_and_split(gen, dtype):
    """Every built column tile, split and unsplit, on one ragged shape (the
    plan picks one of them; the others must be right too), and a split
    output is the same, bit for bit, on a second run (the partial sums are
    added in split order, with no atomics)."""
    M, K, N = 300, 1000, 640
    x = _rn(gen, M, K, dtype=dtype)
    for geglu in (True, False):
        rows = 2 * N if geglu else N
        w, b = _rn(gen, rows, K, scale=K ** -0.5, dtype=dtype), _rn(gen, rows, dtype=dtype)
        res = None if geglu else _rn(gen, M, N, dtype=dtype)
        mode = mm._GEGLU if geglu else mm._DENSE_RES
        ref = (geglu_dense_plain(_r(x), _r(w), b) if geglu
               else fused_dense_plain(_r(x), _r(w), b, res))
        for g, bn, per_sm in mm.GEMM_TILES:
            if g != geglu:
                continue
            for splits in (1, 2, 5, 16):
                plan = mm.GemmPlan(bn, splits, M, N, -(-K // mm.BK), geglu, per_sm)
                out = mm._launch('gemm', mode, x, w, b, res, N, plan)
                _close(out, ref)
                if splits > 1:
                    again = mm._launch('gemm', mode, x, w, b, res, N, plan)
                    torch.cuda.synchronize()
                    assert torch.equal(out, again), (plan, float((out - again).abs().max()))


# (B, S, C, G): both regimes (gn_plan: resident [2, 4096, 320], [8, 64,
# 2560]; re-read [1, 512 * 512, 128], [8, 4096, 640]), a ragged S (3, 100:
# spans of 3 rows, the last block shorter) and odd group widths (C / G = 3
# and 5: groups straddle the 8-channel vectors)
GN_SHAPES = [(2, 4096, 320, 32), (2, 256, 1280, 32), (1, 512 * 512, 128, 32), (3, 100, 64, 8),
             (8, 4096, 640, 32), (8, 64, 2560, 32), (2, 300, 96, 32), (2, 1000, 160, 32)]


@pytest.mark.parametrize('B,S,C,G', GN_SHAPES)
@pytest.mark.parametrize('silu', [True, False])
def test_group_norm(gen, B, S, C, G, silu):
    x = _rn(gen, B, S, C, scale=3.0) + 1.0
    scale = torch.rand(C, device='cuda', generator=gen) + 0.5
    bias = torch.randn(C, device='cuda', generator=gen)
    before = group_norm_silu.launches
    _close(group_norm_silu(x, scale, bias, G, 1e-5, silu),
           group_norm_silu_plain(x, scale, bias, G, 1e-5, silu))
    assert group_norm_silu.launches == before + 1


@pytest.mark.parametrize('B,S,C,G', GN_SHAPES)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_group_norm_param_dtypes_and_determinism(gen, B, S, C, G, dtype):
    """D reads bf16 scale and bias as they are (a bf16 model's parameters)
    as well as fp32 ones, for a bf16 and an fp32 x, and two launches give
    bitwise equal outputs (every block reduces the partial sums in one
    fixed order)."""
    x = _rn(gen, B, S, C, scale=3.0, dtype=dtype) + 1.0
    for p_dtype in (torch.bfloat16, torch.float32):
        scale = (torch.rand(C, device='cuda', generator=gen) + 0.5).to(p_dtype)
        bias = torch.randn(C, device='cuda', generator=gen).to(p_dtype)
        out = group_norm_silu(x, scale, bias, G, 1e-5, True)
        again = group_norm_silu(x, scale, bias, G, 1e-5, True)
        ref = group_norm_silu_plain(x, scale, bias, G, 1e-5, True)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        if dtype == torch.float32:
            assert bool(((out - ref).abs() <= GN_F32_TOL * (1 + ref.abs())).all()), float(
                (out - ref).abs().max())
        else:
            _close(out, ref)


def test_group_norm_batch_past_the_card(gen):
    """A batch of more samples than the card has SMs takes one launch a
    slice of as many samples as it holds blocks at once."""
    B = 300
    x = _rn(gen, B, 100, 64, scale=3.0) + 1.0
    scale = torch.rand(64, device='cuda', generator=gen) + 0.5
    bias = torch.randn(64, device='cuda', generator=gen)
    per_launch = torch.cuda.get_device_properties(0).multi_processor_count
    before = group_norm_silu.launches
    _close(group_norm_silu(x, scale, bias, 8, 1e-5, True),
           group_norm_silu_plain(x, scale, bias, 8, 1e-5, True))
    assert group_norm_silu.launches == before + -(-B // per_launch)


def test_group_norm_in_a_cuda_graph(gen):
    """D's cooperative launch is captured in a CUDA graph and replays
    right, its barrier counters left as they were."""
    x = _rn(gen, 2, 4096, 320, scale=3.0) + 1.0
    scale = torch.rand(320, device='cuda', generator=gen) + 0.5
    bias = torch.randn(320, device='cuda', generator=gen)
    ref = group_norm_silu_plain(x, scale, bias, 32, 1e-5, True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        group_norm_silu(x, scale, bias, 32, 1e-5, True)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = group_norm_silu(x, scale, bias, 32, 1e-5, True)
    for _ in range(3):
        graph.replay()
        _close(out, ref)
    _close(group_norm_silu(x, scale, bias, 32, 1e-5, True), ref)


def _ln_inputs(gen, M, K):
    """LayerNorm input, scale and shift (bf16)."""
    return _rn(gen, M, K, scale=2.0) + 0.5, 1.0 + _rn(gen, K, scale=0.1), _rn(gen, K, scale=0.1)


# x [M, C] of the fused UNet's G, H and I at its four transformer levels
# (64x64, 32x32, 16x16, 8x8 mid), batch 1 and 4 under CFG (M = 2 * batch * S)
LN_LEVELS = [(2 * b * S, C) for b in (1, 4)
             for S, C in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))]


@pytest.mark.parametrize('M,K', [(4096, 320), (1000, 640), (512, 1280), (300, 32)]
                         + [s for s in LN_LEVELS if s != (512, 1280)])
def test_ln_gemm_kernels(gen, M, K):
    """G, H and I against their plain versions (eps 1e-6, as the UNet
    passes it), on a ragged M and at the UNet's widths, and at the fused
    UNet's four levels at batch 1 and 4."""
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


def _ln_route(kind, x, g, b, ws, bias, plan=None):
    """G (three weights), H (one [2N, K] weight and its bias) or I through
    ``_ln_launch`` under ``plan`` (the planned one if None); the outputs."""
    mode = mm._GEGLU if kind == 'H' else mm._DENSE
    n_out = ws[0].shape[0] // 2 if kind == 'H' else ws[0].shape[0]
    return mm._ln_launch(kind, mode, x, g, b, ws, bias, n_out, 1e-6, plan)


def _ln_refs(kind, x, g, b, ws, bias):
    """The plain version on the operands an fp32 call rounds to bf16."""
    if x.dtype == torch.float32:
        outs = _ln_fp32_reference(kind, x, g, b, *ws, *([bias] if kind == 'H' else []))
    elif kind == 'H':
        outs = mm.ln_geglu_plain(x, g, b, ws[0], bias, 1e-6)
    elif kind == 'G':
        outs = mm.ln_qkv_plain(x, g, b, *ws, 1e-6)
    else:
        outs = mm.ln_dense_plain(x, g, b, ws[0], 1e-6)
    return list(outs) if isinstance(outs, tuple) else [outs]


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('M,K,N', [(300, 320, 320), (300, 320, 98), (130, 1280, 200)])
def test_ln_gemm_every_tile_and_group(gen, M, K, N, dtype):
    """Every built tile whose rows fit at K, under one run, two and as
    many runs as column tiles, on a ragged M, against the plain versions:
    N = 320 (the 160-column tile divides it, the others leave a ragged
    last tile), 98 (N * 2 % 16 != 0: the epilogue's column pairs) and 200;
    and two launches are the same, bit for bit (a fixed order, no
    atomics)."""
    x, g, b = _ln_inputs(gen, M, K)
    x, g, b = x.to(dtype), g.to(dtype), b.to(dtype)
    for kind in 'GHI':
        rows = 2 * N if kind == 'H' else N
        ws = [_rn(gen, rows, K, scale=K ** -0.5, dtype=dtype)
              for _ in range(3 if kind == 'G' else 1)]
        bias = _rn(gen, rows, dtype=dtype) if kind == 'H' else None
        refs = _ln_refs(kind, x, g, b, ws, bias)
        base = mm.ln_gemm_plan(kind == 'H', len(ws), M, N, K)
        for geglu, r, bn, stages, per_sm in mm.LN_GEMM_TILES:
            if geglu != (kind == 'H') or not mm.ln_gemm_fits(geglu, r, bn, stages, per_sm,
                                                              base.ksteps):
                continue
            tile = dataclasses.replace(base, rows=r, bn=bn, stages=stages, per_sm=per_sm,
                                       groups=1)
            for groups in sorted({1, min(2, tile.tiles), tile.tiles}):
                plan = dataclasses.replace(tile, groups=groups)
                outs = _ln_route(kind, x, g, b, ws, bias, plan)
                again = _ln_route(kind, x, g, b, ws, bias, plan)
                for out, ref, twice in zip(outs, refs, again):
                    _close(out, ref)
                    assert torch.equal(out, twice), plan


def test_ln_gemm_in_a_cuda_graph(gen):
    """G, H and I captured in one CUDA graph replay right."""
    M, K = 2 * 1024, 640
    x, g, b = _ln_inputs(gen, M, K)
    ws = [_rn(gen, K, K, scale=K ** -0.5) for _ in range(3)]
    w2, b2 = _rn(gen, 8 * K, K, scale=K ** -0.5), _rn(gen, 8 * K)
    refs = (list(mm.ln_qkv_plain(x, g, b, *ws, 1e-6)) + [mm.ln_dense_plain(x, g, b, ws[0], 1e-6)]
            + [mm.ln_geglu_plain(x, g, b, w2, b2, 1e-6)])

    def run():
        return (list(mm.ln_qkv(x, g, b, *ws, 1e-6)) + [mm.ln_dense(x, g, b, ws[0], 1e-6)]
                + [mm.ln_geglu(x, g, b, w2, b2, 1e-6)])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(2):
        graph.replay()
        for out, ref in zip(outs, refs):
            _close(out, ref)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('B,Cin,H,W,Cout', [
    (2, 320, 64, 64, 320), (2, 640, 16, 16, 1280), (8, 2560, 8, 8, 1280), (1, 96, 5, 7, 64),
    (8, 640, 16, 16, 1280), (8, 2560, 16, 16, 1280), (8, 1280, 8, 8, 1280), (2, 32, 32, 32, 32)])
def test_conv3x3_kernel(gen, B, Cin, H, W, Cout, dtype):
    """J against its plain version with each epilogue, at the UNet's small
    levels (split K where the plan splits) and at Cin 32 and 96 (channels
    zero-filled up to the 64-channel K step), in bf16 and fp32; a weight
    that is not channels_last (a merged LoRA weight) is copied into it, not
    refused."""
    cl = torch.channels_last
    x = _rn(gen, B, Cin, H, W, dtype=dtype).to(memory_format=cl)
    w = _rn(gen, Cout, Cin, 3, 3, scale=(9 * Cin) ** -0.5, dtype=dtype).to(memory_format=cl)
    b, rb = _rn(gen, Cout, dtype=dtype), _rn(gen, B, Cout, dtype=dtype)
    res = _rn(gen, B, Cout, H, W, dtype=dtype).to(memory_format=cl)
    before = conv3x3.launches
    out = conv3x3(x, w, b)
    assert conv3x3.launches == before + 1 and out.is_contiguous(memory_format=cl)
    _close(out, conv3x3_plain(_r(x), _r(w), b))
    _close(conv3x3(x, w, b, rb, res), conv3x3_plain(_r(x), _r(w), b, rb, res))
    _close(conv3x3(x, w.contiguous(), None, rb), conv3x3_plain(_r(x), _r(w), None, rb))


def test_conv3x3_every_tile_and_split(gen):
    """Every built column tile, split and unsplit, on one shape (the plan
    picks one of them; the others must be right too)."""
    cl = torch.channels_last
    B, Cin, H, W, Cout = 2, 192, 8, 8, 640
    x = _rn(gen, B, Cin, H, W).to(memory_format=cl)
    w = _rn(gen, Cout, Cin, 3, 3, scale=(9 * Cin) ** -0.5).to(memory_format=cl)
    b, rb = _rn(gen, Cout), _rn(gen, B, Cout)
    res = _rn(gen, B, Cout, H, W).to(memory_format=cl)
    ref = conv3x3_plain(x, w, b, rb, res)
    base = cv.conv_plan(B, H, W, Cin, Cout)
    for bn in cv.BN_CHOICES:
        for splits in (1, 2, 5):
            plan = cv.ConvPlan(bn, splits, base.m, base.n, base.ksteps)
            _close(cv._launch(x, w, b, rb, res, plan), ref)


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
    before = flash_attention.launches
    xf = x.float()                                                # fp32 runs the kernel
    out = flash_attention(xf, xf, xf)
    assert out.dtype == torch.float32
    _close(out, attention_plain(xf, xf, xf))
    x32 = x[..., :32]                                             # head dim 32: padded to 48
    _close(flash_attention(x32, x32, x32), attention_plain(x32, x32, x32))
    assert flash_attention.launches == before + 2
    with pytest.raises(ValueError):                               # mixed dtypes
        flash_attention(x, xf, x)
    with pytest.raises(ValueError):
        fused_dense(_rn(gen, 4, 30), _rn(gen, 8, 30))            # K % 8 != 0
    with pytest.raises(ValueError):                               # a tile B is not built with
        mm._launch('geglu_dense', mm._GEGLU, _rn(gen, 4, 32), _rn(gen, 16, 32), None, None, 8,
                   mm.GemmPlan(320, 1, 4, 8, 1, True, 1))
    with pytest.raises(ValueError):
        group_norm_silu(_rn(gen, 2, 16, 30), torch.ones(30, device='cuda'),
                        torch.zeros(30, device='cuda'), 3)       # C % 8 != 0
    ones = torch.ones(64, device='cuda')
    with pytest.raises(ValueError):                               # an fp16 scale
        group_norm_silu(_rn(gen, 2, 16, 64), ones.half(), ones.half(), 32)
    x = _rn(gen, 200, 16, 64)                                     # a grid the card cannot hold
    with pytest.raises(RuntimeError):                             # at once: the launch is refused
        gn._launch(x, ones, ones, 32, 1e-5, True, gn.gn_plan(200, 16, 64, 2, sms=264))
    x, g, b = _ln_inputs(gen, 4, 36)
    with pytest.raises(ValueError):                               # K % 8 != 0
        mm.ln_dense(x, g, b, _rn(gen, 8, 36))
    with pytest.raises(ValueError):                               # fp32 LayerNorm scale
        mm.ln_dense(x[:, :32].contiguous(), g[:32].float(), b[:32], _rn(gen, 8, 32))
    with pytest.raises(ValueError):                               # Cin % 8 != 0
        conv3x3(_rn(gen, 1, 12, 4, 4), _rn(gen, 8, 12, 3, 3))
    q = _rn(gen, 1, 2, 256, 576)
    lse = torch.zeros(1, 2, 256, device='cuda')
    q96 = q[..., :96]                                             # head dim 96: padded to 128
    before = flash_attention.launches
    _close(flash_attention(q96, q96, q96), attention_plain(q96, q96, q96))
    # a negative scale: the wrapper runs q (-k)^T * -scale
    _close(flash_attention(q96, q96, q96, -0.1), attention_plain(q96, q96, q96, -0.1))
    q192 = q[..., :192]                                           # causal 192: padded to 512
    _close(flash_attention(q192, q192, q192, causal=True),
           attention_plain(q192, q192, q192, causal=True))
    assert flash_attention.launches == before + 3
    for causal in (False, True):                                  # D=576 (> 512) raises
        with pytest.raises(ValueError):
            flash_attention(q, q, q, causal=causal)
        with pytest.raises(ValueError):
            fa.flash_attention_lse(q, q, q, 0.1, causal)
        with pytest.raises(ValueError):
            fa.flash_attention_bwd_dq(q, q, q, lse, q, lse, 0.1, causal)
        with pytest.raises(ValueError):
            fa.flash_attention_bwd_dkv(q, q, q, lse, q, lse, 0.1, causal)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('D', [16, 20, 96, 144, 192])
def test_flash_padded_head_dims(gen, D, causal):
    """A, A with lse, E and F at head dims outside the built set: the
    wrapper zero-pads to the next built dim, the kernels run, and o, lse,
    dq, dk and dv match the plain versions at D."""
    B, H, S = 2, 2, 320
    q, k, v = (_rn(gen, B, H, S, D) for _ in range(3))
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


def _ln_fp32_reference(route, x, g, b, *params, eps=1e-6):
    """G, H and I's fp32 function: LayerNorm of the rounded x with the
    rounded scale and shift, rounded to bf16 (the product's operand, as in
    the bf16 route), then the fp32 plain product with the rounded weights,
    and H's bias in fp32."""
    xn = mm._layer_norm(x.to(torch.bfloat16), g.to(torch.bfloat16), b.to(torch.bfloat16), eps)
    if route == 'H':
        return geglu_dense_plain(xn, _r(params[0]), params[1])
    outs = tuple(torch.nn.functional.linear(xn, _r(w)) for w in params)
    return outs if route == 'G' else outs[0]


def _fp32_cases(gen):
    """name -> (kernel, the fp32 reference, fp32 args) for every kernel
    family: the plain version on the rounded matrix operands."""
    f32 = torch.float32
    rn = lambda *s, scale=1.0: _rn(gen, *s, scale=scale, dtype=f32)
    q, k, v, do = (rn(2, 8, 1024, 40) for _ in range(4))
    sc = 40 ** -0.5
    o, lse = fa.attention_plain(q, k, v, sc), fa.attention_lse_plain(q, k, sc)
    delta = fa.attention_delta(o, do)
    x, w, b = rn(1000, 640), rn(2560, 640, scale=640 ** -0.5), rn(2560)
    w1, b1, res = rn(1280, 640, scale=640 ** -0.5), rn(1280), rn(1000, 1280)
    g_, b_ = 1.0 + rn(640, scale=0.1), rn(640, scale=0.1)
    ws = [rn(640, 640, scale=640 ** -0.5) for _ in range(3)]
    cl = torch.channels_last
    xc = rn(2, 320, 32, 32).to(memory_format=cl)
    wc = rn(640, 320, 3, 3, scale=2880 ** -0.5).to(memory_format=cl)
    conv_extra = [rn(640), rn(2, 640), rn(2, 640, 32, 32).to(memory_format=cl)]
    qkv = lambda q, k, v, *rest: (_r(q), _r(k), _r(v), *rest)
    bwd = lambda q, k, v, lse, do, *rest: (_r(q), _r(k), _r(v), lse, _r(do), *rest)
    return {
        'A': (flash_attention, lambda *a: attention_plain(*qkv(*a), sc), [q, k, v]),
        'A-lse': (lambda *a: fa.flash_attention_lse(*a, sc),
                  lambda *a: (attention_plain(*qkv(*a), sc),
                              fa.attention_lse_plain(*qkv(*a)[:2], sc)), [q, k, v]),
        'E': (fa.flash_attention_bwd_dq, lambda *a: fa.flash_bwd_dq_plain(*bwd(*a)),
              [q, k, v, lse, do, delta, sc]),
        'F': (fa.flash_attention_bwd_dkv, lambda *a: fa.flash_bwd_dkv_plain(*bwd(*a)),
              [q, k, v, lse, do, delta, sc]),
        'B': (geglu_dense, lambda x, w, b: geglu_dense_plain(_r(x), _r(w), b), [x, w, b]),
        'C': (fused_dense, lambda x, w, *eb: fused_dense_plain(_r(x), _r(w), *eb),
              [x, w1, b1, res]),
        'D': (lambda *a: group_norm_silu(*a, 32, 1e-5, True),
              lambda *a: group_norm_silu_plain(*a, 32, 1e-5, True),
              [rn(2, 4096, 320, scale=3.0) + 1.0, 0.5 + torch.rand(320, device='cuda'),
               rn(320)]),
        'G': (lambda *a: mm.ln_qkv(*a, 1e-6), lambda *a: _ln_fp32_reference('G', *a),
              [x, g_, b_, *ws]),
        'H': (lambda *a: mm.ln_geglu(*a, 1e-6), lambda *a: _ln_fp32_reference('H', *a),
              [x, g_, b_, w, b]),
        'I': (lambda *a: mm.ln_dense(*a, 1e-6), lambda *a: _ln_fp32_reference('I', *a),
              [x, g_, b_, ws[0]]),
        'J': (conv3x3, lambda x, w, *e: conv3x3_plain(_r(x), _r(w), *e), [xc, wc, *conv_extra]),
    }


FP32_COUNTERS = {'A': flash_attention, 'A-lse': fa.flash_attention_lse,
                 'E': fa.flash_attention_bwd_dq, 'F': fa.flash_attention_bwd_dkv,
                 'B': geglu_dense, 'C': fused_dense, 'D': group_norm_silu, 'G': mm.ln_qkv,
                 'H': mm.ln_geglu, 'I': mm.ln_dense, 'J': conv3x3}


@pytest.mark.parametrize('name', sorted(FP32_COUNTERS))
def test_fp32_kernels(gen, name):
    """Every wrapper launches its kernel on fp32 CUDA tensors, returns
    fp32, and matches its fp32 reference (``_fp32_cases``): the
    tensor-core kernels within ATOL + RTOL, E and F at the gradient bound,
    the lse within LSE_ATOL, D within GN_F32_TOL * (1 + |plain|)."""
    kernel, plain, args = _fp32_cases(gen)[name]
    before = FP32_COUNTERS[name].launches
    outs, refs = kernel(*args), plain(*args)
    assert FP32_COUNTERS[name].launches == before + 1
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert out.dtype == torch.float32 and out.shape == ref.shape
        if name == 'D':
            assert bool(((out - ref).abs() <= GN_F32_TOL * (1 + ref.abs())).all()), float(
                (out - ref).abs().max())
        elif name in ('E', 'F'):
            _close_grad(out, ref)
        elif ref.dim() == 3 and name == 'A-lse' and out is outs[-1]:
            assert float((out - ref).abs().max()) <= LSE_ATOL
        else:
            _close(out, ref)


def _rel_l2(out, ref):
    return float((out.float().cpu() - ref.float()).norm() / ref.float().norm())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('fused', [False, True])
def test_tiny_unet_at_32x32_on_the_card(gen, fused, dtype):
    """The tiny UNet (default and fused) at a 32x32 latent, whose level-0
    self-attention (S = 1024, D = 16) runs kernel A zero-padded to D = 48,
    against the same weights in fp32 on the CPU."""
    torch.manual_seed(0)
    cpu = init_flax_like(UNet2DCondition(UNetConfig.tiny()), torch.Generator().manual_seed(1))
    card = UNet2DCondition(UNetConfig.tiny(), fused_sublayers=fused)
    card.load_state_dict(cpu.state_dict())
    card = card.to('cuda').to_compute_dtype(dtype).to(memory_format=torch.channels_last)
    x, ctx = torch.randn(2, 32, 32, 4), torch.randn(2, 77, 32)
    t = torch.tensor([300, 20])
    before = flash_attention.launches
    with torch.no_grad():
        out = card(x.cuda(), t.cuda(), ctx.cuda())
        ref = cpu(x, t, ctx)
    assert flash_attention.launches > before
    assert _rel_l2(out, ref) <= MODEL_REL_TOL


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_tiny_sdxl_unet_on_the_card(gen, dtype):
    """The tiny text_time UNet at a 64x64 latent, whose level-1
    self-attention (S = 1024, D = 16) runs kernel A, with pooled and
    time_ids inputs, against the same weights in fp32 on the CPU."""
    cfg = UNetConfig.tiny_sdxl()
    cpu = init_flax_like(UNet2DCondition(cfg), torch.Generator().manual_seed(4))
    card = UNet2DCondition(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to('cuda').to_compute_dtype(dtype).to(memory_format=torch.channels_last)
    g = torch.Generator().manual_seed(5)
    x, ctx = torch.randn(2, 64, 64, 4, generator=g), torch.randn(2, 77, 32, generator=g)
    pooled = torch.randn(2, 32, generator=g)
    time_ids = torch.tensor([[512.0, 512, 0, 0, 512, 512], [768, 640, 16, 32, 512, 512]])
    t = torch.tensor([300, 20])
    before = (flash_attention.launches, geglu_dense.launches, group_norm_silu.launches)
    with torch.no_grad():
        out = card(x.cuda(), t.cuda(), ctx.cuda(), pooled_text_emb=pooled.cuda(),
                   time_ids=time_ids.cuda())
        ref = cpu(x, t, ctx, pooled_text_emb=pooled, time_ids=time_ids)
    after = (flash_attention.launches, geglu_dense.launches, group_norm_silu.launches)
    assert all(a > b for a, b in zip(after, before))
    assert _rel_l2(out, ref) <= MODEL_REL_TOL


def test_tiny_vae_decode_fp32_on_the_card(gen):
    """The tiny VAE decode in fp32 on the card (its mid attention, S =
    1024, D = 32, runs kernel A zero-padded to D = 48) against the CPU."""
    cpu = init_flax_like(AutoencoderKL(VAEConfig.tiny()), torch.Generator().manual_seed(2))
    card = copy.deepcopy(cpu).to('cuda').to(memory_format=torch.channels_last)
    z = torch.randn(1, 32, 32, 4, generator=torch.Generator().manual_seed(3))
    before = flash_attention.launches
    with torch.no_grad():
        out, ref = card.decode(z.cuda()), cpu.decode(z)
    assert flash_attention.launches > before
    assert _rel_l2(out, ref) <= MODEL_REL_TOL


def test_visualizer_request_on_the_card(gen, tmp_path):
    """A tiny diffusers-layout directory (F16) loaded on the card and one
    text2img request through the config-driven entry point (bf16, 64 px:
    a 32x32 latent, so the UNet's level 0 and the VAE's mid block run
    kernel A); kernels A-D launch and the PNGs and YAMLs are written."""
    import os

    import numpy as np

    from hcpdiff_tpu_torch.infer.visualizer import main
    from hcpdiff_tpu_torch.models.factory import build_models
    from hcpdiff_tpu_torch.tools.random_diffusers import write_module
    from hcpdiff_tpu_torch.utils.images import read_png
    world = build_models('tiny', torch.float32, 'cpu', seed=2)
    for sub, key in (('unet', 'unet'), ('vae', 'vae'), ('text_encoder', 'te')):
        write_module(world[key], str(tmp_path / 'model' / sub), torch.float16)
    kernels = (flash_attention, geglu_dense, fused_dense, group_norm_silu)
    before = [k.launches for k in kernels]
    cfg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       'cfgs', 'infer', 'text2img.yaml')
    out = tmp_path / 'out'
    viser, images = main(['--cfg', cfg, f'pretrained_model={tmp_path / "model"}',
                          f'interface.0.save_root={out}', 'seed=3', 'bs=2',
                          'infer_args.width=64', 'infer_args.height=64',
                          'infer_args.inference_steps=2'])
    assert viser.device.type == 'cuda' and viser.dtype == torch.bfloat16
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert images.shape == (2, 64, 64, 3) and np.isfinite(images).all()
    assert images.min() >= 0 and images.max() <= 1
    for i in range(2):
        png = read_png(str(out / f'{i}-img.png'))
        assert (png == (images[i].clip(0, 1) * 255).astype(np.uint8)).all()
        assert (out / f'{i}-img.yaml').exists()


def _trainer_run(tmp_path, size, steps, cfg_name='lora_conventional.yaml', *extra):
    """lora_conventional.yaml (UNet + CLIP LoRA, AdamW, remat, the latent
    cache; or ``cfg_name``) through main() on the card in bf16, on the tiny
    world and four seeded PNGs at ``size`` (w, h) in a fixed bucket of that
    size."""
    import json
    import os

    import numpy as np

    from hcpdiff_tpu_torch.trainer.trainer import main
    from hcpdiff_tpu_torch.utils.images import write_png
    rng = np.random.default_rng(6)
    imgs = tmp_path / 'imgs'
    imgs.mkdir(parents=True)
    for i in range(4):
        write_png(str(imgs / f'{i}.png'), rng.integers(0, 256, size[::-1] + (3,), np.uint8))
    with open(imgs / 'captions.json', 'w') as f:
        json.dump({str(i): f'a photo of cat {i}' for i in range(4)}, f)
    cfg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       'cfgs', 'train', 'examples', cfg_name)
    src = 'data.dataset1.source.data_source1'
    return main(['--cfg', cfg, 'model.pretrained_model_name_or_path=tiny',
                 f'exp_dir={tmp_path / "exp"}', f'{src}.img_root={imgs}',
                 f'{src}.caption_file={imgs / "captions.json"}', 'data.dataset1.batch_size=2',
                 'data.dataset1.bucket._target_=FixedBucket',
                 f'data.dataset1.bucket.target_size=[{size[0]}, {size[1]}]',
                 f'train.train_steps={steps}', f'train.save_step={steps}',
                 'logger.0.log_step=1', *extra])


def test_tiny_trainer_on_the_card(gen, tmp_path):
    """Two steps of the config-driven trainer at 64 px (a 32x32 latent: the
    UNet's level-0 self-attention, S = 1024, and the VAE encoder's mid
    block run kernel A): kernels A (with lse), E, F, B, C and D launch,
    the losses are finite and both LoRA files are written."""
    import numpy as np
    kernels = (flash_attention, fa.flash_attention_lse, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, geglu_dense, fused_dense, group_norm_silu)
    before = [k.launches for k in kernels]
    trainer = _trainer_run(tmp_path, (64, 64), 2)
    assert trainer.device.type == 'cuda' and trainer.dtype == torch.bfloat16
    assert [k.launches > b for k, b in zip(kernels, before)] == [True] * len(kernels)
    assert len(trainer.history) == 2 and np.isfinite(trainer.history).all()
    assert sorted(p.name for p in (tmp_path / 'exp' / 'ckpts').iterdir()) == [
        'text_encoder-2.safetensors', 'unet-2.safetensors']
    up = next(iter(trainer.state.pack['lora_unet'].values()))['up']
    assert bool(up.detach().abs().sum() > 0)


def test_trainer_bucket_off_the_kernel_route(gen, tmp_path):
    """A 80x56 bucket: latents 40x28, so level 0's S = 1120 >= 1024 but
    S % 128 != 0, and the shared dispatch rule sends it to the plain
    attention (no A, E or F launch in training; the latent cache's VAE
    mid block at the same S takes the plain route too); B, C and D run."""
    kernels = (flash_attention, fa.flash_attention_bwd_dq, geglu_dense, fused_dense,
               group_norm_silu)
    before = [k.launches for k in kernels]
    trainer = _trainer_run(tmp_path, (80, 56), 1)
    assert trainer.step_shapes == [[(2, 28, 40, 4)]]
    assert [k.launches > b for k, b in zip(kernels, before)] == [False, False, True, True, True]


def test_dreamartist_step_doubles_the_unet_launches(gen, tmp_path):
    """One DreamArtist++.yaml step (both LoRA branches and a word pair, the
    words made by tools/create_embedding.py) at 64 px on the card runs the
    UNet twice: kernels B and C launch twice as often as in one
    lora_conventional.yaml step at the same batch; A with lse, E and F
    launch; the loss is finite."""
    import numpy as np

    from hcpdiff_tpu_torch.tools.create_embedding import main as create_embedding
    unet_kernels = (geglu_dense, fused_dense)
    before = [k.launches for k in unet_kernels]
    _trainer_run(tmp_path / 'plain', (64, 64), 1)
    plain = [k.launches - b for k, b in zip(unet_kernels, before)]
    for word in ('pt-dog1', 'pt-dog1-neg'):
        create_embedding(['tiny', word, '2', '--root', str(tmp_path / 'embs')])
    kernels = unet_kernels + (fa.flash_attention_lse, fa.flash_attention_bwd_dq,
                              fa.flash_attention_bwd_dkv)
    before = [k.launches for k in kernels]
    trainer = _trainer_run(tmp_path / 'da', (64, 64), 1, 'DreamArtist++.yaml',
                           f'tokenizer_pt.emb_dir={tmp_path / "embs"}')
    launched = [k.launches - b for k, b in zip(kernels, before)]
    assert trainer.dream_artist and np.isfinite(trainer.history).all()
    assert launched[:2] == [2 * n for n in plain] and min(launched[2:]) > 0
