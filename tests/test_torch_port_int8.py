"""The port's dynamic w8a8 int8 route (``ops/int8.py``: kernels K and L's
plain versions, and the UNet's ``int8=True``) against the JAX package's
``ops/int8.py`` and its ``HCP_INT8=1`` UNet, on the CPU.

The layer tests run the JAX functions op by op (``jax.disable_jit``):
under ``jit`` XLA's algebraic simplifier rewrites the scale's division by
127 as a product with 1/127, whose scales differ from the division's by an
ulp here and there (29 of 512 rows of a [512, 320] activation), and the
division is what ``int8.py`` writes and kernel K computes.

Quantization is discontinuous. The two UNets' other layers (norms, convs,
attention) agree to ~1e-7 relative, not bitwise, so an activation within
such a rounding of a half step (36.499996 against 36.500004) takes
neighbouring codes in the two packages, about one element a tiny UNet
call; that one code then moves everything after it (the tiny UNet's output
by up to 4e-3 relative L2). So the model-level tests hand JAX's activation
codes and scales to the port (``_CodeBridge``) after holding the port's own
codes, computed from its own activations, to within one step of them at
every element and equal at all but a thousandth; what remains is the
routing and the dequantizing arithmetic, which must then agree.

Tolerances: codes and scales bitwise; ``int8_dense`` within one ulp of the
output dtype (bitwise expected: the product is exact in int32 on both
sides, the dequantization the same fp32 operations); gradients rtol 1e-5
in fp32 (the straight-through backward's products, summed in two orders);
the tiny UNet within relative L2 1e-3 of the JAX int8 UNet and within a
tenth of the JAX int8 UNet's distance from its exact one, so that one
layer routed otherwise would show; the 3-step loop's latents at the
repo's loop bound, atol 1e-3 (test_unet_parity.py).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hcpdiff_tpu.diffusion import samplers as jsamplers
from hcpdiff_tpu.diffusion.schedules import NoiseSchedule as JSchedule
from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu.ops import int8 as jint8
from hcpdiff_tpu_torch.ckpt.bridge import load_params
from hcpdiff_tpu_torch.diffusion import samplers as tsamplers
from hcpdiff_tpu_torch.infer import pipeline as tpipe
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.ops import int8 as tint8
from tests.torch_port_common import random_params, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL = 1e-5
UNET_REL_L2 = 1e-3
LOOP_ATOL = 1e-3
STEPS, GUIDANCE = 3, 7.5
PALLAS_SWITCHES = ('HCP_PALLAS_CONV', 'HCP_PALLAS_LN', 'HCP_PALLAS_PROJ', 'HCP_PALLAS_FORCE')
DTYPES = {'fp32': (jnp.float32, torch.float32, 23), 'bf16': (jnp.bfloat16, torch.bfloat16, 7)}


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _within_ulp(out, ref, mantissa_bits):
    """|out - ref| <= one ulp of ref in a type of ``mantissa_bits``."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    _, e = np.frexp(np.maximum(np.abs(ref), 2.0 ** -126))
    ulp = 2.0 ** (e - 1 - mantissa_bits)
    return np.abs(out - ref) <= ulp


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('K', [24, 320])
def test_quantize_rows_matches_jax(dtype, K):
    """Codes and scales bitwise against ``_quant_rows`` on an activation
    (a row of zeros among them) and against ``_quant_cols`` on a [K, N]
    kernel, whose columns are the port's weight rows."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(K)
    x = _np(rng, 40, K, scale=3.0)
    x[7] = 0.0
    x[11, 3] = 1e4                  # one outlier row
    jq, js = jint8._quant_rows(jnp.asarray(x).astype(jdt))
    tq, ts = tint8.quantize_rows_plain(_t(x).to(tdt))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and int(tq.min()) >= -127
    w = _np(rng, K, 48, scale=K ** -0.5)
    jq, js = jint8._quant_cols(jnp.asarray(w))
    tq, ts = tint8.quantize_rows_plain(_t(w.T))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).T)
    # the CPU wrapper is the plain version
    q2, s2 = tint8.quantize_rows(_t(w.T))
    assert torch.equal(q2, tq) and torch.equal(s2, ts)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('bias,res', [(False, False), (True, False), (False, True),
                                      (True, True)])
@pytest.mark.parametrize('K', [24, 64])
def test_int8_dense_matches_jax(dtype, bias, res, K):
    """x [3, 5, K] with lead dims and a row of zeros, fp32 weights and bias
    (as the JAX model's params), the residual in x's dtype."""
    jdt, tdt, bits = DTYPES[dtype]
    rng = np.random.default_rng(K + 2 * bias + res)
    x = _np(rng, 3, 5, K)
    x[1, 2] = 0.0
    w = _np(rng, K, 32, scale=K ** -0.5)
    b = _np(rng, 32, scale=0.1) if bias else None
    r = _np(rng, 3, 5, 32) if res else None
    with jax.disable_jit():
        ref = jint8.int8_dense(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                               None if b is None else jnp.asarray(b),
                               None if r is None else jnp.asarray(r).astype(jdt))
    out = tint8.int8_dense(_t(x).to(tdt), _t(w.T), None if b is None else _t(b),
                           None if r is None else _t(r).to(tdt))
    assert out.dtype == tdt and out.shape == (3, 5, 32)
    ref = np.asarray(ref.astype(jnp.float32))
    assert _within_ulp(out.float().numpy(), ref, bits).all()
    # the row of zeros gives zero codes: only the bias and residual remain
    expect = (0 if b is None else _t(b).to(tdt)) + (0 if r is None else _t(r[1, 2]).to(tdt))
    assert torch.equal(out[1, 2], torch.zeros(32, dtype=tdt) + expect)


def test_int8_dense_grads_match_jax_grad():
    """Straight-through gradients of x, w, bias and residual against
    ``jax.grad`` of the JAX ``int8_dense`` (fp32), for a seeded cotangent."""
    rng = np.random.default_rng(7)
    x, w, b, r = _np(rng, 2, 6, 40), _np(rng, 40, 24, scale=0.2), _np(rng, 24), _np(rng, 2, 6, 24)
    cot = _np(rng, 2, 6, 24)

    def loss(x, w, b, r):
        return jnp.sum(jint8.int8_dense(x, w, b, res=r) * cot)
    with jax.disable_jit():
        refs = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, w, b, r)))
    ins = [_t(a).requires_grad_(True) for a in (x, w.T, b, r)]
    tint8.int8_dense(*ins).backward(_t(cot))
    for got, ref, name in zip([i.grad for i in ins], refs, 'x w b res'.split()):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref.T if name == 'w' else ref, rtol=GRAD_RTOL,
                                   atol=1e-6, err_msg=name)


# ------------------------------------------------------------------ the UNet

@pytest.fixture(scope='module')
def unet_case():
    cfg = junet.UNetConfig.tiny()
    jm = junet.UNet2DCondition(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(44)
    x = _np(rng, 2, 8, 8, 4)
    ctx = _np(rng, 2, 77, cfg.cross_attention_dim)
    t = np.array([40, 700])
    params = random_params(jm, jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                           jnp.zeros((1, 77, cfg.cross_attention_dim)), seed=45)
    return jm, params, x, t, ctx


class _CodeBridge:
    """JAX's activation codes, recorded in call order under ``jit``
    (ordered ``jax.debug.callback``), replace the port's own: each int8
    layer quantizes x with ``quantize_rows_plain`` and takes w's codes
    from ``weight_codes``, served here uncached by the unpatched quantizer;
    the x codes the port computed must be within one step of JAX's (module
    docstring), their scales within an ulp or two (XLA multiplies by 1/127
    under ``jit``)."""

    def __init__(self, monkeypatch):
        self.rec, self.flips, self.codes = [], 0, 0
        jax_quant, port_quant = jint8._quant_rows, tint8.quantize_rows_plain

        def recorded(x2):
            q, s = jax_quant(x2)
            jax.debug.callback(lambda q, s: self.rec.append((np.asarray(q), np.asarray(s))),
                               q, s, ordered=True)
            return q, s

        def bridged(x2):
            q, s = port_quant(x2)
            assert self.rec, 'the port quantized more activations than JAX'
            jq, js = self.rec.pop(0)
            assert jq.shape == tuple(q.shape)
            diff = np.abs(q.numpy().astype(np.int32) - jq)
            assert diff.max() <= 1
            np.testing.assert_allclose(s.numpy(), js, rtol=1e-5)
            self.flips += int((diff > 0).sum())
            self.codes += diff.size
            return torch.from_numpy(jq.copy()), torch.from_numpy(js.copy())
        monkeypatch.setattr(jint8, '_quant_rows', recorded)
        monkeypatch.setattr(tint8, 'quantize_rows_plain', bridged)
        monkeypatch.setattr(tint8, 'weight_codes', port_quant)

    def check_all_taken(self):
        assert not self.rec, f'{len(self.rec)} JAX activations the port did not quantize'
        assert self.codes and self.flips <= 1e-3 * self.codes, (self.flips, self.codes)


def _jax_unet(case, monkeypatch, int8, fused):
    jm, params, x, t, ctx = case
    with monkeypatch.context() as m:
        m.setenv('HCP_INT8', '1' if int8 else '0')
        m.setenv('HCP_PALLAS_FF', '0')
        for k in PALLAS_SWITCHES:
            m.setenv(k, '1' if fused else '0')
        with pltpu.force_tpu_interpret_mode():
            out = np.asarray(jax.jit(jm.apply)({'params': params}, x, t, ctx))
        jax.effects_barrier()
        return out


@pytest.mark.parametrize('fused', [False, True], ids=['default', 'fused'])
def test_int8_unet_matches_jax(unet_case, monkeypatch, fused):
    """The tiny UNet bridged from one JAX tree: the port's int8=True against
    the JAX UNet under HCP_INT8=1 (HCP_PALLAS_FF=0; fused: the
    HCP_PALLAS_LN/PROJ/CONV route in interpret mode, as
    test_torch_port_fused.py drives it), through the code bridge."""
    _, params, x, t, ctx = unet_case
    bridge = _CodeBridge(monkeypatch)
    ref = _jax_unet(unet_case, monkeypatch, True, fused)
    # the exact UNet of the default route: the fused one computes the same
    # function (test_torch_port_fused.py), at twice this test's time
    exact = _jax_unet(unet_case, monkeypatch, False, False)
    tm = load_params(tunet.UNet2DCondition(tunet.UNetConfig.tiny(), fused_sublayers=fused,
                                           int8=True), params)
    with torch.no_grad():
        out = tm(_t(x), _t(t), _t(ctx)).numpy()
    bridge.check_all_taken()
    err, gap = _rel(out, ref), _rel(exact, ref)
    assert err <= UNET_REL_L2 and err <= 0.1 * gap, (err, gap)


def test_int8_flag_reads_env_and_keeps_the_state_dict(monkeypatch):
    """None reads HCP_INT8 when the UNet is built; the parameters (names,
    shapes) are the same with int8 on and off, so one state dict loads into
    both."""
    cfg = tunet.UNetConfig.tiny()
    monkeypatch.setenv('HCP_INT8', '1')
    on = tunet.UNet2DCondition(cfg)
    monkeypatch.setenv('HCP_INT8', '0')
    off = tunet.UNet2DCondition(cfg)
    assert on.int8 and not off.int8 and tunet.UNet2DCondition(cfg, int8=True).int8
    monkeypatch.setenv('HCP_INT8', '1')
    assert off.int8 is False               # read once, at construction
    sd_on, sd_off = on.state_dict(), off.state_dict()
    assert [(k, v.shape) for k, v in sd_on.items()] == [(k, v.shape) for k, v in sd_off.items()]
    off.load_state_dict(sd_on, strict=True)


ROUTED = ('int8_dense', 'int8_geglu_dense', 'fused_dense', 'geglu_dense', 'ln_qkv', 'ln_dense',
          'ln_geglu')


def _routes(monkeypatch, unet, *args):
    """{layer name: wrapper} for each weight a counted wrapper received in
    one forward, and the plain nn.Linear layers (the q/k/v of the fused
    cross-attention) under 'linear'."""
    names = {p.data_ptr(): n.rsplit('.', 1)[0] for n, p in unet.named_parameters()
             if n.endswith('weight')}
    seen = {}
    for name in ROUTED:
        fn = getattr(tunet, name)

        def counted(x, *a, _fn=fn, _name=name, **kw):
            for t in a:
                if isinstance(t, torch.Tensor) and t.data_ptr() in names and t.dim() == 2:
                    seen.setdefault(names[t.data_ptr()], []).append(_name)
            return _fn(x, *a, **kw)
        monkeypatch.setattr(tunet, name, counted)
    for n, m in unet.named_modules():
        if isinstance(m, torch.nn.Linear) and 'transformer_blocks' in n:
            m.register_forward_hook(lambda mod, i, o, n=n: seen.setdefault(n, []).append('linear'))
    with torch.no_grad():
        unet(*args)
    return {k: v for k, v in seen.items() if '_attn' in k}


def _expect(route):
    """Each transformer layer's wrapper by route, as the JAX model's
    precedence gives it (unet.py:278-283, :343-398, :449-472, :564-592)."""
    q = {'default': 'int8_dense', 'fused': None, 'bias': 'linear', 'tp': None}[route]
    attn = {'default': 'int8_dense', 'fused': 'int8_dense', 'bias': 'int8_dense',
            'tp': None}[route]
    ff = {'default': ['int8_geglu_dense', 'int8_dense'], 'fused': ['ln_geglu', 'fused_dense'],
          'bias': ['int8_geglu_dense', 'int8_dense'], 'tp': [None, None]}[route]
    out = {'proj_in': 'int8_dense', 'proj_out': 'int8_dense',
           'transformer_blocks_0.ff.proj': ff[0], 'transformer_blocks_0.ff.out': ff[1]}
    for a in ('attn1', 'attn2'):
        for p in ('to_q', 'to_k', 'to_v'):
            fused = {'attn1': 'ln_qkv', 'attn2': 'ln_dense' if p == 'to_q' else 'linear'}[a]
            out[f'transformer_blocks_0.{a}.{p}'] = fused if route == 'fused' else q
        out[f'transformer_blocks_0.{a}.to_out'] = attn
    return {k: v for k, v in out.items() if v is not None}


@pytest.mark.parametrize('route', ['default', 'fused', 'bias', 'tp'])
def test_int8_routing_follows_jax_precedence(monkeypatch, route):
    """Which wrapper each transformer weight goes through in one forward of
    the tiny int8 UNet: default (B and C never), fused (G/I/H + C keep
    their routes, to_out, proj_in and proj_out int8), q/k/v with biases
    (plain products) and tp=2 (``_tp_call``: only proj_in/proj_out int8)."""
    cfg = tunet.UNetConfig.tiny(qkv_bias=route == 'bias', tp=2 if route == 'tp' else 1)
    unet = tunet.UNet2DCondition(cfg, fused_sublayers=route == 'fused', int8=True).eval()
    for m in unet.modules():
        if hasattr(m, 'tp_bind'):
            m.tp_bind = (None, 0)      # no group: this member's partial sums
    rng = np.random.default_rng(3)
    seen = _routes(monkeypatch, unet, _t(_np(rng, 1, 8, 8, 4)), torch.tensor([10]),
                   _t(_np(rng, 1, 7, 32)))
    want = _expect(route)
    assert len({k.split('.')[0] for k in seen}) == 4       # the tiny UNet's 4 transformers
    for layer, wrappers in seen.items():
        local = layer.split('.', 1)[1]
        assert local in want and wrappers == [want[local]], (layer, wrappers)
    for t2d in {k.split('.')[0] for k in seen}:
        assert {k.split('.', 1)[1] for k in seen if k.startswith(t2d + '.')} == set(want)


# ------------------------------------------------------------------ the loop

def test_int8_txt2img_matches_jax_denoise_loop(unet_case, monkeypatch):
    """3 DPM++ 2M CFG steps of the tiny UNet under HCP_INT8=1 in both
    packages, fed the same latents and context: the JAX loop body written
    out, as test_torch_port_pipeline.py writes it, against the port's
    ``DenoiseLoop``, every step's latents, through the code bridge."""
    jm, params, _, _, _ = unet_case
    rng = np.random.default_rng(9)
    lat0 = _np(rng, 1, 8, 8, 4)
    ctx = _np(rng, 2, 77, 32)
    monkeypatch.setenv('HCP_INT8', '1')
    monkeypatch.setenv('HCP_PALLAS_FF', '0')
    bridge = _CodeBridge(monkeypatch)
    tm = load_params(tunet.UNet2DCondition(tunet.UNetConfig.tiny()), params)
    assert tm.int8
    tloop = tpipe.DenoiseLoop(tm, tsamplers.make_sampler('dpm++_2m', tpipe.NoiseSchedule.make(),
                                                         STEPS))
    jsampler = jsamplers.make_sampler('dpm++_2m', JSchedule.make(), STEPS)
    jx = jnp.asarray(lat0) * jsampler.init_noise_sigma
    jst = jsampler.init_state(jx.shape)
    tx = _t(lat0) * tloop.sampler.init_noise_sigma
    tst = tloop.sampler.init_state(tx.shape)
    japply = jax.jit(lambda x, t: jm.apply({'params': params}, x, t, jnp.asarray(ctx)))
    for i in range(STEPS):
        x_in = jsampler.scale_model_input(jst, jx, i)
        out = japply(jnp.concatenate([x_in, x_in]), jnp.full((2,), jsampler.timesteps[i]))
        jax.effects_barrier()
        e_neg, e_pos = jnp.split(out, 2)
        jx, jst, _ = jsampler.step(jst, e_neg + GUIDANCE * (e_pos - e_neg), jnp.asarray(i), jx)
        with torch.no_grad():
            tx, tst, _ = tloop.step(i, tx, tst, _t(ctx), GUIDANCE)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=LOOP_ATOL, err_msg=f'step {i}')
    bridge.check_all_taken()


def test_main_runs_int8_and_imports_no_jax(tmp_path, monkeypatch):
    """``python -m hcpdiff_tpu_torch.visualizer``'s main() on the tiny world
    under HCP_INT8=1 in a fresh process: no jax or hcpdiff_tpu module
    loaded, the UNet built int8, and the images those of main() in this
    process under HCP_INT8=1, not those without it."""
    from hcpdiff_tpu_torch.visualizer import main
    args = ['--cfg', os.path.join(ROOT, 'cfgs', 'infer', 'text2img.yaml'),
            'pretrained_model=tiny', 'device=cpu', 'dtype=fp32', 'infer_args.width=32',
            'infer_args.height=32', 'infer_args.inference_steps=3', 'bs=1', 'seed=5']
    code = ('import sys\nimport numpy as np\n'
            'from hcpdiff_tpu_torch.visualizer import main\n'
            'viser, imgs = main(sys.argv[1:])\n'
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'hcpdiff_tpu'))\n"
            "np.save(sys.argv[-1].split('=', 1)[1] + '/imgs.npy', imgs)\n"
            "print(bad, viser.pipe.unet.int8)\n")
    sub = tmp_path / 'sub'
    env = dict(os.environ, PYTHONPATH=ROOT, HCP_INT8='1')
    res = subprocess.run([sys.executable, '-c', code, *args, f'interface.0.save_root={sub}'],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == '[] True'
    imgs = np.load(sub / 'imgs.npy')
    monkeypatch.setenv('HCP_INT8', '1')
    viser, same = main([*args, f'interface.0.save_root={tmp_path / "a"}'])
    assert viser.pipe.unet.int8
    np.testing.assert_array_equal(same, imgs)
    monkeypatch.setenv('HCP_INT8', '0')
    _, exact = main([*args, f'interface.0.save_root={tmp_path / "b"}'])
    assert np.isfinite(imgs).all() and not np.array_equal(exact, imgs)


def test_quality_tool_metrics_and_turns():
    """``tools/int8_quality.py``: its psnr and ssim give
    tools_dev/deepcache_quality.py's values, and ``compare`` answers the
    same request through a bf16 and an int8 copy of the tiny UNet, the
    int8 images finite and apart from the bf16 ones."""
    import importlib.util

    from hcpdiff_tpu_torch.infer.pipeline import DiffusionPipeline
    from hcpdiff_tpu_torch.models.factory import build_models
    from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend
    from hcpdiff_tpu_torch.tools import int8_quality as q
    spec = importlib.util.spec_from_file_location(
        'deepcache_quality', os.path.join(ROOT, 'tools_dev', 'deepcache_quality.py'))
    dq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dq)
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for kw in ({}, {'data_range': 1.0}):
        assert q.psnr(a, b, **kw) == dq.psnr(a, b, **kw)
        assert q.ssim(a, b, **kw) == dq.ssim(a, b, **kw)
    world = build_models('tiny', torch.float32, 'cpu')
    unet = world['unet']
    int8 = tunet.UNet2DCondition(unet.cfg, int8=True).eval()
    int8.load_state_dict(unet.state_dict())
    te = TextEncoderFrontend(world['tokenizer'], world['te'])
    pipes = {'bf16': DiffusionPipeline(unet, world['vae'], te),
             'int8': DiffusionPipeline(int8, world['vae'], te)}
    res = q.compare(pipes, batch=1, size=32, steps=2, pairs=2)
    assert len(res['bf16']['seconds']) == len(res['int8']['seconds']) == 2
    img = res['int8']['images']
    assert img.shape == (1, 32, 32, 3) and np.isfinite(img).all()
    assert 0 < res['int8']['psnr_db'] < float('inf') and -1 < res['int8']['ssim'] < 1


def test_kernel_tiles_match_the_source():
    """``ops/int8.py``'s tile (L_BM, L_BN, L_BK, L_STAGES) is
    csrc/int8_gemm.cu's, whose shared memory (ring, accumulator buffer,
    staged parameters, mbarriers) fits a block and whose wgmma width has a
    ``Wgmma8`` instance; ``l_plan`` gives a persistent block an SM, fewer
    where there are fewer tiles; ``tools/time_int8.int8_shapes`` is every
    int8 product of an SD1.5 batch-4 request: 4 a level, the mid block's
    k/v shared with level 2's."""
    import re

    from hcpdiff_tpu_torch.tools.time_int8 import int8_shapes
    src = open(os.path.join(ROOT, 'hcpdiff_tpu_torch', 'csrc', 'int8_gemm.cu')).read()
    wgmma = open(os.path.join(ROOT, 'hcpdiff_tpu_torch', 'csrc', 'wgmma.cuh')).read()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))
    BM, BN, BK, STAGES = (const(n) for n in ('BM', 'BN', 'BK', 'STAGES'))
    assert (BM, BN, BK, STAGES) == (tint8.L_BM, tint8.L_BN, tint8.L_BK, tint8.L_STAGES)
    assert f'struct Wgmma8<{BN}>' in wgmma and BM == 2 * 64 and BK == 128
    epi = const('EPI_THREADS')
    assert 256 + epi + 32 == 512 and epi >= BN and epi % 32 == 0
    stage = (BM + BN) * BK
    assert stage % 1024 == 0 and BN // 2 * BK % 1024 == 0   # the swizzle's period
    smem = STAGES * stage + BM * BN * 4 + (BM + 2 * BN) * 4 + (2 * STAGES + 2) * 8 + 1024
    assert smem <= 232448
    shapes = int8_shapes(4)
    assert len(shapes) == 15 and (616, 768, 1280, 'none') in shapes
    assert (32768, 320, 2560, 'bias') in shapes and (512, 5120, 1280, 'bias+res') in shapes
    assert all(tint8.padded_k(K) % 32 == 0 and N % 2 == 0 for _, K, N, _ in shapes)
    for M, K, N, epi_kind in shapes:
        for geglu in ((False, True) if epi_kind == 'bias' else (False,)):
            cols, nout = (BN // 2, N // 2) if geglu else (BN, N)
            tiles = -(-M // BM) * -(-nout // cols)
            assert tint8.l_tiles(M, N, geglu) == tiles
            assert tint8.l_plan(M, N, geglu) == min(tiles, 132)
    assert tint8.l_plan(32768, 2560) == tint8.l_plan(32768, 2560, True) == 132
    assert tint8.l_plan(616, 320) == 10 and tint8.l_plan(512, 1280) == 32
