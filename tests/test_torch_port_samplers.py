"""Every sampler name of the JAX table against the JAX sampler, on the CPU:
the plan (timesteps, sigmas, num_steps, init_noise_sigma) and each step's
latents and x0 on the same model outputs and the same noise (the JAX
draws fed through ``draw_noise``), at atol 1e-5 (rtol 1e-5), for whole
plans and plans cut by ``slice_for_partial``; with Karras sigmas, eta
variants, DPM++ SDE's independent draws, LMS's lower order, DEIS past its
lower-order-final rule and PNDM's RK warmup (and its refusal of a partial
plan). Then the staggered plans through ``DenoiseLoop``: one x0 an
evaluation, DeepCache's full calls at every Nth evaluation, and img2img's
cut, against the JAX loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.diffusion import samplers as jsamplers
from hcpdiff_tpu.diffusion.schedules import NoiseSchedule as JSchedule
from hcpdiff_tpu.infer import pipeline as jpipe
from hcpdiff_tpu_torch.diffusion import samplers as tsamplers
from hcpdiff_tpu_torch.diffusion.schedules import NoiseSchedule as TSchedule
from hcpdiff_tpu_torch.infer import pipeline as tpipe
from tests.torch_port_common import one_torch_thread  # noqa: F401

ATOL = RTOL = 1e-5
# whole loops (the JAX one compiled as a scan) over a toy UNet: atol/rtol 1e-4
LOOP_TOL = 1e-4
NEW = ('pndm', 'unipc', 'lms', 'deis', 'heun', 'dpm2', 'dpm2_a', 'dpm++_2s_a', 'dpm++_sde')
VARIANTS = [
    ('unipc', {'use_karras_sigmas': True}, 8),
    ('lms', {'use_karras_sigmas': True}, 8),
    ('lms', {'order': 2}, 8),
    ('deis', {'use_karras_sigmas': True}, 8),
    ('deis', {}, 16),                                   # past lower_order_final
    ('heun', {'use_karras_sigmas': True}, 8),
    ('dpm2', {'use_karras_sigmas': True}, 8),
    ('dpm2_a', {'use_karras_sigmas': True}, 8),
    ('dpm++_2s_a', {'use_karras_sigmas': True}, 8),
    ('dpm++_sde', {'use_karras_sigmas': True}, 8),
    ('dpm++_sde', {'eta': 0.0}, 8),
    ('dpm++_sde', {'eta': 0.5}, 8),
    ('dpm++_sde', {'brownian': False}, 8),
    ('pndm', {'spacing': 'linspace'}, 8),
]


def _jax_noise(js, i, key, shape):
    """The normal the JAX sampler adds at step ``i`` under ``key``: DPM++
    SDE splits the key, stage 0 taking the first half's draw and stage 1
    the second's."""
    if isinstance(js, jsamplers.DPMppSDESampler):
        key = jax.random.split(key)[int(js._plan_stage[i])]
    return torch.from_numpy(np.array(jax.random.normal(key, shape)))


def _pair(name, kw, steps):
    return (jsamplers.make_sampler(name, JSchedule.make(), steps, **kw),
            tsamplers.make_sampler(name, TSchedule.make(), steps, **kw))


def _same_plan(js, ts):
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    assert ts.num_steps == js.num_steps and ts.step_stride == js.step_stride
    assert ts.init_noise_sigma == pytest.approx(js.init_noise_sigma, rel=1e-6)
    if hasattr(js, 'sigmas'):
        np.testing.assert_allclose(ts.sigmas, np.asarray(js.sigmas), rtol=1e-6)


def _run(js, ts, monkeypatch, seed=11):
    """Step both samplers over their plans on the same model outputs and
    noise; every step's latents and x0 held to atol/rtol 1e-5."""
    rng = np.random.default_rng(seed)
    shape = (2, 4, 4, 4)
    x = rng.standard_normal(shape).astype(np.float32) * ts.init_noise_sigma
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jst, tst = js.init_state(shape), ts.init_state(shape)
    gen = torch.Generator()
    for i in range(ts.num_steps):
        out = rng.standard_normal(shape).astype(np.float32)
        key = jax.random.PRNGKey(100 + i)
        noise = _jax_noise(js, i, key, shape)
        monkeypatch.setattr(tsamplers, 'draw_noise', lambda x, g, n=noise: n.to(x.device))
        np.testing.assert_allclose(ts.scale_model_input(tst, tx, i).numpy(),
                                   np.asarray(js.scale_model_input(jst, jx, i)),
                                   atol=ATOL, rtol=RTOL)
        jx, jst, jx0 = js.step(jst, jnp.asarray(out), i, jx, key)
        tx, tst, tx0 = ts.step(tst, torch.from_numpy(out), i, tx, gen)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=RTOL,
                                   err_msg=f'step {i}')
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=ATOL, rtol=RTOL,
                                   err_msg=f'x0 {i}')
    assert np.isfinite(tx.numpy()).all()


@pytest.mark.parametrize('t_start', [0, 3])
@pytest.mark.parametrize('name', sorted(jsamplers.SAMPLERS))
def test_every_jax_sampler_name_matches(name, t_start, monkeypatch):
    js, ts = _pair(name, {}, 8)
    assert type(ts).__name__ == type(js).__name__
    assert ts.slice_for_partial(t_start) == js.slice_for_partial(t_start)
    _same_plan(js, ts)
    _run(js, ts, monkeypatch)


@pytest.mark.parametrize('t_start', [0, 2])
@pytest.mark.parametrize('name, kw, steps', VARIANTS,
                         ids=[f'{n}-{k}-{s}' for n, k, s in VARIANTS])
def test_sampler_variants_match(name, kw, steps, t_start, monkeypatch):
    js, ts = _pair(name, kw, steps)
    assert ts.slice_for_partial(t_start) == js.slice_for_partial(t_start)
    _same_plan(js, ts)
    _run(js, ts, monkeypatch, seed=12)


def test_pndm_rk_warmup_matches_and_refuses_a_partial_plan(monkeypatch):
    js, ts = _pair('pndm', {'prk_warmup': True}, 8)
    assert ts.num_steps == 8 + 9 and ts.prk_warmup
    _same_plan(js, ts)
    _run(js, ts, monkeypatch)
    js, ts = _pair('pndm', {'prk_warmup': True}, 8)
    with pytest.raises(ValueError, match='prk_warmup'):
        js.slice_for_partial(2)
    with pytest.raises(ValueError, match='prk_warmup'):
        ts.slice_for_partial(2)
    assert ts.slice_for_partial(0) == js.slice_for_partial(0)
    # under 4 steps the warmup is off in both
    assert not tsamplers.make_sampler('pndm', TSchedule.make(), 3, prk_warmup=True).prk_warmup


@pytest.mark.parametrize('pred', ['v_prediction', 'sample'])
@pytest.mark.parametrize('name', ['pndm', 'unipc', 'dpm2_a', 'dpm++_sde'])
def test_prediction_types_match(name, pred, monkeypatch):
    js = jsamplers.make_sampler(name, JSchedule.make(prediction_type=pred), 6)
    ts = tsamplers.make_sampler(name, TSchedule.make(prediction_type=pred), 6)
    _same_plan(js, ts)
    _run(js, ts, monkeypatch, seed=13)


def test_staggered_plans_and_the_rest_of_the_table():
    for name in ('heun', 'dpm2', 'dpm2_a', 'dpm++_2s_a', 'dpm++_sde'):
        ts = tsamplers.make_sampler(name, TSchedule.make(), 20)
        assert ts.num_steps == 39 and ts._plan_stage[:4] == [0, 1, 0, 1]
        assert ts._plan_stage[-1] == 0 and len(ts.sigmas) == 40
    for name in NEW:
        assert name in jsamplers.SAMPLERS
    assert sorted(tsamplers.SAMPLERS) == sorted(jsamplers.SAMPLERS)
    with pytest.raises(ValueError, match='unknown sampler'):
        tsamplers.make_sampler('plms_fancy', TSchedule.make(), 10)


# -------------------------------------------------- the loop under a plan

def _toy_unet(x, t, ctx, **extra):
    """A UNet stand-in that depends on x, t and ctx (NHWC, either package)."""
    lib = torch if isinstance(x, torch.Tensor) else jnp
    scale = (t.reshape(-1, 1, 1, 1) / 1000.0) if lib is torch else (
        jnp.reshape(t, (-1, 1, 1, 1)) / 1000.0)
    return lib.tanh(x * 0.7 + scale) * 0.9 + ctx.mean() * 0.01


@pytest.mark.parametrize('name', ['heun', 'dpm++_sde', 'pndm'])
def test_loop_over_a_staggered_plan(name):
    """DenoiseLoop runs the whole evaluation plan: one x0 an evaluation;
    DeepCache's full calls fall at every Nth evaluation; a deterministic
    run (these add no noise: Heun's and eta-0 DPM++ SDE's noise scales are
    0) equals the JAX scan."""
    kw = {'prk_warmup': True} if name == 'pndm' else {'eta': 0.0} if name == 'dpm++_sde' else {}
    ts = tsamplers.make_sampler(name, TSchedule.make(), 6, **kw)
    calls = []

    def unet(x, t, ctx, **e):
        calls.append('full' if e.get('return_deep') else 'reuse' if 'deep_cache' in e
                     else 'exact')
        out = _toy_unet(x, t, ctx)
        return (out, x) if e.get('return_deep') else out

    rng = np.random.default_rng(3)
    lat = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 3, 8)).astype(np.float32)
    out, x0s = tpipe.DenoiseLoop(unet, ts, return_x0=True)(torch.from_numpy(lat),
                                                          torch.from_numpy(ctx), 5.0)
    assert x0s.shape == (ts.num_steps, 1, 4, 4, 4) and len(calls) == ts.num_steps
    js = jsamplers.make_sampler(name, JSchedule.make(), 6, **kw)
    jloop = jpipe.DenoiseLoop(lambda p, x, t, c, **e: _toy_unet(x, t, c), js,
                              return_x0_every=1)
    jout, jx0s = jloop({}, jnp.asarray(lat), jnp.asarray(ctx), jax.random.PRNGKey(0), 5.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=LOOP_TOL, rtol=LOOP_TOL)
    np.testing.assert_allclose(x0s.numpy(), np.asarray(jx0s), atol=LOOP_TOL, rtol=LOOP_TOL)
    calls.clear()
    tpipe.DenoiseLoop(unet, tsamplers.make_sampler(name, TSchedule.make(), 6, **kw),
                      deep_cache_interval=3)(torch.from_numpy(lat), torch.from_numpy(ctx), 5.0)
    assert calls == ['full' if i % 3 == 0 else 'reuse' for i in range(ts.num_steps)]


@pytest.mark.parametrize('name', ['heun', 'dpm2', 'lms', 'unipc'])
def test_img2img_cut_matches_jax(name):
    """img2img's t_start = steps - int(steps * strength) cuts the plan as
    the JAX img2img does (a two-stage plan at a stage-0 evaluation): the
    noised timestep and the partial loop's output on the same noised
    latents, for deterministic samplers."""
    steps, strength = 10, 0.55
    t_start = max(steps - int(steps * strength), 0)
    js = jsamplers.make_sampler(name, JSchedule.make(), steps)
    ts = tsamplers.make_sampler(name, TSchedule.make(), steps)
    assert ts.slice_for_partial(t_start) == js.slice_for_partial(t_start)
    _same_plan(js, ts)
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 3, 8)).astype(np.float32)
    out, _ = tpipe.DenoiseLoop(_toy_unet, ts)(torch.from_numpy(lat), torch.from_numpy(ctx), 5.0)
    jout, _ = jpipe.DenoiseLoop(lambda p, x, t, c, **e: _toy_unet(x, t, c), js)(
        {}, jnp.asarray(lat), jnp.asarray(ctx), jax.random.PRNGKey(0), 5.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=LOOP_TOL, rtol=LOOP_TOL)
