"""The PyTorch port's serving slice (schedule, DPM++ 2M, CFG denoise loop,
VAE decode, txt2img) against the JAX package's, at tiny widths in fp32 on
the CPU. Both start from the same numpy latents; per-step latents and the
image are held to atol 1e-3, the repo's loop bound (test_unet_parity.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.diffusion import samplers as jsamplers
from hcpdiff_tpu.diffusion.schedules import NoiseSchedule as JSchedule
from hcpdiff_tpu.infer import pipeline as jpipe
from hcpdiff_tpu.models import clip as jclip
from hcpdiff_tpu.models import text_frontend as jtf
from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu.models import vae as jvae
from hcpdiff_tpu.utils.clip_tokenizer import CLIPTokenizer
from hcpdiff_tpu_torch.ckpt.bridge import load_params
from hcpdiff_tpu_torch.diffusion import samplers as tsamplers
from hcpdiff_tpu_torch.diffusion.schedules import NoiseSchedule as TSchedule
from hcpdiff_tpu_torch.infer import pipeline as tpipe
from hcpdiff_tpu_torch.models import clip as tclip
from hcpdiff_tpu_torch.models import text_frontend as ttf
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.models import vae as tvae
from tests.torch_port_common import random_params

STEPS, GUIDANCE = 4, 7.5


@pytest.mark.parametrize('kw', [{}, {'beta_schedule': 'linear', 'zero_terminal_snr': True},
                                {'beta_schedule': 'squaredcos_cap_v2'}])
def test_schedule_matches_jax(kw):
    j, t = JSchedule.make(**kw), TSchedule.make(**kw)
    np.testing.assert_array_equal(t.alphas_cumprod, np.asarray(j.alphas_cumprod))
    np.testing.assert_array_equal(t.betas, np.asarray(j.betas))


@pytest.mark.parametrize('kw', [{}, {'use_karras_sigmas': True}])
def test_dpmpp_2m_plan_matches_jax(kw):
    js = jsamplers.make_sampler('dpm++_2m', JSchedule.make(), 20, **kw)
    ts = tsamplers.make_sampler('dpmpp_2m', TSchedule.make(), 20, **kw)
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    np.testing.assert_allclose(ts.sigmas, np.asarray(js.sigmas), rtol=1e-6)
    assert ts.init_noise_sigma == pytest.approx(js.init_noise_sigma, rel=1e-6)


def test_make_sampler_rejects_unported():
    with pytest.raises(NotImplementedError, match='pndm'):
        tsamplers.make_sampler('pndm', TSchedule.make(), 10)


@pytest.fixture(scope='module')
def slice_pair():
    """Tiny CLIP + UNet + VAE in both packages, same weights."""
    tk = CLIPTokenizer.tiny(words=('a', 'cat', 'photo', 'of'))
    ids = dict(bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    jc = jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny(**ids))
    cp = random_params(jc, jnp.zeros((1, 77), jnp.int32), seed=0)
    ucfg = junet.UNetConfig.tiny()
    ju = junet.UNet2DCondition(ucfg, dtype=jnp.float32)
    up = random_params(ju, jnp.zeros((1, 8, 8, 4)), jnp.array([0]), jnp.zeros((1, 77, 32)),
                       seed=1)
    jv = jvae.AutoencoderKL(jvae.VAEConfig.tiny(), dtype=jnp.float32)
    vp = random_params(jv, jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0), seed=2)
    jax_side = dict(te=jtf.TextEncoderFrontend(tk, jc, cp), unet=ju, unet_params=up,
                    vae=jv, vae_params=vp)

    tc = load_params(tclip.CLIPTextModel(
        dataclasses.replace(tclip.CLIPTextConfig.tiny(), **ids)), cp)
    tu = load_params(tunet.UNet2DCondition(tunet.UNetConfig.tiny()), up)
    tv = load_params(tvae.AutoencoderKL(tvae.VAEConfig.tiny()), vp)
    pipe = tpipe.DiffusionPipeline(tu, tv, ttf.TextEncoderFrontend(tk, tc))
    return jax_side, pipe


def test_denoise_slice_matches_jax(slice_pair):
    """Prompt -> CLIP -> 4 DPM++ 2M CFG steps -> VAE decode, both packages."""
    js, pipe = slice_pair
    prompts, negs = ['a photo of a cat', 'a {cat:1.2}'], ['', 'photo']
    lat0 = np.random.default_rng(3).standard_normal((2, 8, 8, 4)).astype(np.float32)

    jctx, _ = js['te'].encode(negs + prompts)
    tctx, _ = pipe.encode_prompts(prompts, negs)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=1e-5)

    # per-step latents: the JAX loop body written out, against the port loop's step
    jsampler = jsamplers.make_sampler('dpm++_2m', JSchedule.make(), STEPS)
    japply = jax.jit(lambda x, t: js['unet'].apply({'params': js['unet_params']}, x, t, jctx))
    tloop = tpipe.DenoiseLoop(pipe.unet, tsamplers.make_sampler('dpm++_2m', pipe.schedule,
                                                                STEPS))
    jx = jnp.asarray(lat0) * jsampler.init_noise_sigma
    jst = jsampler.init_state(jx.shape)
    tx = torch.from_numpy(lat0) * tloop.sampler.init_noise_sigma
    tst = tloop.sampler.init_state(tx.shape)
    for i in range(STEPS):
        x_in = jsampler.scale_model_input(jst, jx, i)
        out = japply(jnp.concatenate([x_in, x_in]), jnp.full((4,), jsampler.timesteps[i]))
        e_neg, e_pos = jnp.split(out, 2)
        jx, jst, _ = jsampler.step(jst, e_neg + GUIDANCE * (e_pos - e_neg), jnp.asarray(i), jx)
        with torch.no_grad():
            tx, tst, _ = tloop.step(i, tx, tst, tctx, GUIDANCE)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-3, err_msg=f'step {i}')

    # the loops as a whole, x0 history included
    jloop = jpipe.DenoiseLoop(lambda p, x, t, c: js['unet'].apply({'params': p}, x, t, c),
                              jsamplers.make_sampler('dpm++_2m', JSchedule.make(), STEPS),
                              return_x0_every=1)
    jlat, jx0s = jloop(js['unet_params'], jnp.asarray(lat0), jctx, jax.random.PRNGKey(0),
                       GUIDANCE)
    tloop.return_x0 = True
    tlat, tx0s = tloop(torch.from_numpy(lat0), tctx, GUIDANCE)
    np.testing.assert_allclose(tx0s.numpy(), np.asarray(jx0s), atol=1e-3)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-3)

    scale = js['vae'].cfg.scaling_factor
    jraw = np.asarray(js['vae'].apply({'params': js['vae_params']}, jlat / scale,
                                      method='decode'))
    with torch.no_grad():
        traw = pipe.vae.decode(tlat / scale)
    np.testing.assert_allclose(traw.numpy(), jraw, atol=1e-3)
    timg = pipe.decode(tlat)
    assert timg.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(timg, np.clip(jraw * 0.5 + 0.5, 0, 1), atol=1e-3)


def test_txt2img_runs_and_is_deterministic(slice_pair):
    _, pipe = slice_pair
    kw = dict(width=16, height=16, num_steps=3, guidance_scale=5.0, batch_size=2)
    a = pipe.txt2img('a photo of a cat', seed=7, **kw)
    b = pipe.txt2img('a photo of a cat', seed=7, **kw)
    c = pipe.txt2img('a photo of a cat', seed=8, **kw)
    assert a.shape == (2, 16, 16, 3) and a.dtype == np.float32
    assert np.isfinite(a).all() and a.min() >= 0.0 and a.max() <= 1.0
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0
    lat = pipe.txt2img('a photo of a cat', seed=7, return_latents=True, guidance_scale=1.0,
                       width=16, height=16, num_steps=2)
    assert lat.shape == (1, 8, 8, 4) and torch.isfinite(lat).all()
