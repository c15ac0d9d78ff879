"""DeepCache and the encoder attention mask in the port against the JAX
package, at tiny widths in fp32 on the CPU (mirroring
``tests/test_deepcache.py``).

- the UNet's DeepCache protocol: ``return_deep`` (the feature entering
  the last up level) and ``deep_cache`` (down level 0 and the last up
  level around the cached feature) against the JAX UNet, at SD1.5-like and
  SDXL-like tiny widths, atol 1e-4 (the model bound of
  ``test_torch_port_visualizer.py``); splicing the feature just computed
  gives the full output;
- ``DenoiseLoop`` at DeepCache intervals 2 and 3 (and the exact loop with
  a padding mask) against the JAX loop from the same numpy latents: final
  latents at atol 1e-3 (the repo's loop bound);
- the refusals: DeepCache with DreamArtist's negative branch and with
  ControlNet residual taps raise ``ValueError``, and the Visualizer drops
  DeepCache with a warning beside a negative branch;
- ``TextEncoderFrontend.attention_mask`` against JAX's (``n_repeats`` 1
  and 2), the masked UNet and the UNet with ControlNet's residual taps
  against the JAX UNet, and masked and DeepCache requests through
  ``main()`` on ``device=cpu dtype=fp32``.
"""
import logging
import os

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
from hcpdiff_tpu.utils.clip_tokenizer import CLIPTokenizer as JTokenizer
from hcpdiff_tpu_torch.ckpt.bridge import load_params
from hcpdiff_tpu_torch.diffusion import samplers as tsamplers
from hcpdiff_tpu_torch.diffusion.schedules import NoiseSchedule as TSchedule
from hcpdiff_tpu_torch.infer import pipeline as tpipe
from hcpdiff_tpu_torch.infer.visualizer import main
from hcpdiff_tpu_torch.models import clip as tclip
from hcpdiff_tpu_torch.models import factory as tfactory
from hcpdiff_tpu_torch.models import text_frontend as ttf
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.tools.random_diffusers import write_module
from hcpdiff_tpu_torch.utils.clip_tokenizer import CLIPTokenizer as TTokenizer
from tests.test_torch_port_trainer import one_torch_thread
from tests.torch_port_common import random_params

__all__ = ['one_torch_thread']               # a fixture shared with the trainer file
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_MODEL, ATOL_LOOP = 1e-4, 1e-3
STEPS, GUIDANCE = 6, 7.5
WORDS = ('a', 'cat', 'photo', 'of', 'dog')
CPU = ['device=cpu', 'dtype=fp32', 'infer_args.width=32', 'infer_args.height=32',
       'infer_args.inference_steps=4', 'bs=2', 'seed=5']


def _unets(kind):
    """(JAX UNet, its params, the port's UNet on them, extra kwargs)."""
    if kind == 'sdxl':
        jcfg, tcfg = junet.UNetConfig.tiny_sdxl(), tunet.UNetConfig.tiny_sdxl()
        pooled = jcfg.projection_class_embeddings_input_dim - 6 * jcfg.addition_time_embed_dim
        rng = np.random.default_rng(70)
        extra = {'pooled_text_emb': rng.standard_normal((2, pooled)).astype(np.float32),
                 'time_ids': np.array([[32.0, 32, 0, 0, 32, 32]] * 2, np.float32)}
    else:
        jcfg, tcfg, extra = junet.UNetConfig.tiny(), tunet.UNetConfig.tiny(), {}
    jm = junet.UNet2DCondition(jcfg, dtype=jnp.float32)
    init = {k: jnp.asarray(v[:1]) for k, v in extra.items()}
    params = random_params(jm, jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                           jnp.zeros((1, 77, jcfg.cross_attention_dim)), seed=71, **init)
    return jm, params, load_params(tunet.UNet2DCondition(tcfg), params).eval(), extra


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize('kind', ['sd15', 'sdxl'])
def test_deep_feature_and_reuse_match_jax(kind):
    jm, params, tm, extra = _unets(kind)
    rng = np.random.default_rng(72)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([999, 20])
    ctx = rng.standard_normal((2, 77, tm.cfg.cross_attention_dim)).astype(np.float32)
    apply = jax.jit(lambda p, *a, **k: jm.apply({'params': p}, *a, **k),
                    static_argnames=('return_deep',))
    jout, jdeep = apply(params, x, t, ctx, return_deep=True, **extra)
    # the cache is reused at another timestep and input, as in the loop
    x2, t2 = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32), np.array([500, 10])
    jreuse = apply(params, x2, t2, ctx, deep_cache=jdeep, **extra)
    targs = [torch.from_numpy(a) for a in (x, t, ctx)]
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    with torch.no_grad():
        tout, tdeep = tm(*targs, return_deep=True, **textra)
        treuse = tm(torch.from_numpy(x2), torch.from_numpy(t2), targs[2],
                    deep_cache=torch.from_numpy(np.array(jdeep)), **textra)
        same = tm(*targs, deep_cache=tdeep, **textra)
    # after the level above's upsample: level 0's size, level 1's channels
    assert tdeep.shape == jdeep.shape == (2, 16, 16, tm.cfg.block_out_channels[1])
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=ATOL_MODEL)
    np.testing.assert_allclose(_np(tdeep), np.asarray(jdeep), atol=ATOL_MODEL)
    np.testing.assert_allclose(_np(treuse), np.asarray(jreuse), atol=ATOL_MODEL)
    np.testing.assert_allclose(_np(same), _np(tout), atol=1e-5)


@pytest.fixture(scope='module')
def frontends():
    """The tiny CLIP in both packages (same weights), with both tokenizers."""
    tk = JTokenizer.tiny(words=WORDS)
    ids = dict(bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    jc = jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny(**ids))
    cp = random_params(jc, jnp.zeros((1, 77), jnp.int32), seed=73)
    tc = load_params(tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny(**ids)), cp)
    return (lambda r: jtf.TextEncoderFrontend(tk, jc, cp, n_repeats=r),
            lambda r: ttf.TextEncoderFrontend(TTokenizer.tiny(words=WORDS), tc, n_repeats=r))


@pytest.mark.parametrize('repeats', [1, 2])
def test_attention_mask_matches_jax(frontends, repeats):
    jfe, tfe = frontends[0](repeats), frontends[1](repeats)
    texts = ['a photo of a cat', '', 'a dog ' * 60]      # short, empty, past one window
    jids, _ = jfe.tokenize_batch(texts)
    tids, _ = tfe.tokenize_batch(texts)
    np.testing.assert_array_equal(tids, jids)
    mask = tfe.attention_mask(tids)
    np.testing.assert_array_equal(mask, jfe.attention_mask(jids))
    hidden, _ = tfe.encode(texts)
    assert mask.shape == tuple(hidden.shape[:2]) == (3, repeats * 75 + 2)
    assert mask[1].sum() == 1 + repeats       # the empty prompt: BOS and each window's EOS
    assert 0 < mask[0].sum() < mask[2].sum()


def test_masked_unet_matches_jax(frontends):
    jm, params, tm, _ = _unets('sd15')
    jfe = frontends[0](1)
    texts = ['', 'a photo of a cat']
    ids, _ = jfe.tokenize_batch(texts)
    mask = jfe.attention_mask(ids)
    rng = np.random.default_rng(74)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    t = np.array([300, 700])
    jout = jax.jit(lambda p, *a: jm.apply({'params': p}, *a[:3], encoder_attention_mask=a[3]))(
        params, x, t, ctx, mask)
    with torch.no_grad():
        tout = tm(*(torch.from_numpy(a) for a in (x, t, ctx)),
                  encoder_attention_mask=torch.from_numpy(mask))
        free = tm(*(torch.from_numpy(a) for a in (x, t, ctx)))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=ATOL_MODEL)
    assert np.abs(_np(tout) - _np(free)).max() > 1e-3      # the mask took effect


def test_residual_taps_match_jax():
    """ControlNet's taps (one residual a skip, and the mid block's) as the
    JAX UNet adds them; the DeepCache protocol refuses them below."""
    jm, params, tm, _ = _unets('sd15')
    rng = np.random.default_rng(76)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    t = np.array([300, 700])
    skips = [(16, 32), (16, 32), (8, 32), (8, 64)]       # conv_in, level 0, downsample, level 1
    down = [(0.1 * rng.standard_normal((2, s, s, c))).astype(np.float32) for s, c in skips]
    mid = (0.1 * rng.standard_normal((2, 8, 8, 64))).astype(np.float32)
    jout = jax.jit(lambda p, *a: jm.apply({'params': p}, *a[:3], down_residuals=a[3],
                                          mid_residual=a[4]))(params, x, t, ctx, down, mid)
    with torch.no_grad():
        tout = tm(*(torch.from_numpy(a) for a in (x, t, ctx)),
                  down_residuals=[torch.from_numpy(d) for d in down],
                  mid_residual=torch.from_numpy(mid))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=ATOL_MODEL)


@pytest.mark.parametrize('interval, masked', [(2, False), (3, False), (0, True)])
def test_denoise_loop_matches_jax(frontends, interval, masked):
    jm, params, tm, _ = _unets('sd15')
    jfe, tfe = frontends[0](1), frontends[1](1)
    texts = ['', 'blurry', 'a photo of a cat', 'a dog']          # negatives, then prompts
    jctx, _ = jfe.encode(texts)
    tctx, _ = tfe.encode(texts)
    extra = {}
    if masked:
        extra = {'encoder_attention_mask': jfe.attention_mask(jfe.tokenize_batch(texts)[0])}
    lat0 = np.random.default_rng(75).standard_normal((2, 16, 16, 4)).astype(np.float32)
    jloop = jpipe.DenoiseLoop(lambda p, x, t, c, **e: jm.apply({'params': p}, x, t, c, **e),
                              jsamplers.make_sampler('dpm++_2m', JSchedule.make(), STEPS),
                              deep_cache_interval=interval)
    jlat, _ = jloop(params, jnp.asarray(lat0), jctx, jax.random.PRNGKey(0), GUIDANCE,
                    extra_cond={k: jnp.asarray(v) for k, v in extra.items()} or None)
    tloop = tpipe.DenoiseLoop(tm, tsamplers.make_sampler('dpm++_2m', TSchedule.make(), STEPS),
                              deep_cache_interval=interval)
    calls = []
    real = tm.forward

    def counted(*a, **kw):
        calls.append('reuse' if kw.get('deep_cache') is not None else 'full')
        return real(*a, **kw)
    tm.forward = counted
    tlat, _ = tloop(torch.from_numpy(lat0), tctx, GUIDANCE,
                    extra_cond={k: torch.from_numpy(v) for k, v in extra.items()} or None)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=ATOL_LOOP)
    n_full = len(range(0, STEPS, interval)) if interval > 1 else STEPS
    assert calls.count('full') == n_full and calls.count('reuse') == STEPS - n_full
    if interval:
        exact, _ = tpipe.DenoiseLoop(tm, tloop.sampler)(torch.from_numpy(lat0), tctx, GUIDANCE)
        assert (exact - tlat).abs().max() > 1e-4         # the reuse steps changed the result


def test_deep_cache_refusals():
    _, _, tm, _ = _unets('sd15')
    sampler = tsamplers.make_sampler('ddim', TSchedule.make(), 4)
    with pytest.raises(ValueError, match='DreamArtist'):
        tpipe.DenoiseLoop(tm, sampler, unet_neg=tm, deep_cache_interval=2)
    x, ctx = torch.zeros(1, 8, 8, 4), torch.zeros(1, 77, 32)
    deep = torch.zeros(1, 8, 8, tm.cfg.block_out_channels[1])
    with torch.no_grad():
        for taps in ({'mid_residual': torch.zeros(1, 4, 4, 64)},
                     {'down_residuals': [torch.zeros(1, 8, 8, 32)] * 3}):
            with pytest.raises(ValueError, match='ControlNet'):
                tm(x, torch.tensor([0]), ctx, deep_cache=deep, **taps)


@pytest.fixture(scope='module')
def tiny_dir(tmp_path_factory):
    """The port's tiny world written as a diffusers-layout directory."""
    root = tmp_path_factory.mktemp('tiny_dir')
    world = tfactory.build_models('tiny', torch.float32, 'cpu')
    for sub, key in (('unet', 'unet'), ('vae', 'vae'), ('text_encoder', 'te')):
        write_module(world[key], str(root / sub), torch.float32)
    return str(root)


def _main(tiny_dir, tmp_path, *extra):
    out = str(tmp_path / 'out')
    return main(['--cfg', os.path.join(ROOT, 'cfgs', 'infer', 'text2img.yaml'),
                 f'pretrained_model={tiny_dir}', f'output_dir={out}',
                 f'interface.0.save_root={out}', *CPU, *extra])


def test_masked_and_deep_cache_requests_through_main(tiny_dir, tmp_path):
    viser, exact = _main(tiny_dir, tmp_path)
    assert not viser.pipe.use_encoder_attention_mask
    masked_viser, masked = _main(tiny_dir, tmp_path, 'encoder_attention_mask=true')
    assert masked_viser.pipe.use_encoder_attention_mask
    dc_viser, dc = _main(tiny_dir, tmp_path, 'infer_args.deep_cache_interval=2')
    for imgs in (exact, masked, dc):
        assert imgs.shape == (2, 32, 32, 3) and np.isfinite(imgs).all()
        assert imgs.min() >= 0 and imgs.max() <= 1
    assert np.abs(masked - exact).max() > 1e-4 and np.abs(dc - exact).max() > 1e-4
    # main()'s images are the pipeline's with the same settings
    kw = dict(width=32, height=32, num_steps=4, batch_size=2, seed=5)
    cfg = viser.cfgs
    np.testing.assert_array_equal(dc, dc_viser.pipe.txt2img(
        cfg.prompt, cfg.neg_prompt, deep_cache_interval=2, **kw))
    np.testing.assert_array_equal(masked, masked_viser.pipe.txt2img(
        cfg.prompt, cfg.neg_prompt, **kw))


def test_visualizer_drops_deep_cache_beside_a_negative_branch(tiny_dir, tmp_path, caplog):
    viser, _ = _main(tiny_dir, tmp_path, 'infer_args.deep_cache_interval=2')
    viser.pipe.unet_params_neg = {}      # a negative branch, with the UNet's own weights
    with caplog.at_level(logging.WARNING, logger='hcpdiff_tpu_torch'):
        imgs = viser.vis_images('a cat', '', seed=5)
    assert 'deep_cache_interval ignored' in caplog.text
    assert imgs.shape == (2, 32, 32, 3) and np.isfinite(imgs).all()
