"""The PyTorch port's SDXL path (text_time UNet, projected CLIP, the dual
text encoder, text_time conditioning in the denoise loop and txt2img)
against the JAX package's, at tiny widths in fp32 on the CPU, with the same
weights carried across by the bridge. The tiny SDXL world is
tests/test_sdxl.py's: CLIP widths 32 and 48 (the second projected to 48),
a UNet with cross_attention_dim 80 and a pooled dim of 48.

Tolerances: the UNet and per-step latents atol 1e-3 (the repo's loop bound,
test_unet_parity.py); CLIP and the text frontend atol 1e-5 (as
test_torch_port_models.py holds the SD1.5 ones).
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
from hcpdiff_tpu.models import layers as jlayers
from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu.models import vae as jvae
from hcpdiff_tpu.models.compose import sdxl_te as jsdxl
from hcpdiff_tpu.utils.clip_tokenizer import CLIPTokenizer
from hcpdiff_tpu_torch.ckpt.bridge import load_params, state_dict_from_params
from hcpdiff_tpu_torch.diffusion import samplers as tsamplers
from hcpdiff_tpu_torch.infer import pipeline as tpipe
from hcpdiff_tpu_torch.models import clip as tclip
from hcpdiff_tpu_torch.models import layers as tlayers
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.models import vae as tvae
from hcpdiff_tpu_torch.models.compose import sdxl_te as tsdxl
from tests.torch_port_common import random_params

STEPS, GUIDANCE = 4, 7.5
UNET_ATOL, LOOP_ATOL, TEXT_ATOL = 1e-3, 1e-3, 1e-5
POOLED = 48
CTX = 32 + POOLED


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unet_cfg(pkg, **kw):
    return pkg.UNetConfig.tiny_sdxl(cross_attention_dim=CTX,
                                    projection_class_embeddings_input_dim=8 * 6 + POOLED, **kw)


def _unet_pair(seed=0, **kw):
    jm = junet.UNet2DCondition(_unet_cfg(junet, **kw), dtype=jnp.float32)
    params = random_params(jm, jnp.zeros((1, 8, 8, 4)), jnp.array([0]), jnp.zeros((1, 77, CTX)),
                           pooled_text_emb=jnp.zeros((1, POOLED)), time_ids=jnp.zeros((1, 6)),
                           seed=seed)
    return jm, params, load_params(tunet.UNet2DCondition(_unet_cfg(tunet, **kw)), params)


def _unet_inputs(size, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, CTX)).astype(np.float32)
    pooled = rng.standard_normal((2, POOLED)).astype(np.float32)
    time_ids = np.stack([jsdxl.make_sdxl_time_ids((8 * size, 8 * size)),
                         jsdxl.make_sdxl_time_ids((640, 512), (16, 32), (8 * size, 8 * size))])
    return x, np.array([500, 10]), ctx, pooled, time_ids


@pytest.mark.parametrize('size,kw', [(8, {}), (32, {}), (8, {'mid_cross_attn': False})],
                         ids=['8x8', '32x32', '8x8-no-mid-attn'])
def test_tiny_sdxl_unet_matches_jax(size, kw):
    """The text_time UNet with pooled and time_ids inputs (the add-embedding
    MLP in fp32, added to the time embedding); without a mid-block
    transformer the tree and the forward both skip it."""
    jm, params, tm = _unet_pair(**kw)
    assert ('mid_attn' in params) == kw.get('mid_cross_attn', True)
    x, t, ctx, pooled, tids = _unet_inputs(size, seed=1)
    ref = np.asarray(jax.jit(lambda p, *a: jm.apply({'params': p}, *a[:3], pooled_text_emb=a[3],
                                                    time_ids=a[4]))(params, x, t, ctx, pooled,
                                                                    tids))
    with torch.no_grad():
        out = tm(_t(x), _t(t), _t(ctx), pooled_text_emb=_t(pooled), time_ids=_t(tids))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, size, size, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=UNET_ATOL)


@pytest.mark.parametrize('missing', ['pooled_text_emb', 'time_ids'])
def test_text_time_unet_needs_pooled_and_time_ids(missing):
    tm = tunet.UNet2DCondition(_unet_cfg(tunet))
    x, t, ctx, pooled, tids = (_t(a) for a in _unet_inputs(8, seed=2))
    kw = {'pooled_text_emb': pooled, 'time_ids': tids}
    del kw[missing]
    with pytest.raises(ValueError, match='pooled_text_emb and time_ids'):
        tm(x, t, ctx, **kw)


def test_compute_dtype_keeps_the_embedding_mlps_fp32():
    tm = tunet.UNet2DCondition(_unet_cfg(tunet)).to_compute_dtype(torch.bfloat16)
    for name, p in tm.named_parameters():
        fp32 = name.startswith(('time_embedding_linear_', 'add_embedding_linear_'))
        assert p.dtype == (torch.float32 if fp32 else torch.bfloat16), name


def test_unknown_addition_embed_type_raises():
    with pytest.raises(ValueError, match='not supported'):
        tunet.UNet2DCondition(tunet.UNetConfig.tiny(addition_embed_type='text'))


def _tokenizer():
    return CLIPTokenizer.tiny(words=('a', 'cat', 'photo', 'of'))


def _clip_pair(tk, seed, **kw):
    ids = dict(bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id,
               vocab_size=tk.vocab_size)
    jm = jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny(**ids, **kw))
    params = random_params(jm, jnp.zeros((1, 77), jnp.int32), seed=seed)
    return jm, params, load_params(tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny(**ids, **kw)),
                                   params)


def _big_g_like():
    return dict(hidden_size=48, hidden_act='gelu', projection_dim=POOLED)


def test_projected_clip_matches_jax():
    """bigG's shape of encoder: exact-erf gelu and a bias-free projection of
    the pooled EOS row."""
    tk = _tokenizer()
    jm, params, tm = _clip_pair(tk, seed=5, **_big_g_like())
    assert params['text_projection'].keys() == {'kernel'}
    rng = np.random.default_rng(6)
    ids = rng.integers(0, tk.vocab_size, (2, 77))
    ids[:, 20] = tk.eos_token_id
    last, pooled, _ = jax.jit(lambda p, i: jm.apply({'params': p}, i))(params, ids)
    with torch.no_grad():
        tlast, tpooled, _ = tm(_t(ids))
    assert tpooled.shape == (2, POOLED)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(last), atol=TEXT_ATOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled), atol=TEXT_ATOL)


def test_gelu_is_exact_in_both_packages():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    j = np.asarray(jlayers.ACT['gelu'](jnp.asarray(x)))
    t = tlayers.ACT['gelu'](_t(x)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)
    tanh = torch.nn.functional.gelu(_t(x), approximate='tanh').numpy()
    assert np.abs(t - tanh).max() > 1e-4


@pytest.fixture(scope='module')
def sdxl_world():
    """The tiny SDXL world in both packages, same weights."""
    tk = _tokenizer()
    j1, p1, t1 = _clip_pair(tk, seed=10, hidden_size=32)
    j2, p2, t2 = _clip_pair(tk, seed=11, **_big_g_like())
    ju, up, tu = _unet_pair(seed=12)
    jv = jvae.AutoencoderKL(jvae.VAEConfig.tiny(), dtype=jnp.float32)
    vp = random_params(jv, jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0), seed=13)
    tv = load_params(tvae.AutoencoderKL(tvae.VAEConfig.tiny()), vp)
    jfe = jsdxl.SDXLTextEncoderFrontend(tk, j1, p1, j2, p2)
    tfe = tsdxl.SDXLTextEncoderFrontend(tk, t1, t2)
    return dict(jfe=jfe, ju=ju, up=up, pipe=tpipe.DiffusionPipeline(tu, tv, tfe),
                jparts=(tk, j1, p1, j2, p2), tparts=(tk, t1, t2))


def test_sdxl_frontend_encode_matches_jax(sdxl_world):
    """Penultimate layers of both encoders (clip_skip=1, no final norm)
    joined on the feature axis, pooled from the second's projection."""
    prompts = ['a photo of a {cat:1.3}', '{a {cat}} photo']
    hidden, pooled = sdxl_world['jfe'].encode(prompts)
    thidden, tpooled = sdxl_world['pipe'].te.encode(prompts)
    assert thidden.shape == (2, 77, CTX) and tpooled.shape == (2, POOLED)
    np.testing.assert_allclose(thidden.numpy(), np.asarray(hidden), atol=TEXT_ATOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled), atol=TEXT_ATOL)
    ids, mult = sdxl_world['pipe'].te.tokenize_batch(prompts)
    jids, jmult = sdxl_world['jfe'].tokenize_batch(prompts)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mult, jmult)


@pytest.mark.parametrize('repeats, skip, final_norm', [(2, 1, False), (1, 2, False),
                                                        (1, 1, True)])
def test_sdxl_frontend_text_settings_match_jax(sdxl_world, repeats, skip, final_norm):
    """SDXL's other text settings (the Visualizer's model.tokenizer_repeats,
    clip_skip, clip_final_norm): hidden and pooled against the JAX
    frontend; two repeats give a 152-token context (two windows of 75 and
    BOS, EOS) and the first window's
    pooled row."""
    kw = dict(n_repeats=repeats, clip_skip=skip, clip_final_norm=final_norm)
    jfe = jsdxl.SDXLTextEncoderFrontend(*sdxl_world['jparts'], **kw)
    tfe = tsdxl.SDXLTextEncoderFrontend(*sdxl_world['tparts'], **kw)
    prompts = ['a photo of a {cat:1.3} ' * 12, 'photo']
    hidden, pooled = jfe.encode(prompts)
    thidden, tpooled = tfe.encode(prompts)
    assert thidden.shape == (2, 75 * repeats + 2, CTX) and tpooled.shape == (2, POOLED)
    np.testing.assert_allclose(thidden.numpy(), np.asarray(hidden), atol=TEXT_ATOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled), atol=TEXT_ATOL)
    if repeats == 1:            # the setting changes the context SDXL's defaults give
        assert not torch.equal(sdxl_world['pipe'].te.encode(prompts)[0], thidden)


def test_text_time_denoise_slice_matches_jax(sdxl_world):
    """4 DPM++ 2M CFG steps with the pooled embedding and time_ids as extra
    UNet arguments, from the same latents: per-step latents (the loops as a
    whole: the txt2img test below)."""
    w, pipe = sdxl_world, sdxl_world['pipe']
    prompts, negs = ['a photo of a cat', 'a {cat:1.2}'], ['', 'photo']
    lat0 = np.random.default_rng(3).standard_normal((2, 8, 8, 4)).astype(np.float32)
    jctx, jpooled = w['jfe'].encode(negs + prompts)
    tctx, tpooled = pipe.encode_prompts(prompts, negs)
    tids = np.tile(jsdxl.make_sdxl_time_ids((64, 64), target_size=(64, 64)), (4, 1))
    jextra = dict(pooled_text_emb=jpooled, time_ids=jnp.asarray(tids))
    textra = dict(pooled_text_emb=tpooled, time_ids=_t(tids))

    jsampler = jsamplers.make_sampler('dpm++_2m', JSchedule.make(), STEPS)
    japply = jax.jit(lambda x, t: w['ju'].apply({'params': w['up']}, x, t, jctx, **jextra))
    tloop = tpipe.DenoiseLoop(pipe.unet, tsamplers.make_sampler('dpm++_2m', pipe.schedule,
                                                                STEPS))
    jx = jnp.asarray(lat0) * jsampler.init_noise_sigma
    jst = jsampler.init_state(jx.shape)
    tx = _t(lat0) * tloop.sampler.init_noise_sigma
    tst = tloop.sampler.init_state(tx.shape)
    for i in range(STEPS):
        x_in = jsampler.scale_model_input(jst, jx, i)
        out = japply(jnp.concatenate([x_in, x_in]), jnp.full((4,), jsampler.timesteps[i]))
        e_neg, e_pos = jnp.split(out, 2)
        jx, jst, _ = jsampler.step(jst, e_neg + GUIDANCE * (e_pos - e_neg), jnp.asarray(i), jx)
        with torch.no_grad():
            tx, tst, _ = tloop.step(i, tx, tst, tctx, GUIDANCE, extra_cond=textra)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=LOOP_ATOL,
                                   err_msg=f'step {i}')


@pytest.mark.parametrize('guidance', [GUIDANCE, 1.0])
def test_txt2img_text_time_matches_the_jax_loop(sdxl_world, guidance):
    """The port's txt2img builds the JAX pipeline's conditioning: pooled
    embeddings in the context's order and time_ids [h, w, 0, 0, h, w]
    tiled to the CFG-doubled batch (to B at guidance 1). Fed the port's
    initial noise, the JAX loop gives the same final latents."""
    w, pipe = sdxl_world, sdxl_world['pipe']
    prompts, negs = ['a photo of a cat', 'a cat'], ['blurry', '']
    H, W, seed = 64, 48, 4
    cfg = guidance > 1.0
    lat0 = torch.randn((2, H // 2, W // 2, 4), generator=torch.Generator().manual_seed(seed))
    jctx, jpooled = w['jfe'].encode((negs if cfg else []) + prompts)
    tid = np.asarray([H, W, 0, 0, H, W], np.float32)
    jextra = dict(pooled_text_emb=jpooled, time_ids=jnp.tile(tid[None], (4 if cfg else 2, 1)))
    jloop = jpipe.DenoiseLoop(lambda p, x, t, c, **e: w['ju'].apply({'params': p}, x, t, c, **e),
                              jsamplers.make_sampler('dpm++_2m', JSchedule.make(), STEPS))
    jlat, _ = jloop(w['up'], jnp.asarray(lat0.numpy()), jctx, jax.random.PRNGKey(0), guidance,
                    extra_cond=jextra, cfg_batch=cfg)
    tlat = pipe.txt2img(prompts, negs, width=W, height=H, num_steps=STEPS,
                        guidance_scale=guidance, seed=seed, return_latents=True)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=LOOP_ATOL)
    img = pipe.txt2img(prompts, negs, width=W, height=H, num_steps=2, guidance_scale=guidance,
                       seed=seed)
    assert img.shape == (2, H, W, 3) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0


@pytest.mark.parametrize('cfg,text_time', [('tiny', False), ('tiny_sdxl', True)])
def test_pipeline_reads_text_time_from_the_unet(sdxl_world, cfg, text_time):
    """The pipeline passes pooled embeddings and time_ids exactly when its
    UNet's config asks for them (addition_embed_type 'text_time')."""
    unet = tunet.UNet2DCondition(getattr(tunet.UNetConfig, cfg)())
    pipe = tpipe.DiffusionPipeline(unet, sdxl_world['pipe'].vae, sdxl_world['pipe'].te)
    assert pipe.text_time is text_time


@pytest.mark.parametrize('args', [{}, {'original_size': (640, 512), 'crop_coord': (16, 32),
                                       'target_size': (1024, 768)}])
def test_time_ids_match_jax(args):
    t = tsdxl.make_sdxl_time_ids(**args)
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t, jsdxl.make_sdxl_time_ids(**args))


def test_embedding_split_and_concat_match_jax():
    v = np.random.default_rng(0).normal(size=(3, 768 + 1280)).astype(np.float32)
    parts, jparts = tsdxl.split_sdxl_embedding(v), jsdxl.split_sdxl_embedding(v)
    assert parts.keys() == jparts.keys() == {'clip_L', 'clip_bigG'}
    for k in parts:
        np.testing.assert_array_equal(parts[k], jparts[k])
    np.testing.assert_array_equal(tsdxl.concat_sdxl_embedding(parts),
                                  jsdxl.concat_sdxl_embedding(jparts))
    np.testing.assert_array_equal(tsdxl.concat_sdxl_embedding(parts), v)


@pytest.mark.parametrize('tree', ['unet', 'clip'])
def test_bridge_loads_the_sdxl_trees_strictly(tree):
    """Every name of the JAX tiny_sdxl UNet and projected CLIP trees maps
    onto the port's module and back, with the dense layouts transposed."""
    if tree == 'unet':
        _, params, module = _unet_pair()
        dense = params['add_embedding_linear_1']['kernel']
        name = 'add_embedding_linear_1.weight'
    else:
        _, params, module = _clip_pair(_tokenizer(), seed=5, **_big_g_like())
        dense = params['text_projection']['kernel']
        name = 'text_projection.weight'
    sd = state_dict_from_params(params)
    assert set(sd) == set(module.state_dict())
    np.testing.assert_array_equal(module.state_dict()[name].numpy(), dense.T)


# every config classmethod of the port and the JAX package, field by field;
# the JAX UNetConfig alone has qkv_bias, tp and tp_axis, which no ported
# path uses (they must hold their defaults there)
CONFIGS = [('unet', n) for n in ('sd15', 'sd21', 'sdxl', 'tiny', 'tiny_sdxl')] + \
    [('clip', n) for n in ('sd15', 'sd2', 'sdxl_big_g', 'tiny')] + \
    [('vae', n) for n in ('sd', 'sdxl', 'tiny')]
PACKAGES = {'unet': (junet.UNetConfig, tunet.UNetConfig),
            'clip': (jclip.CLIPTextConfig, tclip.CLIPTextConfig),
            'vae': (jvae.VAEConfig, tvae.VAEConfig)}
JAX_ONLY = {'unet': {'tp': 1, 'tp_axis': 'model'}}


@pytest.mark.parametrize('family,name', CONFIGS, ids=[f'{f}.{n}' for f, n in CONFIGS])
def test_config_classmethods_match_jax(family, name):
    jcls, tcls = PACKAGES[family]
    j, t = getattr(jcls, name)(), getattr(tcls, name)()
    tfields = dataclasses.asdict(t)
    jfields = dataclasses.asdict(j)
    extra = JAX_ONLY.get(family, {})
    assert set(jfields) == set(tfields) | set(extra)
    assert {k: jfields[k] for k in tfields} == tfields
    assert {k: jfields[k] for k in extra} == extra
