"""The port's config-driven inference slice against the JAX package's, at
tiny widths in fp32 on the CPU:

- diffusers-layout directories: a tiny SD1.5 and a tiny SDXL directory
  written by the JAX ``save_pipeline`` load in the port's ``build_models``,
  whose UNet, VAE encode/decode and CLIP match the JAX modules on the same
  inputs (atol 1e-4); the port's writer (``tools/random_diffusers.py``)
  gives back a directory the JAX ``build_models`` reads to the same param
  tree, bit for bit;
- the five new samplers' plans and steps, on the same model outputs and
  fed noise, and ``slice_for_partial`` (atol 1e-5);
- ``encode``, the partial img2img loop and both inpaint modes, on the same
  noised latents (the packages draw different noise from one seed;
  atol 1e-3, the repo's loop bound);
- ``Visualizer``/``main`` on ``device: cpu``: PNG and YAML outputs, the
  scheduler mapping, the features that raise (a ``merge`` group's plugin
  entries among them; the merge recipes, ``emb_dir`` and ``save_model``
  are held to the JAX package in ``test_torch_port_serving.py``), no card,
  and no JAX, ``hcpdiff_tpu`` or ``diffusers`` import;
- the PNG reader and writer and the bicubic resize against Pillow.
"""
import dataclasses
import json
import os
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hcpdiff_tpu.ckpt.formats import save_safetensors
from hcpdiff_tpu.ckpt.manager import CkptManagerDiffusers
from hcpdiff_tpu.ckpt.sd_convert import clip_params_to_torch
from hcpdiff_tpu.diffusion import samplers as jsamplers
from hcpdiff_tpu.diffusion.schedules import NoiseSchedule as JSchedule
from hcpdiff_tpu.infer import pipeline as jpipe
from hcpdiff_tpu.models import clip as jclip
from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu.models import vae as jvae
from hcpdiff_tpu.models.factory import build_models as jbuild
from hcpdiff_tpu.models.text_frontend import TextEncoderFrontend as JFrontend
from hcpdiff_tpu.utils.clip_tokenizer import CLIPTokenizer
from hcpdiff_tpu_torch.ckpt.bridge import load_params
from hcpdiff_tpu_torch.ckpt.diffusers_layout import to_port, unet_key_map
from hcpdiff_tpu_torch.diffusion import samplers as tsamplers
from hcpdiff_tpu_torch.diffusion.schedules import NoiseSchedule as TSchedule
from hcpdiff_tpu_torch.infer import pipeline as tpipe
from hcpdiff_tpu_torch.infer.visualizer import main
from hcpdiff_tpu_torch.models import clip as tclip
from hcpdiff_tpu_torch.models import factory
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.models import vae as tvae
from hcpdiff_tpu_torch.models.factory import build_models as tbuild
from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend as TFrontend
from hcpdiff_tpu_torch.tools.random_diffusers import write_module
from hcpdiff_tpu_torch.utils import images
from tests.torch_port_common import random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBDIRS = (('unet', 'unet'), ('vae', 'vae'), ('text_encoder', 'te'), ('text_encoder_2', 'te2'))
ATOL_MODEL, ATOL_LOOP = 1e-4, 1e-3
CPU = ['device=cpu', 'dtype=fp32', 'infer_args.width=32', 'infer_args.height=32',
       'infer_args.inference_steps=3', 'bs=2', 'seed=5']


def _jax_world(name):
    """The JAX factory's tiny configs (``build_models('tiny'/'tiny_sdxl')``)
    with seeded random parameters in every leaf (``random_params``: no
    flax init runs, and no bias or scale keeps its init value)."""
    tk = CLIPTokenizer.tiny(words=['cat', 'dog', 'photo', 'painting'])
    ids = dict(vocab_size=tk.vocab_size, eos_token_id=tk.eos_token_id,
               bos_token_id=tk.bos_token_id)
    w = {'te_cfg': jclip.CLIPTextConfig.tiny(**ids), 'vae_cfg': jvae.VAEConfig.tiny()}
    kw = {}
    if name == 'sdxl':
        w['te2_cfg'] = jclip.CLIPTextConfig.tiny(hidden_size=48, num_attention_heads=4,
                                                 projection_dim=48, **ids)
        w['unet_cfg'] = junet.UNetConfig.tiny_sdxl(cross_attention_dim=80,
                                                   projection_class_embeddings_input_dim=96)
        kw = dict(pooled_text_emb=jnp.zeros((1, 48)), time_ids=jnp.zeros((1, 6)))
    else:
        w['unet_cfg'] = junet.UNetConfig.tiny(cross_attention_dim=32)
    ucfg = w['unet_cfg']
    w['unet_params'] = random_params(
        junet.UNet2DCondition(ucfg, dtype=jnp.float32), jnp.zeros((1, 8, 8, 4)),
        jnp.array([0]), jnp.zeros((1, 77, ucfg.cross_attention_dim)), seed=1, **kw)
    w['vae_params'] = random_params(jvae.AutoencoderKL(w['vae_cfg'], dtype=jnp.float32),
                                    jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0), seed=2)
    for key, seed in (('te', 3), ('te2', 4)):
        if key + '_cfg' in w:
            w[key + '_params'] = random_params(jclip.CLIPTextModel(w[key + '_cfg']),
                                               jnp.zeros((1, 77), jnp.int32), seed=seed)
    return w


def _write_jax_dir(name, path):
    """A tiny JAX world written by ``save_pipeline`` (and, for SDXL, its
    second encoder beside it, as diffusers lays it out)."""
    w = _jax_world(name)
    CkptManagerDiffusers().save_pipeline(
        path, unet_params=w['unet_params'], unet_cfg=w['unet_cfg'],
        vae_params=w['vae_params'], vae_cfg=w['vae_cfg'],
        te_params=w['te_params'], te_cfg=w['te_cfg'])
    if 'te2_params' in w:
        sub = os.path.join(path, 'text_encoder_2')
        os.makedirs(sub)
        cfg = dict(dataclasses.asdict(w['te2_cfg']), architectures=['CLIPTextModelWithProjection'])
        with open(os.path.join(sub, 'config.json'), 'w') as f:
            json.dump(cfg, f)
        save_safetensors(clip_params_to_torch(w['te2_params'], w['te2_cfg'].num_hidden_layers),
                         os.path.join(sub, 'model.safetensors'))


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    """Tiny diffusers-layout directories: 'sd15' and 'sdxl' written by the
    JAX package; 'port_sd15' and 'port_sdxl' written back by the port from
    what it loaded of them."""
    root = tmp_path_factory.mktemp('models')
    out = {}
    for name in ('sd15', 'sdxl'):
        out[name] = str(root / name)
        _write_jax_dir(name, out[name])
        tw = tbuild(out[name], torch.float32, 'cpu')
        out['port_' + name] = str(root / ('port_' + name))
        for sub, key in SUBDIRS:
            if key in tw:
                write_module(tw[key], os.path.join(out['port_' + name], sub), torch.float32)
    return out


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize('name', ['sd15', 'sdxl'])
def test_jax_directory_loads_alike(dirs, name):
    jw = jbuild(dirs[name], dtype=jnp.float32)
    tw = tbuild(dirs[name], torch.float32, 'cpu')
    assert tw['sdxl'] == jw['sdxl'] == (name == 'sdxl')
    assert tw['aliases'] == jw['aliases']
    rng = np.random.default_rng(7)
    ucfg = tw['unet_cfg']
    x = rng.standard_normal((2, 8, 8, ucfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, ucfg.cross_attention_dim)).astype(np.float32)
    t = np.array([999, 10])
    kw = {}
    if ucfg.addition_embed_type == 'text_time':
        pooled_dim = (ucfg.projection_class_embeddings_input_dim
                      - 6 * ucfg.addition_time_embed_dim)
        kw = dict(pooled_text_emb=rng.standard_normal((2, pooled_dim)).astype(np.float32),
                  time_ids=np.array([[64.0, 64, 0, 0, 64, 64], [48, 64, 8, 0, 64, 64]],
                                    np.float32))
    ju = jax.jit(lambda p, *a, **k: jw['unet'].apply({'params': p}, *a, **k))(
        jw['unet_params'], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        tu = tw['unet'](torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                        **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(_np(tu), np.asarray(ju), atol=ATOL_MODEL)

    img = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    jm, jl, jd = jax.jit(lambda p, i, z: (
        *jw['vae'].apply({'params': p}, i, method='encode'),
        jw['vae'].apply({'params': p}, z, method='decode')))(jw['vae_params'], img, z)
    with torch.no_grad():
        tm, tl = tw['vae'].encode(torch.from_numpy(img))
        td = tw['vae'].decode(torch.from_numpy(z))
    for a, b in ((tm, jm), (tl, jl), (td, jd)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL_MODEL)

    for key in ('te', 'te2') if name == 'sdxl' else ('te',):
        cfg = tw[key + '_cfg']
        ids = rng.integers(0, cfg.vocab_size - 2, (2, 77))
        ids[:, 0], ids[0, 9], ids[1, 76] = cfg.bos_token_id, cfg.eos_token_id, cfg.eos_token_id
        jlast, jpooled, _ = jax.jit(jw[key].apply)({'params': jw[key + '_params']},
                                                   jnp.asarray(ids))
        with torch.no_grad():
            tlast, tpooled, _ = tw[key](torch.from_numpy(ids))
        np.testing.assert_allclose(_np(tlast), np.asarray(jlast), atol=ATOL_MODEL)
        np.testing.assert_allclose(_np(tpooled), np.asarray(jpooled), atol=ATOL_MODEL)


@pytest.mark.parametrize('name', ['sd15', 'sdxl'])
def test_port_directory_loads_in_jax_to_the_same_params(dirs, name):
    """The port's writer gives the JAX build_models the param trees that
    the JAX package wrote, bit for bit (so the same results)."""
    a, b = jbuild(dirs[name], dtype=jnp.float32), jbuild(dirs['port_' + name],
                                                          dtype=jnp.float32)
    for key in ('unet_params', 'vae_params', 'te_params', 'te2_params'):
        if key in a:
            la, lb = jax.tree_util.tree_leaves_with_path(a[key]), \
                jax.tree_util.tree_leaves_with_path(b[key])
            assert [p for p, _ in la] == [p for p, _ in lb], key
            for (path, x), (_, y) in zip(la, lb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))
    assert a['te_cfg'] == b['te_cfg'] and a.get('te2_cfg') == b.get('te2_cfg')
    assert a['vae_cfg'] == b['vae_cfg']


def test_build_models_refuses_a_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match='not a diffusers-layout directory'):
        tbuild(str(tmp_path / 'nothing'), torch.float32, 'cpu')


def test_tiny_worlds_match_jax_configs():
    for name in ('tiny', 'tiny_sdxl'):
        jw = {}

        def params():                        # traced only: no init is computed
            jw.update(jbuild(name, dtype=jnp.float32))
            return {k: v for k, v in jw.items() if k.endswith('_params')}
        shapes = jax.eval_shape(params)
        tw = tbuild(name, torch.float32, 'cpu')
        for key in ('unet_cfg', 'vae_cfg', 'te_cfg', 'te2_cfg'):
            assert (key in jw) == (key in tw)
            if key in jw:
                tc, jc = dataclasses.asdict(tw[key]), dataclasses.asdict(jw[key])
                assert {k: v for k, v in jc.items() if k in tc} == tc, (name, key)
        assert tw['aliases'] == jw['aliases'] and tw['sdxl'] == jw['sdxl']
        n_jax = sum(np.prod(v.shape) for k in shapes for v in jax.tree_util.tree_leaves(shapes[k]))
        n_port = sum(p.numel() for k in ('unet', 'vae', 'te', 'te2') if k in tw
                     for p in tw[k].parameters())
        assert n_jax == n_port


# diffusers' own config.json files (the fields the factory reads) of SD1.5,
# SD2.1 and SDXL base, and the port's classmethods they must give
_SD_DOWN = ['CrossAttnDownBlock2D'] * 3 + ['DownBlock2D']
_SD_UP = ['UpBlock2D'] + ['CrossAttnUpBlock2D'] * 3
REAL_CONFIGS = [
    ('unet sd15', dict(attention_head_dim=8, block_out_channels=[320, 640, 1280, 1280],
                       cross_attention_dim=768, down_block_types=_SD_DOWN, up_block_types=_SD_UP,
                       in_channels=4, out_channels=4, layers_per_block=2, norm_num_groups=32),
     tunet.UNetConfig.sd15()),
    ('unet sd21', dict(attention_head_dim=[5, 10, 20, 20], use_linear_projection=True,
                       block_out_channels=[320, 640, 1280, 1280], cross_attention_dim=1024,
                       down_block_types=_SD_DOWN, up_block_types=_SD_UP, layers_per_block=2),
     tunet.UNetConfig.sd21()),
    ('unet sdxl', dict(addition_embed_type='text_time', addition_time_embed_dim=256,
                       attention_head_dim=[5, 10, 20], block_out_channels=[320, 640, 1280],
                       cross_attention_dim=2048,
                       down_block_types=['DownBlock2D'] + ['CrossAttnDownBlock2D'] * 2,
                       up_block_types=['CrossAttnUpBlock2D'] * 2 + ['UpBlock2D'],
                       projection_class_embeddings_input_dim=2816, layers_per_block=2,
                       transformer_layers_per_block=[1, 2, 10], use_linear_projection=True),
     tunet.UNetConfig.sdxl()),
    ('vae sd', dict(block_out_channels=[128, 256, 512, 512], latent_channels=4,
                    layers_per_block=2, norm_num_groups=32), tvae.VAEConfig.sd()),
    ('vae sdxl', dict(block_out_channels=[128, 256, 512, 512], latent_channels=4,
                      layers_per_block=2, scaling_factor=0.13025), tvae.VAEConfig.sdxl()),
    ('clip L', dict(architectures=['CLIPTextModel'], hidden_act='quick_gelu', hidden_size=768,
                    intermediate_size=3072, num_attention_heads=12, num_hidden_layers=12,
                    projection_dim=768), tclip.CLIPTextConfig.sd15()),
    ('clip H', dict(architectures=['CLIPTextModel'], hidden_act='gelu', hidden_size=1024,
                    intermediate_size=4096, num_attention_heads=16, num_hidden_layers=23,
                    projection_dim=512), tclip.CLIPTextConfig.sd2()),
    ('clip bigG', dict(architectures=['CLIPTextModelWithProjection'], hidden_act='gelu',
                       hidden_size=1280, intermediate_size=5120, num_attention_heads=20,
                       num_hidden_layers=32, projection_dim=1280),
     tclip.CLIPTextConfig.sdxl_big_g()),
]


@pytest.mark.parametrize('name, config, want', REAL_CONFIGS, ids=[c[0] for c in REAL_CONFIGS])
def test_diffusers_configs_give_the_model_configs(name, config, want):
    read = {'unet': factory.unet_cfg_from_json, 'vae': factory.vae_cfg_from_json,
            'clip': factory.clip_cfg_from_json}[name.split()[0]]
    assert read(config) == want


def test_linear_projections_and_bin_weights_load(dirs, tmp_path):
    """SD2.x/SDXL checkpoints hold proj_in/proj_out as Linear, older ones
    ship ``.bin`` state dicts: the tiny UNet so written loads to the same
    weights as its safetensors directory."""
    src = os.path.join(dirs['port_sd15'], 'unet')
    sd = factory.load_state_dict(src)
    sd = {k: (v[:, :, 0, 0] if k.endswith(('proj_in.weight', 'proj_out.weight')) else v)
          for k, v in sd.items()}
    out = tmp_path / 'unet'
    out.mkdir()
    torch.save(sd, out / 'diffusion_pytorch_model.bin')
    with open(os.path.join(src, 'config.json')) as f:
        cfg = dict(json.load(f), use_linear_projection=True)
    (out / 'config.json').write_text(json.dumps(cfg))
    a = factory.load_unet(src, torch.float32, 'cpu').state_dict()
    b = factory.load_unet(str(out), torch.float32, 'cpu').state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    # transformers' position_ids buffers are skipped; any other stray key raises
    key_map = unet_key_map(factory.unet_cfg_from_json(cfg))
    assert to_port(dict(sd, position_ids=torch.arange(77)), key_map, 'unet').keys() == a.keys()
    with pytest.raises(KeyError, match='does not name'):
        to_port(dict(sd, **{'extra.weight': torch.zeros(1)}), key_map, 'unet')


# ----------------------------------------------------------------- samplers

SAMPLERS = [('ddim', {}), ('ddim', {'eta': 0.7}), ('ddpm', {}), ('euler', {}),
            ('euler_a', {}), ('euler', {'use_karras_sigmas': True}), ('dpm++_2m_sde', {}),
            ('dpm++_2m_sde', {'use_karras_sigmas': True, 'eta': 0.5})]


@pytest.mark.parametrize('t_start', [0, 3])
@pytest.mark.parametrize('name, kw', SAMPLERS, ids=lambda v: str(v) if v else 'default')
def test_sampler_matches_jax(name, kw, t_start, monkeypatch):
    js = jsamplers.make_sampler(name, JSchedule.make(), 8, **kw)
    ts = tsamplers.make_sampler(name, TSchedule.make(), 8, **kw)
    assert ts.slice_for_partial(t_start) == js.slice_for_partial(t_start)
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    assert ts.num_steps == js.num_steps and ts.step_stride == js.step_stride
    assert ts.init_noise_sigma == pytest.approx(js.init_noise_sigma, rel=1e-6)
    if hasattr(js, 'sigmas'):
        np.testing.assert_allclose(ts.sigmas, np.asarray(js.sigmas), rtol=1e-6)
    rng = np.random.default_rng(11)
    shape = (2, 4, 4, 4)
    x = rng.standard_normal(shape).astype(np.float32) * ts.init_noise_sigma
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jst, tst = js.init_state(shape), ts.init_state(shape)
    gen = torch.Generator()
    for i in range(ts.num_steps):
        out = rng.standard_normal(shape).astype(np.float32)
        key = jax.random.PRNGKey(i)
        noise = torch.from_numpy(np.array(jax.random.normal(key, shape)))
        monkeypatch.setattr(tsamplers, 'draw_noise', lambda x, g, n=noise: n.to(x.device))
        np.testing.assert_allclose(_np(ts.scale_model_input(tst, tx, i)),
                                   np.asarray(js.scale_model_input(jst, jx, i)),
                                   atol=1e-5, rtol=1e-5)
        jx, jst, jx0 = js.step(jst, jnp.asarray(out), i, jx, key)
        tx, tst, tx0 = ts.step(tst, torch.from_numpy(out), i, tx, gen)
        np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=1e-5, rtol=1e-5,
                                   err_msg=f'step {i}')
        np.testing.assert_allclose(_np(tx0), np.asarray(jx0), atol=1e-5, rtol=1e-5)


def test_make_sampler_still_refuses_the_rest():
    for name in ('pndm', 'unipc', 'lms', 'deis', 'heun', 'dpm2', 'dpm2_a', 'dpm++_2s_a',
                 'dpm++_sde'):
        assert name in jsamplers.SAMPLERS
        with pytest.raises(NotImplementedError, match='not ported'):
            tsamplers.make_sampler(name, TSchedule.make(), 10)


# -------------------------------------------------------- img2img, inpaint

@pytest.fixture(scope='module')
def pipes(dirs):
    """Both packages' pipelines over the JAX-written tiny SD1.5 directory,
    and a 9-channel inpaint UNet holding the same weights in both."""
    jw = jbuild(dirs['sd15'], dtype=jnp.float32)
    tw = tbuild(dirs['sd15'], torch.float32, 'cpu')
    jte = JFrontend(jw['tokenizer'], jw['te'], jw['te_params'])
    tte = TFrontend(tw['tokenizer'], tw['te'])

    def japply(unet):
        return lambda p, x, t, c, **e: unet.apply({'params': p}, x, t, c, **e)

    jp = jpipe.DiffusionPipeline(japply(jw['unet']), jw['unet_params'], jw['vae'],
                                 jw['vae_params'], jte)
    tp = tpipe.DiffusionPipeline(tw['unet'], tw['vae'], tte)
    cfg9 = dict(dataclasses.asdict(jw['unet_cfg']), in_channels=9)
    ju9 = junet.UNet2DCondition(junet.UNetConfig(**cfg9), dtype=jnp.float32)
    p9 = random_params(ju9, jnp.zeros((1, 8, 8, 9)), jnp.array([0]),
                       jnp.zeros((1, 77, cfg9['cross_attention_dim'])), seed=21)
    jp9 = jpipe.DiffusionPipeline(japply(ju9), p9, jw['vae'], jw['vae_params'], jte)
    tcfg9 = dataclasses.replace(tw['unet_cfg'], in_channels=9)
    tp9 = tpipe.DiffusionPipeline(load_params(tunet.UNet2DCondition(tcfg9), p9).eval(),
                                  tw['vae'], tte)
    return jp, tp, jp9, tp9


IMG = np.random.default_rng(2).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
# the tiny VAE halves the image: a [1, 16, 16, 1] latent mask, 0 to 1 across
MASK = np.ascontiguousarray(np.broadcast_to(
    np.arange(16, dtype=np.float32)[None, None, :, None] / 15, (1, 16, 16, 1)))
REQ = dict(num_steps=4, guidance_scale=6.0, seed=3)


def _jax_noise(seed, shape, index):
    """The noise the JAX pipeline draws: img2img takes split(key, 3)[1],
    the inpaint model's loop split(key)[0]."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 3 if index == 1 else 2)
    return np.array(jax.random.normal(keys[index], shape))


def test_encode_matches_jax(pipes):
    jp, tp, _, _ = pipes
    jz = jp.encode(jnp.asarray(IMG))
    tz = tp.encode(torch.from_numpy(IMG))
    np.testing.assert_allclose(_np(tz), np.asarray(jz), atol=ATOL_MODEL)
    sampled = tp.encode(torch.from_numpy(IMG), generator=torch.Generator().manual_seed(0))
    assert sampled.shape == tz.shape and not torch.equal(sampled, tz)


@pytest.mark.parametrize('sampler', ['dpm++_2m', 'ddim'])
def test_img2img_matches_jax(pipes, sampler):
    jp, tp, _, _ = pipes
    lat = np.array(jp.encode(jnp.asarray(IMG)))
    kw = dict(REQ, sampler=sampler, strength=0.5)
    jl = jp.img2img(jnp.asarray(lat), 'a photo of a cat', 'blurry', return_latents=True, **kw)
    tl = tp.img2img(torch.from_numpy(lat), 'a photo of a cat', 'blurry', return_latents=True,
                    noise=torch.from_numpy(_jax_noise(3, lat.shape, 1)), **kw)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL_LOOP)


@pytest.mark.parametrize('inpaint_model', [False, True])
def test_inpaint_matches_jax(pipes, inpaint_model):
    jp, tp, jp9, tp9 = pipes
    if inpaint_model:
        jp, tp = jp9, tp9
    lat = np.array(pipes[0].encode(jnp.asarray(IMG)))
    noise = _jax_noise(3, lat.shape, 0 if inpaint_model else 1)
    jimg = jp.inpaint(jnp.asarray(lat), jnp.asarray(MASK), 'a cat', 'dog', strength=0.75,
                      inpaint_model=inpaint_model, **REQ)
    timg = tp.inpaint(torch.from_numpy(lat), torch.from_numpy(MASK),
                      'a cat', 'dog', strength=0.75, inpaint_model=inpaint_model,
                      noise=torch.from_numpy(noise), **REQ)
    assert timg.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(timg, np.asarray(jimg), atol=ATOL_LOOP)


def test_txt2img_x0_history(pipes):
    _, tp, _, _ = pipes
    lat, x0s = tp.txt2img('a cat', width=32, height=32, num_steps=3, seed=1,
                          return_latents=True, return_x0_history=True)
    assert x0s.shape == (3, 1, 16, 16, 4)
    np.testing.assert_array_equal(_np(lat), _np(x0s[-1]))      # DPM++ 2M ends on x0
    imgs, _ = tp.txt2img('a cat', width=32, height=32, num_steps=3, seed=1,
                         return_x0_history=True)
    np.testing.assert_array_equal(imgs, tp.decode(lat))


# --------------------------------------------------------------- Visualizer

def _cfg(name):
    return os.path.join(ROOT, 'cfgs', 'infer', name)


def _run(dirs, tmp_path, name, *extra):
    out = str(tmp_path / 'out')
    viser, imgs = main(['--cfg', _cfg(name), f'pretrained_model={dirs["port_sd15"]}',
                        f'output_dir={out}', f'interface.0.save_root={out}', *CPU, *extra])
    return viser, imgs, out


def _written(out, n):
    return [images.read_png(os.path.join(out, f'{i}-img.png')) for i in range(n)]


def test_text2img_writes_png_and_yaml(dirs, tmp_path):
    viser, imgs, out = _run(dirs, tmp_path, 'text2img.yaml')
    assert imgs.shape == (2, 32, 32, 3) and np.isfinite(imgs).all()
    assert imgs.min() >= 0 and imgs.max() <= 1
    assert sorted(os.listdir(out)) == ['0-img.png', '0-img.yaml', '1-img.png', '1-img.yaml']
    expect = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    for i, png in enumerate(_written(out, 2)):
        np.testing.assert_array_equal(png, expect[i])
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(out, f'{i}-img.png'))),
                                      expect[i])
    import yaml
    info = yaml.safe_load(open(os.path.join(out, '0-img.yaml')))
    assert info['seed'] == 5 and info['sampler'] == 'dpm++_2m' and info['inference_steps'] == 3
    ref = viser.pipe.txt2img(viser.cfgs.prompt, viser.cfgs.neg_prompt, width=32, height=32,
                             num_steps=3, seed=5, batch_size=2, return_latents=True)
    assert torch.equal(ref, viser.last_latents)
    # a second run counts on from the files already there
    _run(dirs, tmp_path, 'text2img.yaml', 'num=2')
    assert len([f for f in os.listdir(out) if f.endswith('.png')]) == 6


def test_euler_a_maps_the_scheduler_and_is_deterministic(dirs, tmp_path):
    viser, a, _ = _run(dirs, tmp_path, 'euler_a.yaml')
    assert viser.cfgs.infer_args.sampler == 'euler_a'
    _, b, _ = _run(dirs, tmp_path, 'euler_a.yaml')
    _, c, _ = _run(dirs, tmp_path, 'euler_a.yaml', 'seed=6')
    _, d, _ = _run(dirs, tmp_path, 'text2img.yaml')
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0 and np.abs(a - d).max() > 0


@pytest.mark.parametrize('target, kw, sampler', [
    ('diffusers.DPMSolverMultistepScheduler', {'algorithm_type': 'sde-dpmsolver++'},
     'dpm++_2m_sde'),
    ('diffusers.DDIMScheduler', {'prediction_type': 'v_prediction'}, 'ddim'),
    ('diffusers.EulerDiscreteScheduler', {'use_karras_sigmas': True}, 'euler')])
def test_scheduler_mapping(dirs, tmp_path, target, kw, sampler):
    extra = [f'new_components.scheduler._target_={target}'] + [
        f'new_components.scheduler.{k}={v}' for k, v in kw.items()]
    viser, imgs, _ = _run(dirs, tmp_path, 'euler_a.yaml', *extra)
    assert viser.cfgs.infer_args.sampler == sampler and np.isfinite(imgs).all()
    assert viser.schedule.prediction_type == kw.get('prediction_type', 'epsilon')
    if 'use_karras_sigmas' in kw:
        assert viser.cfgs.infer_args.sampler_kwargs == {'use_karras_sigmas': True}


def test_unmapped_scheduler_raises(dirs, tmp_path):
    with pytest.raises(ValueError, match='no sampler mapping'):
        _run(dirs, tmp_path, 'euler_a.yaml',
             'new_components.scheduler._target_=diffusers.FancyNewScheduler')


@pytest.mark.parametrize('mode', ['img2img.yaml', 'inpaint.yaml'])
@pytest.mark.parametrize('size', [32, 40])
def test_img2img_and_inpaint_requests(dirs, tmp_path, mode, size):
    rng = np.random.default_rng(size)
    init, mask = str(tmp_path / 'init.png'), str(tmp_path / 'mask.png')
    images.write_png(init, rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    m = np.zeros((size, size), np.uint8)
    m[:, size // 2:] = 255
    images.write_png(mask, m)
    viser, imgs, out = _run(dirs, tmp_path, mode, f'init_image={init}', f'mask_image={mask}')
    assert imgs.shape == (1, 32, 32, 3) and np.isfinite(imgs).all()
    np.testing.assert_array_equal(_written(out, 1)[0], (np.clip(imgs[0], 0, 1) * 255)
                                  .astype(np.uint8))
    # the same request through the pipeline, with the images as Pillow resizes them
    pil = np.asarray(Image.open(init).convert('RGB').resize((32, 32), Image.BICUBIC))
    lat = viser.pipe.encode(torch.from_numpy(pil.astype(np.float32) / 127.5 - 1.0)[None])
    kw = dict(strength=0.75, num_steps=3, guidance_scale=7.5, seed=5, sampler='dpm++_2m')
    if mode == 'inpaint.yaml':
        pm = np.asarray(Image.open(mask).convert('L').resize(tuple(lat.shape[2:0:-1])),
                        np.float32) / 255.0
        ref = viser.pipe.inpaint(lat, torch.from_numpy(pm)[None, :, :, None],
                                 viser.cfgs.prompt, viser.cfgs.neg_prompt, **kw)
    else:
        ref = viser.pipe.img2img(lat, viser.cfgs.prompt, viser.cfgs.neg_prompt, **kw)
    np.testing.assert_array_equal(imgs, ref)


def _refusals(tmp_path):
    return {
        'merge': ['merge.group1.type=unet', 'merge.group1.plugin.cn1.path=controlnet.safetensors'],
        'controlnet': ['ex_input.cond.image=cond.png'],
        'anim_interface': ['interface.0._target_=hcpdiff_tpu.infer.interfaces.DiskAnimInterface'],
        'webui_interface': ['interface.0._target_=hcpdiff_tpu.infer.interfaces.WebUIInterface'],
        'other_interface': ['interface.0._target_=my.Interface'],
        'jpeg': ['interface.0.image_type=jpg'],
        'sampler': ['infer_args.sampler=heun'],
    }


@pytest.mark.parametrize('what', ['merge', 'controlnet', 'anim_interface', 'webui_interface',
                                  'other_interface', 'jpeg', 'sampler'])
def test_unported_features_raise(dirs, tmp_path, what):
    with pytest.raises(NotImplementedError, match='not ported|PNG only'):
        _run(dirs, tmp_path, 'text2img.yaml', *_refusals(tmp_path)[what])


def test_sdxl_directory_runs_and_refuses_other_text_settings(dirs, tmp_path):
    out = str(tmp_path / 'out')
    args = ['--cfg', _cfg('text2img_sdxl.yaml'), f'pretrained_model={dirs["port_sdxl"]}',
            f'interface.0.save_root={out}', *CPU, 'infer_args.sampler=euler']
    viser, imgs = main(args)
    assert viser.sdxl and imgs.shape == (2, 32, 32, 3) and np.isfinite(imgs).all()
    with pytest.raises(NotImplementedError, match='SDXL text encoding'):
        main(args + ['model.clip_skip=2'])


def test_empty_emb_dir_and_missing_vae_dir(dirs, tmp_path):
    (tmp_path / 'embs').mkdir()
    _run(dirs, tmp_path, 'text2img.yaml', f'emb_dir={tmp_path / "embs"}')
    with pytest.raises(FileNotFoundError, match='new_components.vae'):
        _run(dirs, tmp_path, 'change_vae.yaml')
    viser, _, _ = _run(dirs, tmp_path, 'change_vae.yaml',
                       f'new_components.vae.pretrained_model_name_or_path={dirs["port_sd15"]}')
    assert viser.world['vae'] is viser.pipe.vae


def test_no_card_raises_without_device_cpu(dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    cpu_free = [a for a in CPU if not a.startswith('device=')]
    with pytest.raises(RuntimeError, match='device=cpu'):
        main(['--cfg', _cfg('text2img.yaml'), f'pretrained_model={dirs["port_sd15"]}',
              f'interface.0.save_root={tmp_path}', *cpu_free])


def test_main_imports_no_jax_package_or_diffusers(dirs, tmp_path):
    code = ('import sys\n'
            'from hcpdiff_tpu_torch.visualizer import main\n'
            f'main(sys.argv[1:])\n'
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'hcpdiff_tpu', 'diffusers', 'yaml', 'PIL', "
            "'safetensors'))\n"
            'print(bad)\n')
    args = [sys.executable, '-c', code, '--cfg', _cfg('euler_a.yaml'),
            f'pretrained_model={dirs["port_sd15"]}', f'interface.0.save_root={tmp_path}', *CPU]
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == '[]'
    assert sorted(os.listdir(tmp_path)) == ['0-img.png', '0-img.yaml', '1-img.png',
                                            '1-img.yaml']


# ------------------------------------------------------------------ images

def _png_with_filters(arr, kinds):
    """A PNG of uint8 ``arr`` [H, W, C] whose row y is filtered with
    kinds[y % len(kinds)], encoded here from the PNG specification."""
    h, w, c = arr.shape
    rows = arr.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        k = kinds[y % len(kinds)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if k == 0:
            pred = np.zeros_like(cur)
        elif k == 1:
            pred = left
        elif k == 2:
            pred = up
        elif k == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([k]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = struct.pack('>IIBBBBB', w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr)
            + chunk(b'IDAT', zlib.compress(b''.join(out))) + chunk(b'IEND', b''))


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_png_reader_takes_every_filter(tmp_path, channels):
    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, (11, 13, channels), dtype=np.uint8)
    path = tmp_path / 'f.png'
    path.write_bytes(_png_with_filters(arr, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(np.asarray(Image.open(path)).reshape(arr.shape), arr)
    np.testing.assert_array_equal(images.read_png(str(path)).reshape(arr.shape), arr)


@pytest.mark.parametrize('shape', [(40, 52), (33, 47, 3), (24, 20, 4)])
def test_png_against_pillow(tmp_path, shape):
    """Pillow-written PNGs (adaptive filters, smooth and noisy rows) read
    here; PNGs written here read by Pillow."""
    rng = np.random.default_rng(sum(shape))
    ramp = np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1])) % 256
    arr = np.broadcast_to(ramp[..., None] if len(shape) == 3 else ramp,
                          shape).astype(np.uint8).copy()
    arr[::3] = rng.integers(0, 256, arr[::3].shape, dtype=np.uint8)
    Image.fromarray(arr).save(tmp_path / 'pil.png')
    np.testing.assert_array_equal(images.read_png(str(tmp_path / 'pil.png')), arr)
    images.write_png(str(tmp_path / 'mine.png'), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / 'mine.png')), arr)


@pytest.mark.parametrize('mode', ['P', 'LA', 'I;16'])
def test_other_pngs_read_through_pillow(tmp_path, mode):
    """Palette, grey + alpha and 16-bit PNGs, which read_png
    refuses, give load_image and load_mask what the JAX Visualizer's
    Pillow calls give."""
    rng = np.random.default_rng(len(mode))
    rgb = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
    path = str(tmp_path / 'img.png')
    if mode == 'P':
        Image.fromarray(rgb).quantize(16).save(path)
    elif mode == 'LA':
        Image.fromarray(rgb).convert('LA').save(path)
    else:
        Image.fromarray(rng.integers(0, 65536, (24, 20), dtype=np.uint16)).save(path)
    with pytest.raises(images.UnsupportedPNG):
        images.read_png(path)
    init = Image.open(path).convert('RGB').resize((16, 32), Image.BICUBIC)
    np.testing.assert_array_equal(images.load_image(path, 16, 32)[0],
                                  np.asarray(init, np.float32) / 127.5 - 1.0)
    mask = Image.open(path).convert('L').resize((10, 12))
    np.testing.assert_array_equal(images.load_mask(path, 10, 12)[0, :, :, 0],
                                  np.asarray(mask, np.float32) / 255.0)


@pytest.mark.parametrize('shape, size', [((512, 512, 3), (64, 64)), ((37, 53, 3), (20, 11)),
                                         ((30, 40), (80, 90)), ((48, 64), (64, 48)),
                                         ((50, 50, 3), (25, 50)), ((40, 40), (40, 40))])
def test_resize_and_convert_match_pillow(shape, size):
    rng = np.random.default_rng(shape[0])
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(Image.fromarray(arr).resize(size, Image.BICUBIC))
    np.testing.assert_array_equal(images.resize_bicubic(arr, size), ref)
    if arr.ndim == 3:
        np.testing.assert_array_equal(images._luma(arr),
                                      np.asarray(Image.fromarray(arr).convert('L')))
    np.testing.assert_array_equal(
        images.to_model_input(arr),
        np.asarray(Image.fromarray(arr).convert('RGB'), np.float32) / 127.5 - 1.0)
