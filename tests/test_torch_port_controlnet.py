"""The port's ControlNet inference slice against the JAX package's, at tiny
widths in fp32 on the CPU:

- ``models/controlnet.py``: the residuals and the mid residual against the
  JAX ``ControlNet`` on the same seeded tree (atol 1e-4, the repo's model
  bound), at the SD /8 and the tiny /2 condition encoders, with a scale,
  and under ``fused_sublayers`` (the plain versions of G-J); zero-initialized
  zero convs leave the UNet's output bitwise as it is, and ``init_from_unet``
  copies the UNet's blocks;
- ``ckpt/manager.py`` ``load_plugins`` on a ``.___.`` plugin file written
  by either package and on a webui ``control_model.*`` file, against the JAX
  manager (exact);
- ``data/processor.py`` against the JAX ``ControlNetProcessor`` (Pillow),
  and through the reference's ``_target_`` path;
- ``cfgs/infer/img2img_controlnet.yaml`` through the port's ``main()``:
  the JAX Visualizer's request against the port's Visualizer with the same
  latents and noise (atol 1e-3, the repo's loop bound), txt2img with the
  condition, DreamArtist's branch beside it, and the refusals.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.ckpt.ldm_convert import (UNET_LDM_PREFIX, _convert_by_module_map,
                                          unet_ldm_to_diffusers_map)
from hcpdiff_tpu.ckpt.manager import CkptManagerSafe as JSafe
from hcpdiff_tpu.config import load as jload
from hcpdiff_tpu.data.processor import ControlNetProcessor as JProcessor
from hcpdiff_tpu.infer.visualizer import Visualizer as JVisualizer
from hcpdiff_tpu.models import controlnet as jcn
from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu_torch.ckpt import safetensors_io
from hcpdiff_tpu_torch.ckpt.bridge import load_params, state_dict_from_params
from hcpdiff_tpu_torch.ckpt.diffusers_layout import from_port, unet_key_map
from hcpdiff_tpu_torch.ckpt.manager import CkptManagerSafe
from hcpdiff_tpu_torch.config.instantiate import instantiate
from hcpdiff_tpu_torch.data.processor import ControlNetProcessor
from hcpdiff_tpu_torch.infer.visualizer import main
from hcpdiff_tpu_torch.models import controlnet as tcn
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.utils import images
from tests.test_torch_port_visualizer import _jax_noise, _write_jax_dir
from tests.torch_port_common import random_params, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, 'cfgs', 'infer', 'img2img_controlnet.yaml')
ATOL_MODEL, ATOL_LOOP = 1e-4, 1e-3
CPU = ['device=cpu', 'dtype=fp32', 'infer_args.width=32', 'infer_args.height=32',
       'infer_args.inference_steps=4', 'bs=1', 'seed=5']


def _np(t):
    return t.detach().float().numpy()


def _tiny_cfg(pkg):
    return pkg.UNetConfig.tiny(cross_attention_dim=32)


def _jax_controlnet(stages, seed=7):
    jm = jcn.ControlNet(_tiny_cfg(junet), dtype=jnp.float32, cond_stages=stages)
    side = 8 * 2 ** stages
    params = random_params(jm, jnp.zeros((1, 8, 8, 4)), jnp.array([0]), jnp.zeros((1, 77, 32)),
                           jnp.zeros((1, side, side, 3)), seed=seed)
    return jm, params


def _inputs(stages, seed=1, size=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 9, 32)).astype(np.float32)
    cond = rng.uniform(0, 1, (2, size * 2 ** stages, size * 2 ** stages, 3)).astype(np.float32)
    return x, np.array([700, 20]), ctx, cond


@pytest.mark.parametrize('stages, scale, fused', [(3, 1.0, False), (1, 0.6, False),
                                                  (1, 1.0, True)],
                         ids=['sd-stages', 'tiny-scaled', 'tiny-fused'])
def test_controlnet_matches_jax(stages, scale, fused):
    jm, params = _jax_controlnet(stages)
    x, t, ctx, cond = _inputs(stages)
    jd, jmid = jax.jit(lambda p, *a: jm.apply({'params': p}, *a, conditioning_scale=scale))(
        params, x, t, ctx, cond)
    tm = load_params(tcn.ControlNet(_tiny_cfg(tunet), stages, fused_sublayers=fused), params)
    with torch.no_grad():
        td, tmid = tm(*(torch.from_numpy(a) for a in (x, t, ctx, cond)),
                      conditioning_scale=scale)
    assert len(td) == len(jd) == 4
    for a, b in zip(td, jd):
        assert a.shape == b.shape
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL_MODEL)
    np.testing.assert_allclose(_np(tmid), np.asarray(jmid), atol=ATOL_MODEL)


def test_zero_convs_leave_the_unet_bitwise_and_init_from_unet_copies():
    ju = junet.UNet2DCondition(_tiny_cfg(junet), dtype=jnp.float32)
    up = random_params(ju, jnp.zeros((1, 8, 8, 4)), jnp.array([0]), jnp.zeros((1, 77, 32)),
                       seed=3)
    unet = load_params(tunet.UNet2DCondition(_tiny_cfg(tunet)), up)
    net = tcn.ControlNet(_tiny_cfg(tunet), 1)
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.randn_like(p) if not n.startswith('zero_') else torch.zeros_like(p))
    tcn.init_from_unet(net, unet)
    usd, csd = unet.state_dict(), net.state_dict()
    shared = [k for k in csd if k in usd]
    assert all(torch.equal(csd[k], usd[k]) for k in shared)
    assert {k.split('.')[0] for k in csd if k not in usd} == {
        'cond_embedding', 'zero_0', 'zero_1', 'zero_2', 'zero_3', 'zero_mid'}
    # the JAX init_from_unet copies the same top-level modules
    src = jax.device_get(_jax_controlnet(1)[1])
    copied = jcn.init_from_unet(src, up)
    assert sorted(k for k in copied if copied[k] is not src[k]) == sorted(
        {k.split('.')[0] for k in shared})
    x, t, ctx, cond = (torch.from_numpy(a) for a in _inputs(1, seed=2))
    with torch.no_grad():
        down, mid = net(x, t, ctx, cond)
        assert all(float(r.abs().max()) == 0 for r in down) and float(mid.abs().max()) == 0
        assert torch.equal(unet(x, t, ctx, down_residuals=down, mid_residual=mid),
                           unet(x, t, ctx))


# ----------------------------------------------------------------- plugins

def _ldm_file(state, cfg):
    """A webui ControlNet file of a port ControlNet state: the shared blocks
    through the diffusers map and the JAX package's LDM map reversed, the
    zero convs and hint convs by position."""
    shared = {k: v for k, v in state.items() if not k.startswith(('zero_', 'cond_embedding'))}
    dif = from_port(shared, unet_key_map(cfg), 'controlnet')
    mod_map = unet_ldm_to_diffusers_map(len(cfg.block_out_channels), cfg.layers_per_block,
                                        tuple('CrossAttn' in t for t in cfg.down_block_types))
    ldm = _convert_by_module_map({k: v.numpy() for k, v in dif.items()}, mod_map,
                                 UNET_LDM_PREFIX, reverse=True)
    out = {'control_model.' + k[len(UNET_LDM_PREFIX):]: v for k, v in ldm.items()}
    n = sum(1 for k in state if k.startswith('zero_') and k != 'zero_mid.weight'
            and k.endswith('.weight'))
    for i in range(n):
        for leaf in ('weight', 'bias'):
            out[f'control_model.zero_convs.{i}.0.{leaf}'] = state[f'zero_{i}.{leaf}'].numpy()
    for leaf in ('weight', 'bias'):
        out[f'control_model.middle_block_out.0.{leaf}'] = state[f'zero_mid.{leaf}'].numpy()
        for i, name in enumerate(['conv_in', 'blocks_0', 'blocks_1', 'conv_out']):
            out[f'control_model.input_hint_block.{2 * i}.{leaf}'] = \
                state[f'cond_embedding.{name}.{leaf}'].numpy()
    # the hint block's 8 convs of SD's 3-stage ladder: the tiny one has 4;
    # conv_out sits at index 14, as in a webui file
    for leaf in ('weight', 'bias'):
        out[f'control_model.input_hint_block.14.{leaf}'] = \
            out.pop(f'control_model.input_hint_block.6.{leaf}')
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def test_load_plugins_both_formats_match_jax(tmp_path):
    _, params = _jax_controlnet(1)
    want = state_dict_from_params(params)
    names = {n for n, _ in tcn.ControlNet(_tiny_cfg(tunet), 1).named_parameters()}
    assert set(want) == names
    # a .___. file from each package
    jpath, tpath = str(tmp_path / 'j.safetensors'), str(tmp_path / 't.safetensors')
    JSafe().save_plugins(jpath, {'controlnet1': params})
    CkptManagerSafe().save_plugins(tpath, {'controlnet1': want},
                                   tcn.ControlNet(_tiny_cfg(tunet), 1))
    assert safetensors_io.load_file(jpath).keys() == safetensors_io.load_file(tpath).keys()
    for path in (jpath, tpath):
        got = CkptManagerSafe().load_plugins(path)
        jgot = JSafe().load_plugins(path)
        assert got.keys() == jgot.keys() == {'controlnet1'}
        assert got['controlnet1'].keys() == want.keys()
        for k, v in state_dict_from_params(jgot['controlnet1']).items():
            assert torch.equal(got['controlnet1'][k], v), k
            assert torch.equal(v, want[k]), k
    # a webui control_model.* file
    cfg = _tiny_cfg(tunet)
    lpath = str(tmp_path / 'webui.safetensors')
    ldm = _ldm_file(want, cfg)
    safetensors_io.save_file(ldm, lpath)
    got = CkptManagerSafe().load_plugins(lpath, unet_cfg=cfg)['controlnet1']
    jgot = state_dict_from_params(JSafe().load_plugins(lpath, unet_cfg=_tiny_cfg(junet))
                                  ['controlnet1'])
    assert got.keys() == jgot.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), jgot[k].numpy(), err_msg=k)
        assert torch.equal(got[k], want[k]), k


def test_processor_matches_jax_and_resolves(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / 'cond.png')
    images.write_png(path, rng.integers(0, 256, (40, 24, 3), dtype=np.uint8))
    for w, h, b in ((32, 32, 2), (24, 40, 1), (48, 16, 3)):
        np.testing.assert_array_equal(ControlNetProcessor(path)(w, h, b),
                                      JProcessor(path)(w, h, b))
    arr = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_array_equal(ControlNetProcessor(arr)(8, 8, 5), JProcessor(arr)(8, 8, 5))
    node = {'_target_': 'hcpdiff.data.data_processor.ControlNetProcessor', 'image': path}
    proc = instantiate(node)
    assert isinstance(proc, ControlNetProcessor)
    np.testing.assert_array_equal(proc(32, 32, 1), JProcessor(path)(32, 32, 1))


# -------------------------------------------------------------- Visualizer

@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """A JAX-written tiny SD1.5 directory, a seeded ControlNet plugin file
    (every leaf random, so the taps matter), its zero-conv-zeroed copy, a
    condition and an init PNG."""
    root = tmp_path_factory.mktemp('cn')
    out = {'dir': str(root / 'sd15')}
    _write_jax_dir('sd15', out['dir'])
    _, params = _jax_controlnet(1, seed=9)
    out['plugin'] = str(root / 'controlnet.safetensors')
    JSafe().save_plugins(out['plugin'], {'controlnet1': params})
    zeroed = {k: ({'kernel': np.zeros_like(v['kernel']), 'bias': np.zeros_like(v['bias'])}
                  if k.startswith('zero_') else v) for k, v in params.items()}
    out['zero_plugin'] = str(root / 'zero.safetensors')
    JSafe().save_plugins(out['zero_plugin'], {'controlnet1': zeroed})
    rng = np.random.default_rng(8)
    for name in ('cond', 'init'):
        out[name] = str(root / f'{name}.png')
        images.write_png(out[name], rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    return out


def _args(world, tmp_path, plugin='plugin', *extra):
    out = str(tmp_path / 'out')
    return (['--cfg', CFG, f'pretrained_model={world["dir"]}', f'output_dir={out}',
             f'interface.0.save_root={out}', f'init_image={world["init"]}',
             f'ex_input.cond.image={world["cond"]}',
             f'merge.group1.plugin.controlnet1.path={world[plugin]}', *CPU, *extra])


def test_img2img_controlnet_matches_the_jax_visualizer(world, tmp_path):
    """The config through the port's main(), and the JAX Visualizer's
    request beside the port Visualizer's pieces on the JAX request's noise."""
    args = _args(world, tmp_path)
    viser, imgs = main(args)
    assert imgs.shape == (1, 32, 32, 3) and np.isfinite(imgs).all()
    assert len(viser.pipe.plugins) == 1 and viser.pipe.plugins[0][1] == 1.0
    assert sorted(os.listdir(tmp_path / 'out')) == ['0-img.png', '0-img.yaml']
    jv = JVisualizer(jload(CFG, args[2:]))
    jimgs = jv.vis_images(jv.cfgs.prompt, jv.cfgs.neg_prompt, seed=5)
    c = viser.cfgs
    lat = viser.pipe.encode(images.load_image(world['init'], 32, 32))
    cond = viser._cond_image(32, 32, 1)
    steps, strength = 4, float(c.infer_args.strength)
    kw = dict(strength=strength, num_steps=steps, guidance_scale=float(c.infer_args.guidance_scale),
              seed=5, sampler='dpm++_2m')
    timg = viser.pipe.img2img(lat, c.prompt, c.neg_prompt, cond=cond,
                              noise=torch.from_numpy(_jax_noise(5, tuple(lat.shape), 1)), **kw)
    np.testing.assert_allclose(timg, np.asarray(jimgs), atol=ATOL_LOOP)
    # main()'s request is the pipeline's with its own noise
    np.testing.assert_array_equal(imgs, viser.pipe.img2img(lat, c.prompt, c.neg_prompt,
                                                           cond=cond, **kw))
    # the plugin moves the image; zeroed zero convs give the plain request bitwise
    plain = viser.pipe.img2img(lat, c.prompt, c.neg_prompt, **kw)
    assert np.abs(plain - imgs).max() > 1e-3
    zviser, zimgs = main(_args(world, tmp_path, 'zero_plugin'))
    np.testing.assert_array_equal(zimgs, zviser.pipe.img2img(lat, c.prompt, c.neg_prompt, **kw))


def test_txt2img_dreamartist_and_scale_with_the_condition(world, tmp_path, monkeypatch):
    """txt2img at bs 2: the condition at the request's rows, CFG-doubled; a
    plugin's alpha scales its residuals; DreamArtist's two calls both get
    them; DeepCache is dropped with a warning."""
    seen = []
    orig = tcn.ControlNet.forward

    def spy(self, x, t, ctx, cond, conditioning_scale=1.0):
        seen.append((x.shape[0], cond.shape, conditioning_scale))
        return orig(self, x, t, ctx, cond, conditioning_scale)
    monkeypatch.setattr(tcn.ControlNet, 'forward', spy)
    args = _args(world, tmp_path, 'plugin', 'mode=t2i', 'bs=2',
                 'merge.group1.plugin.controlnet1.alpha=0.5',
                 'infer_args.deep_cache_interval=2')
    viser, imgs = main(args)
    assert imgs.shape == (2, 32, 32, 3) and np.isfinite(imgs).all()
    assert seen == [(4, (4, 32, 32, 3), 0.5)] * 4
    cond = torch.from_numpy(ControlNetProcessor(world['cond'])(32, 32, 2))
    c = viser.cfgs
    kw = dict(width=32, height=32, num_steps=4, guidance_scale=float(c.infer_args.guidance_scale),
              seed=5, batch_size=2, sampler='dpm++_2m')
    np.testing.assert_array_equal(imgs, viser.pipe.txt2img(c.prompt, c.neg_prompt, cond=cond,
                                                           **kw))
    # DreamArtist: each half's call gets its half of the condition
    seen.clear()
    viser.pipe.unet_params_neg = dict(viser.pipe.unet.named_parameters())
    viser.pipe.txt2img(c.prompt, c.neg_prompt, cond=cond, **kw)
    assert seen == [(2, (2, 32, 32, 3), 0.5)] * 8


def test_plugin_refusals_and_an_unused_condition(world, tmp_path):
    foreign = str(tmp_path / 'foreign.safetensors')
    JSafe().save_plugins(foreign, {'lora_like': {'some_layer': {'kernel': np.zeros((2, 2),
                                                                                   np.float32)}}})
    with pytest.raises(NotImplementedError, match='other than a ControlNet.*item 7'):
        main(_args(world, tmp_path, 'plugin') + [f'merge.group1.plugin.controlnet1.path={foreign}'])
    # a condition without a plugin is dropped, as the JAX UNet callable drops it
    base = ['--cfg', os.path.join(ROOT, 'cfgs', 'infer', 'img2img.yaml'),
            f'pretrained_model={world["dir"]}', f'interface.0.save_root={tmp_path / "a"}',
            f'init_image={world["init"]}', *CPU]
    _, a = main(base)
    _, b = main(base[:3] + [f'interface.0.save_root={tmp_path / "b"}'] + base[4:]
                + [f'ex_input.cond={world["cond"]}'])
    np.testing.assert_array_equal(a, b)


def test_fused_unet_takes_a_fused_controlnet(world, tmp_path):
    """A Visualizer over a fused-sublayer UNet builds its ControlNets fused
    (the JAX environment switches route both networks)."""
    viser, _ = main(_args(world, tmp_path))
    unet = viser.world['unet']
    fused = tunet.UNet2DCondition(unet.cfg, fused_sublayers=True).eval()
    fused.load_state_dict(unet.state_dict())
    viser.world['unet'] = fused
    viser._build_merged()
    assert viser.pipe.plugins[0][0].fused_sublayers
    assert dataclasses.asdict(viser.pipe.plugins[0][0].cfg) == dataclasses.asdict(unet.cfg)
