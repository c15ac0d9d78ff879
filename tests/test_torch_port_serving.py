"""The port's serving path against the JAX package's, at tiny widths in fp32
on the CPU, on the tiny SD1.5 and SDXL directories the JAX ``save_pipeline``
writes (with a ``tokenizer/`` written by the port's ``save_pretrained``, so
that both packages give an added word the ids past the encoder's table):

- ``ModelMerger``: LoRA (the ``layers`` filter, ``load_ema``, conv LoRA)
  and part merges (``base_model_alpha`` 0, 1 and unset) on files the JAX
  ``CkptManagerSafe`` wrote, and on the files of a port trainer run; the
  merged weights equal the JAX merger's within fp32 rounding;
- ``load_lora.yaml``, ``text2img_lora.yaml``, ``load_unet_part.yaml``,
  ``text2img_DA++.yaml`` (``branch: n`` and the ``mask`` form, SD1.5 and
  SDXL) and a pre-0.9 biased LoRA through the Visualizers of both
  packages: the text encoding, and every step's x0 and the final latents
  of one denoise loop from the same initial latents (atol 1e-3, the
  repo's loop bound);
- ``emb_ext`` in CLIP and both SDXL encoders, an ``emb_dir`` of ``.pt``
  files in the Visualizer, and a reload whose ``emb_dir`` adds a file;
- ``save_model`` and the trainer's ``save_merged``: the JAX
  ``build_models`` reads the directories to the port's weights;
- ``VisualizerReloadable``, ``precompile`` and the HTTP server on an
  ephemeral port (health, a PNG equal to ``vis_images``' uint8, 403
  without the reload token), and a process serving a request that
  imports no ``jax``, ``hcpdiff_tpu`` or ``PIL`` module.
"""
import base64
import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.adapt.overlay import make_lora_overlay as jmake_lora_overlay
from hcpdiff_tpu.ckpt.manager import CkptManagerSafe as JCkptManagerSafe
from hcpdiff_tpu.config import containerize as jcontainerize
from hcpdiff_tpu.config import load as jload
from hcpdiff_tpu.diffusion import samplers as jsamplers
from hcpdiff_tpu.diffusion.schedules import NoiseSchedule as JSchedule
from hcpdiff_tpu.infer import pipeline as jpipe
from hcpdiff_tpu.infer.reloadable import VisualizerReloadable as JReloadable
from hcpdiff_tpu.infer.visualizer import ModelMerger as JModelMerger
from hcpdiff_tpu.infer.visualizer import Visualizer as JVisualizer
from hcpdiff_tpu.models.compose.sdxl_te import SDXLTextEncoderFrontend as JSDXLFrontend
from hcpdiff_tpu.models.factory import build_models as jbuild
from hcpdiff_tpu_torch.adapt.overlay import collapse_overlay, strip_overlay_bias
from hcpdiff_tpu_torch.ckpt.bridge import state_dict_from_params
from hcpdiff_tpu_torch.ckpt.formats import save_webui_embedding
from hcpdiff_tpu_torch.ckpt.manager import CkptManagerSafe, auto_manager, CkptManagerPKL
from hcpdiff_tpu_torch.config import containerize, load
from hcpdiff_tpu_torch.diffusion import samplers as tsamplers
from hcpdiff_tpu_torch.infer import pipeline as tpipe
from hcpdiff_tpu_torch.infer import visualizer as tvis
from hcpdiff_tpu_torch.infer.aot import precompile
from hcpdiff_tpu_torch.infer.reloadable import VisualizerReloadable
from hcpdiff_tpu_torch.models import factory
from hcpdiff_tpu_torch.models.compose.sdxl_te import split_sdxl_embedding
from hcpdiff_tpu_torch.models.factory import build_models as tbuild
from hcpdiff_tpu_torch.server import InferenceServer, make_handler
from hcpdiff_tpu_torch.trainer.assemble import assemble, assemble_te
from hcpdiff_tpu_torch.trainer.trainer import Trainer
from hcpdiff_tpu_torch.utils.clip_tokenizer import CLIPTokenizer as TTokenizer
from hcpdiff_tpu_torch.utils.images import decode_png, write_png
from tests.test_torch_port_trainer import LORA, _cfg as train_cfg
from tests.test_torch_port_visualizer import _write_jax_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ['cat', 'dog', 'photo', 'painting']
ATOL_MODEL, ATOL_LOOP = 1e-4, 1e-3
# merged weights: the same fp32 sums, the rank-r products summed in
# another order
MERGE_TOL = dict(atol=1e-6, rtol=1e-6)
CPU = ['device=cpu', 'dtype=fp32', 'infer_args.width=32', 'infer_args.height=32',
       'infer_args.inference_steps=3', 'bs=2', 'seed=5']
TOKEN = 'sekrit'


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Tiny models gain nothing from intra-op threads, and the suite's
    parallel workers would oversubscribe the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('models')
    out = {}
    for name in ('sd15', 'sdxl'):
        out[name] = str(root / name)
        _write_jax_dir(name, out[name])
        TTokenizer.tiny(words=WORDS).save_pretrained(os.path.join(out[name], 'tokenizer'))
    return out


@pytest.fixture(scope='module')
def jworlds(dirs):
    return {name: jbuild(path, dtype=jnp.float32) for name, path in dirs.items()}


def _np(t):
    return t.detach().float().numpy()


def _overlay(params, patterns, rank, seed, alpha=1.5, bias=False):
    """A JAX overlay on ``params`` at the layers ``patterns`` select, with
    seeded nonzero factors (and, with ``bias``, a pre-0.9 bias delta)."""
    ov, _ = jmake_lora_overlay(jax.random.PRNGKey(seed), params,
                               [{'layers': patterns, 'rank': rank}])
    rng = np.random.default_rng(seed)
    out = {}
    for path, e in ov.items():
        out[path] = {'down': (0.3 * rng.standard_normal(e['down'].shape)).astype(np.float32),
                     'up': (0.3 * rng.standard_normal(e['up'].shape)).astype(np.float32),
                     'alpha': np.asarray(alpha, np.float32)}
        if bias:
            out[path]['bias'] = (0.5 * rng.standard_normal(e['up'].shape[1])).astype(np.float32)
    return out


def _conv_shapes(ov, params):
    from hcpdiff_tpu.adapt.overlay import _get_path
    shapes = {p: tuple(_get_path(params, p)['kernel'].shape) for p in ov}
    return {p: s for p, s in shapes.items() if len(s) == 4}


def _subset(params, keys, seed):
    """A 'part' subset: the top-level entries ``keys`` of a JAX tree with
    seeded values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.2 * rng.standard_normal(x.shape)).astype(np.float32),
        {k: params[k] for k in keys})


UNET_LAYERS = ['re:.*attn[12]\\.to_(q|k|v|out)$', 're:.*ff\\.(proj|out)$', 're:.*conv1$']
TE_LAYERS = ['re:.*self_attn\\.(q|v)_proj$', 're:.*fc1$']


@pytest.fixture(scope='module')
def files(dirs, jworlds, tmp_path_factory):
    """LoRA and part files written by the JAX ``CkptManagerSafe`` (the JAX
    trainer's keys, through the alias maps) for both tiny worlds."""
    root = tmp_path_factory.mktemp('ckpts')
    mgr = JCkptManagerSafe()
    out = {}
    for world in ('sd15', 'sdxl'):
        w = jworlds[world]
        up, tp = w['unet_params'], w['te_params']

        def save(name, params, alias, **kw):
            path = str(root / f'{world}-{name}.safetensors')
            for key in ('lora_overlay', 'lora_ema'):
                if key in kw:
                    kw['conv_shapes'] = _conv_shapes(kw[key], params)
            mgr.save_model_with_lora(path, aliases=w['aliases'][alias], **kw)
            out[f'{world}-{name}'] = path

        save('unet_lora', up, 'unet', lora_overlay=_overlay(up, UNET_LAYERS, 2, 1),
             lora_ema=_overlay(up, UNET_LAYERS, 2, 2))
        save('unet_lora2', up, 'unet', lora_overlay=_overlay(
            up, ['re:.*attn1\\.to_q$', 're:.*ff\\.out$'], 3, 3, alpha=3.0))
        save('unet_neg', up, 'unet', lora_overlay=_overlay(up, UNET_LAYERS[:1], 2, 4))
        save('unet_biased', up, 'unet', lora_overlay=_overlay(
            up, ['re:.*attn1\\.to_(q|v)$'], 2, 5, bias=True))
        attn = next(k for k in up if '_attn_' in k)
        save('unet_part', up, 'unet', base=_subset(up, ['conv_in', attn], 6),
             base_ema=_subset(up, ['conv_in', attn], 7))
        save('te_lora', tp, 'te', lora_overlay=_overlay(tp, TE_LAYERS, 2, 8),
             lora_ema=_overlay(tp, TE_LAYERS, 2, 9))
        save('te_lora2', tp, 'te', lora_overlay=_overlay(tp, TE_LAYERS[:1], 4, 10, alpha=2.0))
        save('te_part', tp, 'te', base=_subset(tp, ['layers_0', 'final_layer_norm'], 11))
    return out


@pytest.fixture(scope='module')
def trained(dirs, tmp_path_factory):
    """Two steps of the port's trainer (UNet and text-encoder LoRA) on the
    tiny SD1.5 directory: its files and the Trainer."""
    proj = tmp_path_factory.mktemp('proj')
    rng = np.random.default_rng(3)
    (proj / 'imgs').mkdir()
    for i in range(4):
        write_png(str(proj / 'imgs' / f'img_{i}.png'),
                  rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    with open(proj / 'imgs' / 'captions.json', 'w') as f:
        json.dump({f'img_{i}': f'a photo of cat {i}' for i in range(4)}, f)
    exp = proj / 'exp'
    cfg = train_cfg(proj, exp, **LORA, device='cpu', **{
        'model.pretrained_model_name_or_path': dirs['sd15'], 'train.train_steps': 2,
        'train.save_step': 2})
    trainer = Trainer(containerize(cfg))
    assert trainer.train() == 2
    return {'unet': str(exp / 'ckpts' / 'unet-2.safetensors'),
            'te': str(exp / 'ckpts' / 'text_encoder-2.safetensors'), 'trainer': trainer}


# ---------------------------------------------------------------- ModelMerger

MERGES = {     # case -> (model, [(kind, file, kwargs)])
    'unet_lora_all': ('unet', [('lora', 'unet_lora', dict(alpha=0.8)),
                               ('lora', 'unet_lora2', dict(alpha=0.65))]),
    'unet_lora_layers': ('unet', [('lora', 'unet_lora', dict(alpha=0.7, layers=[
        're:.*attn1.*', 'down_0_res_0.conv1']))]),
    'unet_lora_ema': ('unet', [('lora', 'unet_lora', dict(alpha=1.0, load_ema=True))]),
    'unet_part_base_alpha_0': ('unet', [('part', 'unet_part', dict(alpha=1.0, base_alpha=0.0)),
                                        ('lora', 'unet_lora', dict(alpha=0.5))]),
    'unet_part_base_alpha_1_layers': ('unet', [('part', 'unet_part', dict(
        alpha=0.6, base_alpha=1.0, layers=['re:.*attn1.*']))]),
    'unet_part_unset_ema': ('unet', [('part', 'unet_part', dict(alpha=0.3, load_ema=True))]),
    'te_lora_part': ('te', [('lora', 'te_lora', dict(alpha=0.8)),
                            ('part', 'te_part', dict(alpha=0.5)),
                            ('lora', 'te_lora2', dict(alpha=0.4, layers=['layers_1']))]),
    'te_lora_ema': ('te', [('lora', 'te_lora', dict(alpha=1.0, load_ema=True))]),
}


def _tworld(dirs, name='sd15'):
    return tbuild(dirs[name], torch.float32, 'cpu')


def _params(module):
    return {n: p.detach() for n, p in module.named_parameters()}


def _assert_merged(port, jax_tree, **tol):
    want = state_dict_from_params(jax.device_get(jax_tree))
    assert sorted(port) == sorted(want)
    for name, value in port.items():
        np.testing.assert_allclose(_np(value), want[name].numpy(), err_msg=name,
                                   **(tol or MERGE_TOL))


def _mergers(jw, tw, model):
    key = 'unet' if model == 'unet' else 'te'
    return (JModelMerger(jw[f'{key}_params'], jw['aliases'][key]),
            tvis.ModelMerger(_params(tw[key]), tw[key], tw['aliases'][key]))


@pytest.mark.parametrize('case', sorted(MERGES))
def test_model_merger_matches_jax(dirs, jworlds, files, case):
    model, steps = MERGES[case]
    tw = _tworld(dirs)
    jm, tm = _mergers(jworlds['sd15'], tw, model)
    for kind, name, kw in steps:
        path = files[f'sd15-{name}']
        getattr(jm, f'load_{kind}')(path, **kw)
        getattr(tm, f'load_{kind}')(path, **kw)
    merged = tm.merged()
    _assert_merged(merged, jm.merged())
    base = _params(tw['unet' if model == 'unet' else 'te'])
    changed = {n for n in merged if not torch.equal(merged[n], base[n])}
    assert changed and changed <= tm.touched()


def test_model_merger_on_trainer_files_matches_jax(dirs, jworlds, trained):
    """The port trainer's unet-2 and text_encoder-2 (the JAX trainer's keys)
    merge alike in both packages, and at alpha 1 give the weights the
    trainer's own ``assemble`` gives."""
    tw, tr = _tworld(dirs), trained['trainer']
    for model, key in (('unet', 'unet'), ('te', 'te')):
        jm, tm = _mergers(jworlds['sd15'], tw, model)
        for m in (jm, tm):
            m.load_lora(trained[key], alpha=1.0)
        merged = tm.merged()
        _assert_merged(merged, jm.merged())
        fn = assemble if model == 'unet' else assemble_te
        own = fn(tr.frozen[key], tr.state.pack, tr.lora_scales)
        assert own and set(own) <= tm.touched()
        for name, value in own.items():
            np.testing.assert_allclose(_np(merged[name]), _np(value), **MERGE_TOL)


def test_auto_manager_and_bias_roundtrip(tmp_path, files, dirs):
    assert isinstance(auto_manager('x.safetensors'), CkptManagerSafe)
    assert isinstance(auto_manager('x.ckpt'), CkptManagerPKL)
    tw = _tworld(dirs)
    path = files['sd15-unet_biased']
    ov = CkptManagerSafe().load_ckpt(path, aliases=tw['aliases']['unet'])['lora']
    assert ov and all('bias' in e for e in ov.values())
    again = str(tmp_path / 'again.safetensors')
    CkptManagerSafe().save_model_with_lora(again, tw['unet'], lora_overlay=ov,
                                           aliases=tw['aliases']['unet'])
    from hcpdiff_tpu.ckpt.formats import load_safetensors
    assert sorted(load_safetensors(again)) == sorted(load_safetensors(path))
    with pytest.raises(ValueError, match='bias-free'):
        collapse_overlay(_params(tw['unet']), ov)
    with pytest.warns(UserWarning, match='stripped'):
        stripped = strip_overlay_bias(ov)
    merged = collapse_overlay(_params(tw['unet']), stripped)
    assert not any(n.endswith('to_q.bias') for n in merged)


# ------------------------------------------------- Visualizers, one denoise loop

@pytest.fixture(scope='module')
def jloops():
    """The JAX denoise loops by (UNet config, sampler, steps): one compile
    each, whatever Visualizer's params they run."""
    return {}


def _loops_agree(jloops, jv, tv, prompt='a photo of cat', neg='dog', steps=3,
                 sampler='dpm++_2m', gs=6.0, B=2, seed=11):
    """Both packages' text encoding, then one CFG loop each from the same
    initial latents over the Visualizers' merged weights (and negative
    branch): every step's x0 and the final latents within ATOL_LOOP."""
    prompts, negs = [prompt] * B, [neg] * B
    jctx, jpooled = jv.pipe.encode_prompts(prompts, negs, jv.emb_ext)
    tctx, tpooled = tv.pipe.encode_prompts(prompts, negs, tv.emb_ext)
    np.testing.assert_allclose(_np(tctx), np.asarray(jctx), atol=ATOL_MODEL)
    lat = np.random.default_rng(seed).standard_normal((B, 16, 16, 4)).astype(np.float32)
    jextra = textra = None
    if tv.sdxl:
        tid = np.asarray([32, 32, 0, 0, 32, 32], np.float32)
        jextra = {'pooled_text_emb': jpooled, 'time_ids': jnp.tile(tid[None], (2 * B, 1))}
        textra = tv.pipe._extra_cond(tpooled, 2 * B, 32, 32)
    key = (repr(jv.world['unet_cfg']), sampler, steps)
    if key not in jloops:
        unet = jv.world['unet']
        jloops[key] = jpipe.DenoiseLoop(
            lambda p, x, t, c, **e: unet.apply({'params': p}, x, t, c, **e),
            jsamplers.make_sampler(sampler, JSchedule.make(), steps), return_x0_every=1)
    jlat, jx0 = jloops[key](jv.pipe.unet_params, jnp.asarray(lat), jctx, jax.random.PRNGKey(0),
                            gs, extra_cond=jextra, unet_params_neg=jv.pipe.unet_params_neg)
    tloop = tpipe.DenoiseLoop(tv.pipe.unet, tsamplers.make_sampler(sampler, tv.schedule, steps),
                              return_x0=True, unet_neg=tv.pipe._unet_neg())
    tlat, tx0 = tloop(torch.from_numpy(lat), tctx, gs, extra_cond=textra)
    np.testing.assert_allclose(_np(tx0), np.asarray(jx0), atol=ATOL_LOOP)
    np.testing.assert_allclose(_np(tlat), np.asarray(jlat), atol=ATOL_LOOP)
    return tlat


def _cfgfile(name):
    return os.path.join(ROOT, 'cfgs', 'infer', name)


def _both(cfg_name, model_dir, tmp_path, *extra):
    """The JAX Visualizer on one config file and overrides, and the port's
    as ``python -m hcpdiff_tpu_torch.visualizer`` runs it (its requests
    answered and written)."""
    over = [f'pretrained_model={model_dir}', f'output_dir={tmp_path / "out"}',
            f'interface.0.save_root={tmp_path / "out"}', *CPU, *extra]
    jv = JVisualizer(jload(_cfgfile(cfg_name), over))
    tv, images = tvis.main(['--cfg', _cfgfile(cfg_name), *over])
    assert images.shape == (2, 32, 32, 3) and np.isfinite(images).all()
    return jv, tv


def _merge_args(files, world, spec):
    """Dotlist overrides pointing a config's merge paths at ``files``."""
    return [f'merge.{k}.path={files[f"{world}-{v}"]}' for k, v in spec.items()]


CONFIGS = {
    'load_lora.yaml': {'group1.lora.0': 'unet_lora', 'group1.lora.1': 'unet_lora2',
                       'group2.lora.0': 'te_lora', 'group2.lora.1': 'te_lora2'},
    'text2img_lora.yaml': {'group1.lora.0': 'unet_lora', 'group2.lora.0': 'te_lora'},
    'load_unet_part.yaml': {'group1.part.0': 'unet_part', 'group2.lora.0': 'te_lora'},
}


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_merge_configs_match_jax(dirs, files, jloops, tmp_path, name):
    jv, tv = _both(name, dirs['sd15'], tmp_path, *_merge_args(files, 'sd15', CONFIGS[name]))
    _assert_merged(dict(tv.world['unet'].state_dict()), jv.unet_params)
    _assert_merged(dict(tv.world['te'].state_dict()), jv.te_params)
    assert tv.pipe.unet_params_neg is None and jv.pipe.unet_params_neg is None
    _loops_agree(jloops, jv, tv)


DA = {'branch': ['merge.group1.lora.1.branch=n'],
      'mask': ['merge.group1.lora.1.branch=p', 'merge.group1.lora.1.mask=[0.0, 0.5]']}


@pytest.mark.parametrize('form', sorted(DA))
def test_dreamartist_matches_jax(dirs, files, jloops, tmp_path, form):
    spec = {'group1.lora.0': 'unet_lora', 'group1.lora.1': 'unet_neg', 'group2.lora.0': 'te_lora'}
    jv, tv = _both('text2img_DA++.yaml', dirs['sd15'], tmp_path,
                   *_merge_args(files, 'sd15', spec), *DA[form])
    neg = tv.pipe.unet_params_neg
    assert neg is not None and jv.pipe.unet_params_neg is not None
    # only the weights either branch changes, each the JAX negative branch's
    want = state_dict_from_params(jax.device_get(jv.pipe.unet_params_neg))
    assert len(neg) < len(want)
    for n, v in neg.items():
        np.testing.assert_allclose(_np(v), want[n].numpy(), err_msg=n, **MERGE_TOL)
    _loops_agree(jloops, jv, tv, gs=1.0)        # CFG runs with the branch at guidance 1


def _dict_cfg(model_dir, tmp_path, **over):
    cfg = {'pretrained_model': model_dir, 'dtype': 'fp32', 'device': 'cpu',
           'prompt': 'a photo of cat', 'neg_prompt': 'dog', 'seed': 3, 'bs': 2,
           'output_dir': str(tmp_path / 'out'),
           'infer_args': {'width': 32, 'height': 32, 'inference_steps': 3,
                          'sampler': 'dpm++_2m', 'guidance_scale': 6.0},
           'interface': [], 'merge': None}
    cfg.update(over)
    return cfg


def _both_dict(cfg):
    return JVisualizer(jcontainerize(cfg)), tvis.Visualizer(containerize(cfg))


def test_sdxl_dreamartist_splits_the_conditioning(dirs, files, jloops, tmp_path):
    merge = {'g1': {'type': 'unet', 'lora': [
        {'path': files['sdxl-unet_lora'], 'alpha': 0.8},
        {'path': files['sdxl-unet_neg'], 'alpha': 0.6, 'branch': 'n'}]},
        'g2': {'type': 'TE', 'lora': [{'path': files['sdxl-te_lora'], 'alpha': 0.7}]}}
    jv, tv = _both_dict(_dict_cfg(dirs['sdxl'], tmp_path, merge=merge))
    assert tv.sdxl and tv.pipe.unet_params_neg is not None
    _loops_agree(jloops, jv, tv)


def test_biased_lora_rebuilds_qkv_bias_like_jax(dirs, files, jloops, tmp_path):
    """A pre-0.9 biased LoRA: the UNet rebuilt with biased q/k/v (zero but
    where the LoRA's bias delta lands), as the JAX Visualizer rebuilds it."""
    merge = {'g1': {'type': 'unet', 'lora': [{'path': files['sd15-unet_biased'], 'alpha': 0.9},
                                             {'path': files['sd15-unet_lora'], 'alpha': 0.5}]}}
    jv, tv = _both_dict(_dict_cfg(dirs['sd15'], tmp_path, merge=merge))
    unet = tv.world['unet']
    assert unet.cfg.qkv_bias and jv.world['unet_cfg'].qkv_bias and tv.pipe.unet is unet
    sd = dict(unet.state_dict())
    _assert_merged(sd, jv.unet_params)
    assert any(float(v.abs().max()) > 0 for n, v in sd.items() if n.endswith('attn1.to_q.bias'))
    assert all(float(v.abs().max()) == 0 for n, v in sd.items() if n.endswith('attn2.to_q.bias'))
    _loops_agree(jloops, jv, tv)


def test_biased_lora_on_the_fused_unet_takes_the_unfused_block(dirs):
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition
    cfg = _tworld(dirs)['unet_cfg']
    biased = UNet2DCondition(dataclasses.replace(cfg, qkv_bias=True), fused_sublayers=True)
    blocks = [m for n, m in biased.named_modules() if n.endswith('transformer_blocks_0')]
    assert blocks and not any(b.fused for b in blocks)
    assert biased.down_0_res_0.fused        # the resblocks stay fused


# ------------------------------------------------------------------- emb_ext

def _emb_rows(n, dim, seed):
    return (0.05 * np.random.default_rng(seed).standard_normal((n, dim))).astype(np.float32)


def test_clip_emb_ext_matches_jax(dirs, jworlds):
    tw, jw = _tworld(dirs), jworlds['sd15']
    V = tw['te_cfg'].vocab_size
    ext = _emb_rows(3, tw['te_cfg'].hidden_size, 1)
    ids = np.full((2, 77), tw['tokenizer'].eos_token_id, np.int64)
    ids[:, :6] = [[V - 2, 5, V, V + 2, 7, V + 1], [3, V + 1, V + 1, 9, V, 4]]
    tl, tp, _ = tw['te'](torch.from_numpy(ids), emb_ext=torch.from_numpy(ext))
    jl, jp, _ = jw['te'].apply({'params': jw['te_params']}, jnp.asarray(ids),
                               emb_ext=jnp.asarray(ext))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL_MODEL)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=ATOL_MODEL)
    rows = tw['te'].embed_tokens(torch.from_numpy(ids), torch.from_numpy(ext))
    assert torch.equal(rows[0, 2], torch.from_numpy(ext[0]))
    assert torch.equal(rows[1, 1], torch.from_numpy(ext[1]))


def test_sdxl_frontend_emb_ext_matches_jax(dirs, jworlds):
    from hcpdiff_tpu_torch.models.compose.sdxl_te import SDXLTextEncoderFrontend
    tw, jw = _tworld(dirs, 'sdxl'), jworlds['sdxl']
    tk = tw['tokenizer']
    tk.add_word('hcpword', 2)
    dim_l = tw['te_cfg'].hidden_size
    rows = _emb_rows(2, dim_l + tw['te2_cfg'].hidden_size, 2)
    parts = split_sdxl_embedding(rows, dim_l=dim_l)
    fe = SDXLTextEncoderFrontend(tk, tw['te'], tw['te2'])
    jtk = jw['tokenizer']
    jtk.add_word('hcpword', 2)
    jfe = JSDXLFrontend(jtk, jw['te'], jw['te_params'], jw['te2'], jw['te2_params'])
    texts = ['a hcpword cat', 'dog']
    th, tp = fe.encode(texts, emb_ext={k: torch.from_numpy(v) for k, v in parts.items()})
    jh, jp = jfe.encode(texts, emb_ext={k: jnp.asarray(v) for k, v in parts.items()})
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=ATOL_MODEL)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=ATOL_MODEL)
    plain, _ = fe.encode(texts)
    assert not torch.allclose(plain[0], th[0]) and torch.allclose(plain[1], th[1])


def _write_embs(emb_dir, dims, names=('hcpstyle', 'hcpword'), counts=(2, 1), seed=20):
    os.makedirs(emb_dir, exist_ok=True)
    out = {}
    for i, (name, n) in enumerate(zip(names, counts)):
        out[name] = _emb_rows(n, dims, seed + i)
        save_webui_embedding(os.path.join(emb_dir, f'{name}.pt'), out[name], name)
    return out


@pytest.mark.parametrize('world', ['sd15', 'sdxl'])
def test_emb_dir_matches_jax(dirs, jworlds, jloops, tmp_path, world):
    dims = jworlds[world]['te_cfg'].hidden_size + (
        jworlds[world]['te2_cfg'].hidden_size if world == 'sdxl' else 0)
    vecs = _write_embs(str(tmp_path / 'embs'), dims)
    jv, tv = _both_dict(_dict_cfg(dirs[world], tmp_path, emb_dir=str(tmp_path / 'embs')))
    tk = tv.tokenizer
    V = tv.world['te_cfg'].vocab_size
    assert tk.added_tokens == jv.tokenizer.added_tokens == {'hcpstyle': [V, V + 1],
                                                            'hcpword': [V + 2]}
    _loops_agree(jloops, jv, tv, prompt='a hcpstyle photo of cat, hcpword')
    ids = torch.tensor([[V, V + 1, V + 2]])
    ext = tv.emb_ext['clip_L'] if world == 'sdxl' else tv.emb_ext
    got = tv.world['te'].embed_tokens(ids, ext)[0]
    want = np.concatenate([vecs['hcpstyle'], vecs['hcpword']])[:, :tv.world['te_cfg'].hidden_size]
    assert torch.equal(got, torch.from_numpy(want))


def test_emb_dir_reload_builds_rows_in_id_order(dirs, tmp_path):
    """A reload whose emb_dir adds a file that sorts first: the words
    already registered keep their ids, and the rows follow the ids. The
    JAX reloadable concatenates the rows in file order instead, so its
    first word's ids read the new file's vector."""
    first, both = str(tmp_path / 'first'), str(tmp_path / 'both')
    dims = 32
    b = _write_embs(first, dims, names=('zword',), counts=(1,), seed=30)
    _write_embs(both, dims, names=('zword',), counts=(1,), seed=30)
    a = _write_embs(both, dims, names=('aword',), counts=(1,), seed=31)
    cfg = _dict_cfg(dirs['sd15'], tmp_path, emb_dir=first)
    tv, jv = VisualizerReloadable(containerize(cfg)), JReloadable(jcontainerize(cfg))
    cfg2 = dict(cfg, emb_dir=both)
    assert not tv.check_reload(containerize(cfg2)) and not jv.check_reload(jcontainerize(cfg2))
    V = tv.world['te_cfg'].vocab_size
    assert tv.tokenizer.added_tokens == {'zword': [V], 'aword': [V + 1]}
    rows = tv.world['te'].embed_tokens(torch.tensor([[V, V + 1]]), tv.emb_ext)[0]
    assert torch.equal(rows[0], torch.from_numpy(b['zword'][0]))
    assert torch.equal(rows[1], torch.from_numpy(a['aword'][0]))
    assert jv.tokenizer.added_tokens == tv.tokenizer.added_tokens
    np.testing.assert_array_equal(np.asarray(jv.emb_ext)[0], a['aword'][0])   # the JAX defect


# ---------------------------------------------------------------- save_model

def test_save_model_loads_in_both_packages(dirs, files, tmp_path):
    merge_args = _merge_args(files, 'sd15', CONFIGS['text2img_lora.yaml'])
    out = str(tmp_path / 'merged')
    viser, _ = tvis.main(['--cfg', _cfgfile('save_model.yaml'), f'pretrained_model={dirs["sd15"]}',
                          f'output_dir={tmp_path / "o"}', f'interface.0.save_root={tmp_path / "o"}',
                          f'save_model.path={out}', *CPU, *merge_args])
    assert sorted(os.listdir(out)) == ['text_encoder', 'tokenizer', 'unet', 'vae']
    jw = jbuild(out, dtype=jnp.float32)
    tw = tbuild(out, torch.float32, 'cpu')
    for key in ('unet', 'vae', 'te'):
        held = dict(viser.world[key].state_dict())
        _assert_merged(held, jw[f'{key}_params'], atol=0, rtol=0)
        back = dict(tw[key].state_dict())
        assert sorted(back) == sorted(held)
        assert all(torch.equal(back[n], held[n]) for n in held)
    # the same request on the loaded directory gives the same latents
    again = tvis.Visualizer(load(_cfgfile('text2img.yaml'), [
        f'pretrained_model={out}', f'output_dir={tmp_path / "o2"}',
        f'interface.0.save_root={tmp_path / "o2"}', *CPU]))
    viser.vis_images('a photo of cat', 'dog', seed=4)
    again.vis_images('a photo of cat', 'dog', seed=4)
    assert torch.equal(viser.last_latents, again.last_latents)


def test_trainer_save_merged_loads_in_jax(trained, tmp_path):
    tr = trained['trainer']
    out = str(tmp_path / 'merged')
    tr.save_merged(out)
    jw = jbuild(out, dtype=jnp.float32)
    with torch.no_grad():
        for key, module, fn in (('unet', tr.unet, assemble), ('te', tr.te, assemble_te)):
            want = {**module.state_dict(), **fn(tr.frozen[key], tr.state.pack, tr.lora_scales)}
            _assert_merged({n: v.detach() for n, v in want.items()}, jw[f'{key}_params'],
                           atol=0, rtol=0)


# ------------------------------------------------------------- reloadable

def test_reload_infer_args_only(dirs, tmp_path):
    v = VisualizerReloadable(containerize(_dict_cfg(dirs['sd15'], tmp_path)))
    weight = v.world['unet'].conv_in.weight
    ia = dict(_dict_cfg(dirs['sd15'], tmp_path)['infer_args'], inference_steps=2)
    assert v.check_reload(containerize(_dict_cfg(dirs['sd15'], tmp_path, infer_args=ia))) is False
    assert v.world['unet'].conv_in.weight is weight
    assert v.cfgs['infer_args']['inference_steps'] == 2


def test_reload_frontend_knobs_and_interface(dirs, tmp_path):
    v = VisualizerReloadable(containerize(_dict_cfg(dirs['sd15'], tmp_path)))
    assert (v.frontend.clip_skip, v.frontend.n_repeats) == (0, 1)
    out = str(tmp_path / 'disk')
    v.check_reload(containerize(_dict_cfg(
        dirs['sd15'], tmp_path, model={'clip_skip': 1, 'tokenizer_repeats': 2},
        interface=[{'_target_': 'hcpdiff_tpu.infer.interfaces.DiskInterface',
                    'save_root': out}])))
    assert (v.frontend.clip_skip, v.frontend.n_repeats) == (1, 2)
    assert v.interfaces[0].save_root == out


def test_reload_merge_remerges_from_the_kept_base(dirs, files, tmp_path, monkeypatch):
    """A new alpha: the same modules, no directory read, and the weights and
    latents of a Visualizer built at that alpha; the negative branch is
    rebuilt (``test_round2_fixes.py``'s case)."""
    def merge(alpha, neg):
        return {'g1': {'type': 'unet', 'lora': [
            {'path': files['sd15-unet_lora'], 'alpha': alpha, 'branch': 'p'},
            {'path': files['sd15-unet_neg'], 'alpha': neg, 'branch': 'n'}]},
            'g2': {'type': 'TE', 'lora': [{'path': files['sd15-te_lora'], 'alpha': alpha}]}}
    v = VisualizerReloadable(containerize(_dict_cfg(dirs['sd15'], tmp_path, merge=merge(1.0, 0.5))))
    unet, te = v.world['unet'], v.world['te']
    assert v.pipe.unet_params_neg is not None
    reads = []
    monkeypatch.setattr(factory, 'load_state_dict', lambda *a: reads.append(a))
    assert not v.check_reload(containerize(_dict_cfg(dirs['sd15'], tmp_path,
                                                     merge=merge(0.4, 0.9))))
    assert reads == [] and v.world['unet'] is unet and v.world['te'] is te
    assert v.pipe.unet is unet and v.pipe.unet_params_neg is not None
    monkeypatch.undo()
    fresh = tvis.Visualizer(containerize(_dict_cfg(dirs['sd15'], tmp_path, merge=merge(0.4, 0.9))))
    for key in ('unet', 'te'):
        a, b = v.world[key].state_dict(), fresh.world[key].state_dict()
        assert all(torch.equal(a[n], b[n]) for n in a)
    assert all(torch.equal(v.pipe.unet_params_neg[n], fresh.pipe.unet_params_neg[n])
               for n in fresh.pipe.unet_params_neg)
    v.vis_images('a cat', 'dog', seed=9)
    fresh.vis_images('a cat', 'dog', seed=9)
    assert torch.equal(v.last_latents, fresh.last_latents)
    # dropping the recipe puts the base back
    v.check_reload(containerize(_dict_cfg(dirs['sd15'], tmp_path)))
    base = _tworld(dirs)['unet'].state_dict()
    assert all(torch.equal(v.world['unet'].state_dict()[n], base[n]) for n in base)
    assert v.pipe.unet_params_neg is None


def test_reload_new_base_rebuilds(dirs, tmp_path):
    v = VisualizerReloadable(containerize(_dict_cfg(dirs['sd15'], tmp_path)))
    assert v.check_reload(containerize(_dict_cfg('tiny', tmp_path))) is True
    assert v.world['unet_cfg'].cross_attention_dim == 32 and v.pipe.unet is v.world['unet']


def test_precompile_warms_the_tiny_world(dirs, tmp_path, capsys):
    v = tvis.Visualizer(containerize(_dict_cfg(dirs['sd15'], tmp_path)))
    precompile(v.pipe, [(32, 32, 2, 'euler'), (32, 32, 2, 'dpm++_2m')], batch_size=2)
    lines = capsys.readouterr().out.splitlines()
    assert [l.split(':')[0] for l in lines] == ['[aot] 32x32 euler/2 batch 2',
                                                '[aot] 32x32 dpm++_2m/2 batch 2']


# ------------------------------------------------------------------ server

@pytest.fixture(scope='module')
def served(dirs, files, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('served')
    merge = {'g1': {'type': 'unet', 'lora': [{'path': files['sd15-unet_lora'], 'alpha': 0.8}]}}
    cfg = _dict_cfg(dirs['sd15'], tmp, merge=merge)
    srv = InferenceServer(containerize(cfg), reload_token=TOKEN)
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), make_handler(srv))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield srv, httpd.server_address[1], cfg
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _call(port, method, path, body=None, headers=None):
    c = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    try:
        c.request(method, path, body=None if body is None else json.dumps(body),
                  headers=headers or {})
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def test_server_health(served):
    _, port, _ = served
    assert _call(port, 'GET', '/health') == (200, {'status': 'ok', 'backend': 'cpu',
                                                   'devices': 1, 'device_name': 'cpu'})
    assert _call(port, 'GET', '/nothing')[0] == 404


def test_server_png_equals_vis_images(served):
    srv, port, _ = served
    req = {'prompt': 'a photo of cat', 'negative_prompt': 'dog', 'width': 32, 'height': 32,
           'steps': 2, 'seed': 7, 'sampler': 'euler', 'bs': 2}
    status, out = _call(port, 'POST', '/txt2img', req)
    assert status == 200 and out['seed'] == 7 and len(out['images']) == 2
    pngs = [decode_png(base64.b64decode(b)) for b in out['images']]
    imgs = srv.viser.vis_images('a photo of cat', 'dog', width=32, height=32, inference_steps=2,
                                guidance_scale=7.5, sampler='euler', seed=7, bs=2)
    want = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    for png, w in zip(pngs, want):
        np.testing.assert_array_equal(png, w)


def test_server_reload_needs_the_token(served, files):
    srv, port, cfg = served
    new = dict(cfg, merge={'g1': {'type': 'unet', 'lora': [
        {'path': files['sd15-unet_lora'], 'alpha': 0.3}]}})
    unet = srv.viser.world['unet']
    assert _call(port, 'POST', '/reload', new)[0] == 403
    assert _call(port, 'POST', '/reload', new, {'X-Auth-Token': 'wrong'})[0] == 403
    assert _call(port, 'POST', '/reload', new, {'X-Auth-Token': TOKEN}) == (
        200, {'reloaded': True, 'full_rebuild': False})
    assert srv.viser.world['unet'] is unet
    assert srv.viser.cfgs['merge']['g1']['lora'][0]['alpha'] == 0.3
    status, out = _call(port, 'POST', '/txt2img', {'width': 32, 'height': 32, 'steps': 1})
    assert status == 200 and len(out['images']) == 2


def test_server_process_imports_no_jax_or_pil(dirs, files, tmp_path):
    """``serve``'s parts in a process of their own: the server built from a
    config file (``text2img_lora.yaml`` with its paths overridden), warmed
    up, one request over HTTP; no jax, hcpdiff_tpu or PIL module loaded."""
    code = (
        'import json, sys, threading, http.client\n'
        'from http.server import ThreadingHTTPServer\n'
        'from hcpdiff_tpu_torch.config import load\n'
        'from hcpdiff_tpu_torch.server import InferenceServer, make_handler\n'
        'srv = InferenceServer(load(sys.argv[1], sys.argv[2:]), reload_token="t")\n'
        'srv.precompile()\n'
        'httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))\n'
        'threading.Thread(target=httpd.serve_forever, daemon=True).start()\n'
        'c = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)\n'
        'c.request("POST", "/txt2img", body=json.dumps({"width": 32, "height": 32, '
        '"steps": 2, "seed": 1}))\n'
        'r = c.getresponse()\n'
        'assert r.status == 200, r.read()\n'
        'assert len(json.loads(r.read())["images"]) == 2\n'
        'httpd.shutdown()\n'
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'hcpdiff_tpu', 'PIL', 'yaml', 'safetensors'))\n"
        'print(bad)\n')
    args = [sys.executable, '-c', code, _cfgfile('text2img_lora.yaml'),
            f'pretrained_model={dirs["sd15"]}', f'output_dir={tmp_path}',
            f'interface.0.save_root={tmp_path}', *CPU,
            *_merge_args(files, 'sd15', CONFIGS['text2img_lora.yaml'])]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    res = subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith('[aot] 32x32 dpm++_2m/3 batch 2:') and lines[-1] == '[]'
