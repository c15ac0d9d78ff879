"""The rest of the train step against the JAX package's, at tiny widths in
fp32 on the CPU: prompt-tuning words (Textual Inversion, CustomDiffusion),
DreamArtist and DreamArtist++, SDXL with its second text encoder and
crop-info ``time_ids``, and pyramid noise.

- the JAX ``Trainer`` and the port's on the same config, weights and
  ``emb_dir`` files, the port's pack set from the JAX pack and fed the JAX
  trainer's noise and timesteps (``test_torch_port_trainer.py``'s
  pattern): 3 steps' losses within rtol 1e-4, every pack leaf (every row
  of ``emb``, the words not trained too) and the EMA within atol 2e-6;
  the saved ``unet``/``text_encoder``/``text_encoder_2`` files hold the JAX
  trainer's keys and load in both packages, and each ``<word>-3.pt``
  equals the JAX file's vectors within 2e-6 (SDXL: the joined vectors);
- a run interrupted by SIGTERM and continued by ``resume.auto`` equals the
  uninterrupted one bit for bit, the prompt-embedding optimizer's state
  included; ``train.resume.ckpt_path.words`` loads a saved word's rows;
- the pieces on their own: DreamArtist's [neg, pos] batches and the
  crop-info ``time_ids`` bitwise the JAX dataset's, the CFG ramp, the
  ``cfg_scale`` parser, pyramid noise from the JAX package's per-level
  draws, SDXL's dual encode with its gradients, and ``create_embedding``
  against the JAX tool.

Ids differ between the packages only where a directory's tokenizer is
smaller than the encoder's table; here both give added words the ids past
the table, and words are compared by name.
"""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.ckpt.formats import load_safetensors
from hcpdiff_tpu.ckpt.formats import load_webui_embedding as jload_embedding
from hcpdiff_tpu.config import containerize as jcontainerize
from hcpdiff_tpu.data import buckets as jbuckets
from hcpdiff_tpu.data import dataset as jdataset
from hcpdiff_tpu.data import sources as jsources
from hcpdiff_tpu.diffusion.schedules import pyramid_noise as jpyramid_noise
from hcpdiff_tpu.models import clip as jclip
from hcpdiff_tpu.models import factory as jfactory
from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu.models.compose import sdxl_te as jsdxl
from hcpdiff_tpu.models.text_frontend import TextEncoderFrontend as JFrontend
from hcpdiff_tpu.tools import create_embedding as jcreate
from hcpdiff_tpu.trainer import step as jstep
from hcpdiff_tpu.trainer import trainer as jtrainer
from hcpdiff_tpu.utils.cfg_parse import get_cfg_range as jcfg_range
from hcpdiff_tpu.utils.clip_tokenizer import CLIPTokenizer as JTokenizer
from hcpdiff_tpu_torch.ckpt import safetensors_io
from hcpdiff_tpu_torch.ckpt.bridge import (load_params, lora_overlay_from_params,
                                           state_dict_from_params)
from hcpdiff_tpu_torch.ckpt.formats import load_webui_embedding, save_webui_embedding
from hcpdiff_tpu_torch.config import containerize
from hcpdiff_tpu_torch.data import buckets as tbuckets
from hcpdiff_tpu_torch.data import dataset as tdataset
from hcpdiff_tpu_torch.data import sources as tsources
from hcpdiff_tpu_torch.diffusion.schedules import pyramid_combine, pyramid_sizes
from hcpdiff_tpu_torch.models import clip as tclip
from hcpdiff_tpu_torch.models import factory as tfactory
from hcpdiff_tpu_torch.models.compose import sdxl_te as tsdxl
from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend as TFrontend
from hcpdiff_tpu_torch.tools import create_embedding as tcreate
from hcpdiff_tpu_torch.trainer.step import da_scale, pack_leaves
from hcpdiff_tpu_torch.trainer.trainer import Trainer
from hcpdiff_tpu_torch.utils.cfg_parse import get_cfg_range
from hcpdiff_tpu_torch.utils.clip_tokenizer import CLIPTokenizer as TTokenizer
from hcpdiff_tpu_torch.utils.images import write_png
from tests.test_torch_port_trainer import (ADAM_EPS, LORA, WORDS, _assert_packs_close, _cfg,
                                           _shapes, jax_world, one_torch_thread, port_world,
                                           proj)
from tests.torch_port_common import random_params

__all__ = ['jax_world', 'one_torch_thread', 'proj']      # fixtures shared with the trainer file
D_TE, D_TE2 = 32, 48                                       # the tiny encoders' widths
NAMES = {'unet': 'unet', 'te': 'text_encoder', 'te2': 'text_encoder_2'}


@pytest.fixture(scope='module')
def jax_sdxl_world(jax_world):
    """The JAX factory's tiny_sdxl world: the SD world's encoder, a second
    encoder (48 wide, projected) and the text_time UNet, from random_params."""
    te_cfg = jax_world['te_cfg']
    te2_cfg = jclip.CLIPTextConfig.tiny(vocab_size=te_cfg.vocab_size, hidden_size=D_TE2,
                                        num_attention_heads=4, eos_token_id=te_cfg.eos_token_id,
                                        bos_token_id=te_cfg.bos_token_id, projection_dim=D_TE2)
    unet_cfg = junet.UNetConfig.tiny_sdxl(cross_attention_dim=D_TE + D_TE2,
                                          projection_class_embeddings_input_dim=8 * 6 + D_TE2)
    unet = junet.UNet2DCondition(unet_cfg, dtype=jnp.float32)
    te2 = jclip.CLIPTextModel(te2_cfg, dtype=jnp.float32)
    return dict(jax_world, sdxl=True, unet=unet, unet_cfg=unet_cfg, te2=te2, te2_cfg=te2_cfg,
                unet_params=random_params(unet, jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                                          jnp.zeros((1, 77, D_TE + D_TE2)),
                                          pooled_text_emb=jnp.zeros((1, D_TE2)),
                                          time_ids=jnp.zeros((1, 6)), seed=43),
                te2_params=random_params(te2, jnp.zeros((1, 77), jnp.int32), seed=44),
                aliases=dict(jax_world['aliases'], unet=jfactory.unet_alias_map(unet_cfg),
                             te2=jfactory.clip_alias_map(te2_cfg)))


def port_sdxl_world(jw):
    """The port's tiny_sdxl world on the JAX world's weights."""
    cfgs = {}
    for key, jcfg in (('te_cfg', jw['te_cfg']), ('te2_cfg', jw['te2_cfg'])):
        cfgs[key] = tclip.CLIPTextConfig.tiny(
            vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
            num_attention_heads=jcfg.num_attention_heads, eos_token_id=jcfg.eos_token_id,
            bos_token_id=jcfg.bos_token_id, projection_dim=jcfg.projection_dim)
    cfgs['unet_cfg'] = tfactory.UNetConfig.tiny_sdxl(
        cross_attention_dim=D_TE + D_TE2, projection_class_embeddings_input_dim=8 * 6 + D_TE2)
    cfgs['vae_cfg'] = tfactory.VAEConfig.tiny()
    classes = {'unet': tfactory.UNet2DCondition, 'vae': tfactory.AutoencoderKL,
               'te': tclip.CLIPTextModel, 'te2': tclip.CLIPTextModel}
    out = dict(cfgs, sdxl=True, tokenizer=TTokenizer.tiny(words=WORDS), **{
        k: tfactory._finish(load_params(cls(cfgs[f'{k}_cfg']), jw[f'{k}_params']))
        for k, cls in classes.items()})
    out['aliases'] = {'unet': tfactory.unet_alias_map(cfgs['unet_cfg']),
                      'te': tfactory.clip_alias_map(cfgs['te_cfg']),
                      'te2': tfactory.clip_alias_map(cfgs['te2_cfg']),
                      'vae': tfactory.vae_alias_map(cfgs['vae_cfg'])}
    return out


def _write_words(root, words, dim, seed):
    """Seeded webui embeddings, two vectors a word."""
    rng = np.random.default_rng(seed)
    for w in words:
        save_webui_embedding(str(root / f'{w}.pt'),
                             (0.1 * rng.standard_normal((2, dim))).astype(np.float32), w)


@pytest.fixture(scope='module')
def sdxl_proj(tmp_path_factory):
    """64x48 PNGs: a 32x32 bucket crops them off centre (crop_coord (5, 0))."""
    d = tmp_path_factory.mktemp('sdxl_proj')
    rng = np.random.default_rng(4)
    for i in range(4):
        write_png(str(d / f'img_{i}.png'), rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    with open(d / 'captions.json', 'w') as f:
        json.dump({f'img_{i}': f'a photo of dog {i}' for i in range(4)}, f)
    return d


PT = {'train.optimizer_pt': {'_target_': 'optim.adamw', 'weight_decay': 5e-4, 'eps': ADAM_EPS}}
SRC = 'data.dataset1.source.s1'
DA_LORA = {'lora_unet': [{'lr': 1e-3, 'rank': 2, 'branch': 'p',
                          'layers': ['re:.*\\.to_k$', 're:.*\\.to_v$', 're:.*\\.ff$']},
                         {'lr': 4e-4, 'rank': 2, 'branch': 'n',
                          'layers': ['re:.*\\.to_k$', 're:.*\\.to_v$', 're:.*\\.ff$']}],
           'lora_text_encoder': [{'lr': 5e-4, 'rank': 2, 'branch': 'p',
                                  'layers': ['re:.*self_attn$', 're:.*mlp$']},
                                 {'lr': 2e-4, 'rank': 2, 'branch': 'n',
                                  'layers': ['re:.*self_attn$', 're:.*mlp$']}]}
# each case: (world, the words its emb_dir holds, config overrides)
CASES = {
    'textual_inversion': ('sd', ['pt-cat1', 'pt-other'], {
        'tokenizer_pt.train': [{'name': 'pt-cat1', 'lr': 3e-3}],
        f'{SRC}.word_names': {'pt1': 'pt-cat1'}, f'{SRC}.prompt_template': 'a photo of {pt1}'}),
    'custom_diffusion': ('sd', ['pt-new1'], {
        'unet': [{'lr': 1e-3, 'layers': ['re:.*attn2\\.to_k$', 're:.*attn2\\.to_v$']}],
        'tokenizer_pt.train': [{'name': 'pt-new1', 'lr': 3e-3}], 'model.ema': {'decay_max': 0.99},
        f'{SRC}.word_names': {'pt1': 'pt-new1'}, f'{SRC}.prompt_template': '{pt1} painting'}),
    'dream_artist': ('sd', ['pt-a', 'pt-a-neg'], {
        'tokenizer_pt.train': [{'name': 'pt-a', 'lr': 3e-3}, {'name': 'pt-a-neg', 'lr': 3e-3}],
        'train.cfg_scale': '3.0', f'{SRC}.word_names': {'pt1': ['pt-a', 'pt-a-neg']},
        f'{SRC}.prompt_template': 'a photo of {pt1}'}),
    'dream_artist_pp': ('sd', ['pt-dog1', 'pt-dog1-neg'], {
        **DA_LORA, 'train.cfg_scale': '1.0-3.0:cos',
        'tokenizer_pt.train': [{'name': 'pt-dog1', 'lr': 2.5e-3},
                               {'name': 'pt-dog1-neg', 'lr': 2.5e-3}],
        f'{SRC}.word_names': {'pt1': ['pt-dog1-neg', 'pt-dog1']},
        f'{SRC}.prompt_template': 'a photo of {pt1}'}),
    'sdxl_lora': ('sdxl', ['pt-xl'], {
        **LORA, 'data.dataset1._target_': 'hcpdiff.data.CropInfoPairDataset',
        'tokenizer_pt.train': [{'name': 'pt-xl', 'lr': 3e-3}],
        f'{SRC}.word_names': {'pt1': 'pt-xl'}, f'{SRC}.prompt_template': 'a photo of {pt1}',
        'model.clip_skip': 1, 'model.clip_final_norm': False}),
    'pyramid_noise': ('sd', [], {
        **LORA, 'model.noise_scheduler': {'_target_': 'hcpdiff.noise.PyramidNoiseScheduler',
                                          'discount': 0.8}}),
}


def _case_cfg(proj, sdxl_proj, exp_dir, emb_dir, case, **extra):
    world, _, over = CASES[case]
    cfg = _cfg(proj, exp_dir, **PT, **{'tokenizer_pt.emb_dir': str(emb_dir)}, **over, **extra)
    if world == 'sdxl':
        src = cfg['data']['dataset1']['source']['s1']
        src.update(img_root=str(sdxl_proj), caption_file=str(sdxl_proj / 'captions.json'))
    return cfg


def _jax_pack_as_port(pack, world):
    """The JAX pack in the port's layouts and names (emb as tensors)."""
    pack = jax.tree_util.tree_map(np.asarray, jax.device_get(pack))
    out = {}
    for key, tree in pack.items():
        if key.startswith('emb'):
            out[key] = jax.tree_util.tree_map(torch.from_numpy, tree)
            continue
        module = world[next(m for m in ('unet', 'te2', 'te') if m in key)]
        out[key] = (lora_overlay_from_params(tree, module) if key.startswith('lora')
                    else state_dict_from_params(tree))
    return out


def _jax_draws(key, shape, accum, pyramid=None):
    """The noise (gaussian, or pyramid at discount ``pyramid``) and t the
    JAX step draws from its key, per microbatch."""
    keys = [key] if accum == 1 else list(jax.random.split(key, accum))
    out = []
    for k in keys:
        r_noise, r_t = jax.random.split(k)
        noise = (jpyramid_noise(r_noise, shape, pyramid) if pyramid
                 else jax.random.normal(r_noise, shape))
        out.append((torch.from_numpy(np.array(noise)),
                    torch.from_numpy(np.array(jax.random.randint(r_t, (shape[0],), 0, 1000)))))
    return out


def _run_both(monkeypatch, tmp_path, jw, tw, jcfg, tcfg, pyramid=None):
    """The JAX and port trainers on the same config (the port's pack and
    EMA started from the JAX trainer's), 3 steps each, the port fed the
    JAX draws; -> (jax trainer, port trainer, the JAX losses)."""
    monkeypatch.setattr(jtrainer, 'build_models', lambda *a, **kw: dict(
        jw, tokenizer=JTokenizer.tiny(words=WORDS)))
    mesh = jtrainer.make_mesh
    monkeypatch.setattr(jtrainer, 'make_mesh', lambda **kw: mesh(devices=jax.devices()[:1]))
    jt = jtrainer.Trainer(jcontainerize(jcfg))
    calls, step_fn = [], jt._train_step

    def recorded(state, frozen, batch, rng):
        state, metrics = step_fn(state, frozen, batch, rng)
        calls.append((rng, float(metrics['loss'])))
        return state, metrics
    jt._train_step = recorded

    tt = Trainer(containerize(tcfg), world=tw)
    jpack0 = _jax_pack_as_port(jt.state.pack, tw)
    assert _shapes({k: v for k, v in tt.state.pack.items() if k != 'emb'}) == _shapes(
        {k: v for k, v in jpack0.items() if k != 'emb'})
    with torch.no_grad():
        for tree in (tt.state.pack, tt.state.ema):
            for dst, src in zip(pack_leaves(tree or {}), pack_leaves(jpack0)):
                assert dst.shape == src.shape
                dst.copy_(src)
    assert jt.train() == tt.train(draws=lambda step, di, batch: _jax_draws(
        calls[step][0], tuple(batch['latents'].shape[-4:]), tt.grad_accum, pyramid)) == 3
    return jt, tt, [loss for _, loss in calls]


@pytest.mark.parametrize('case', sorted(CASES))
def test_trainer_matches_jax(proj, sdxl_proj, tmp_path, jax_world, jax_sdxl_world, monkeypatch,
                             case):
    world, words, _ = CASES[case]
    jw = jax_sdxl_world if world == 'sdxl' else jax_world
    tw = port_sdxl_world(jw) if world == 'sdxl' else port_world(jw)
    emb_dir = tmp_path / 'embs'
    emb_dir.mkdir()
    _write_words(emb_dir, words, D_TE + D_TE2 if world == 'sdxl' else D_TE, seed=7)
    cfg = _case_cfg(proj, sdxl_proj, tmp_path / 'jax', emb_dir, case)
    pyramid = cfg['model'].get('noise_scheduler', {}).get('discount')
    jt, tt, losses = _run_both(monkeypatch, tmp_path, jw, tw, cfg,
                               _case_cfg(proj, sdxl_proj, tmp_path / 'port', emb_dir, case,
                                         device='cpu'), pyramid)
    assert tt.dream_artist == jt.dream_artist == (case == 'dream_artist_pp')
    assert tt.noise_kind == jt.noise_kind
    np.testing.assert_allclose(tt.history, losses, rtol=1e-4)
    _assert_packs_close(tt.state.pack, _jax_pack_as_port(jt.state.pack, tw), atol=2e-6)
    if tt.state.ema is not None:
        _assert_packs_close(tt.state.ema, _jax_pack_as_port(jt.state.ema, tw), atol=2e-6)
    if world == 'sdxl':
        batch = next(iter(tdataset.CycleData(tt.datasets[0])))
        assert batch['time_ids'].tolist() == [[48, 64, 0, 5, 32, 32]] * 2

    for part in ('unet', 'te', 'te2'):
        jfile = tmp_path / 'jax' / 'ckpts' / f'{NAMES[part]}-3.safetensors'
        tfile = tmp_path / 'port' / 'ckpts' / f'{NAMES[part]}-3.safetensors'
        lora, ft = f'lora_{part}', f'{part}_ft'
        assert jfile.exists() == tfile.exists() == (lora in tt.pack or ft in tt.pack)
        if not tfile.exists():
            continue
        assert sorted(safetensors_io.load_file(str(tfile))) == sorted(load_safetensors(str(jfile)))
        mine = tt.ckpt_manager.load_ckpt(str(tfile), aliases=tt.aliases[part])
        theirs = tt.ckpt_manager.load_ckpt(str(jfile), aliases=tt.aliases[part])
        in_jax = jt.ckpt_manager.load_ckpt(str(tfile), aliases=jt.aliases[part])
        for key, kind in ((lora, 'lora'), (ft, 'base')):
            if key in tt.pack:
                _assert_packs_close(mine[kind], tt.pack[key], atol=0)
                _assert_packs_close(theirs[kind], mine[kind], atol=2e-6)
                _assert_packs_close(_jax_pack_as_port({key: in_jax[kind]}, tw)[key], mine[kind],
                                    atol=0)
    saved = sorted(f for f in os.listdir(tmp_path / 'port' / 'ckpts') if f.endswith('.pt'))
    trained = [item['name'] for item in cfg['tokenizer_pt']['train'] or []]
    assert saved == sorted(f for f in os.listdir(tmp_path / 'jax' / 'ckpts') if f.endswith('.pt'))
    assert saved == sorted(f'{w}-3.pt' for w in trained)
    for f in saved:
        name, vecs = load_webui_embedding(str(tmp_path / 'port' / 'ckpts' / f))
        jname, jvecs = jload_embedding(str(tmp_path / 'jax' / 'ckpts' / f))
        assert name == jname and vecs.shape == (2, D_TE + D_TE2 if world == 'sdxl' else D_TE)
        np.testing.assert_allclose(vecs, jvecs, atol=2e-6, rtol=0)


def _resume_cfg(proj, exp_dir, emb_dir, **over):
    cfg = _case_cfg(proj, None, exp_dir, emb_dir, 'textual_inversion',
                    **LORA, **{'model.ema': {'decay_max': 0.9999}, 'train.train_steps': 4,
                               'train.save_step': 2, 'train.preemption': True, 'device': 'cpu'})
    cfg['train'].update(over)
    return containerize(cfg)


@pytest.fixture
def emb_dir(tmp_path):
    d = tmp_path / 'embs'
    d.mkdir()
    _write_words(d, ['pt-cat1', 'pt-other'], D_TE, seed=8)
    return d


def test_interrupted_run_resumes_bitwise_with_the_words(proj, tmp_path, emb_dir):
    """4 steps of LoRA + a word, against 2 steps stopped by SIGTERM and 2
    through resume.auto: the same losses, pack (every emb row) and EMA, bit
    for bit; the state holds both optimizers."""
    whole = Trainer(_resume_cfg(proj, tmp_path / 'whole', emb_dir))
    assert whole.train() == 4
    first = Trainer(_resume_cfg(proj, tmp_path / 'cut', emb_dir))
    log = first.loggers.log

    def log_then_signal(datas, step):
        log(datas, step)
        if step == 2:
            signal.raise_signal(signal.SIGTERM)
    first.loggers.log = log_then_signal
    assert first.train() == 2 and first.preempted
    assert first.state.optimizer_pt.state and first.states.restore(2)['optimizer_pt']['state']
    rest = Trainer(_resume_cfg(proj, tmp_path / 'cut', emb_dir, resume={'auto': True}))
    assert rest.state.step == 2 and rest.train() == 4
    assert rest.history == whole.history[2:]
    for part in ('pack', 'ema'):
        for a, b in zip(pack_leaves(getattr(rest.state, part)),
                        pack_leaves(getattr(whole.state, part))):
            assert torch.equal(a, b)


def test_words_resume_loads_the_saved_rows(proj, tmp_path, emb_dir):
    """train.resume.ckpt_path.words: the named word's rows start as the
    saved file holds them; the other words' rows as the emb_dir's."""
    first = Trainer(_resume_cfg(proj, tmp_path / 'a', emb_dir))
    assert first.train() == 4
    saved = tmp_path / 'a' / 'ckpts' / 'pt-cat1-4.pt'
    second = Trainer(_resume_cfg(proj, tmp_path / 'b', emb_dir, resume={
        'ckpt_path': {'words': {'pt-cat1': str(saved), 'pt-unknown': str(saved)}}}))
    rows = second.state.pack['emb']
    sl, other = second.emb_slices['pt-cat1'], second.emb_slices['pt-other']
    assert torch.equal(rows[sl], torch.from_numpy(load_webui_embedding(str(saved))[1]))
    assert torch.equal(rows[sl], first.state.pack['emb'][sl].detach())
    assert torch.equal(rows[other], torch.from_numpy(
        load_webui_embedding(str(emb_dir / 'pt-other.pt'))[1]))


def test_dreamartist_and_crop_info_batches_match_jax(proj, sdxl_proj, tmp_path):
    """DreamArtist's collate ([neg..., pos...], an unpaired prompt doubled)
    and the crop-info time_ids bitwise the JAX dataset's over two epochs:
    latents cached in memory (the crops' geometry kept), read back from the
    disk cache (no geometry: the uncropped default), or not cached (the
    seeded random crops)."""
    kw = dict(prompt_template='{pt1} and {pt2}', word_names={'pt1': ['neg', 'pos'],
                                                             'pt2': 'cat'})
    for root, da, crop, cache, extra in ((proj / 'imgs', True, False, 'memory', kw),
                                         (proj / 'imgs', True, False, 'memory', {}),
                                         (sdxl_proj, False, True, 'memory', {}),
                                         (sdxl_proj, False, True, 'disk', {}),
                                         (sdxl_proj, False, True, None, {})):
        out = []
        for name, src_mod, bk_mod, ds_mod, fe in (
                ('jax', jsources, jbuckets, jdataset,
                 JFrontend(JTokenizer.tiny(words=WORDS), None, None)),
                ('port', tsources, tbuckets, tdataset,
                 TFrontend(TTokenizer.tiny(words=WORDS), None))):
            def dataset(cache_dir=None):
                ds = ds_mod.TextImagePairDataset(
                    src_mod.Text2ImageSource(str(root), **extra),
                    bk_mod.FixedBucket(target_size=32), frontend=fe, vae_scale=2,
                    cache_dir=cache_dir, dream_artist=da, with_crop_info=crop)
                return ds.build(2)
            ds = dataset(str(tmp_path / name) if cache == 'disk' else None)
            if cache:
                ds.cache_all_latents(lambda x: x[:, ::2, ::2, :3] + 0)
            if cache == 'disk':
                ds = dataset(str(tmp_path / name))
                assert ds.load_latent_cache()
            it = iter(ds_mod.CycleData(ds))
            out.append([next(it) for _ in range(4)])
        for jb, tb in zip(*out):
            assert sorted(jb) == sorted(tb)
            for key in tb:
                np.testing.assert_array_equal(np.asarray(tb[key]), np.asarray(jb[key]), key)
            assert tb['input_ids'].shape[0] == (4 if da else 2)
            assert ('time_ids' in tb) == crop
            if cache == 'disk':
                assert tb['time_ids'].tolist() == [[32, 32, 0, 0, 32, 32]] * 2


@pytest.mark.parametrize('ramp', ['cos', 'cos2', 'ln', 'linear'])
def test_dreamartist_scale_matches_jax(ramp):
    t = np.arange(0, 1000, 37)
    want = np.asarray(jstep._da_scale(jnp.asarray(t), 1000, 1.0, 3.0, ramp))
    np.testing.assert_allclose(da_scale(torch.from_numpy(t), 1000, 1.0, 3.0, ramp).numpy(),
                               want, rtol=1e-6, atol=1e-6)


def test_cfg_range_matches_jax():
    for text in ('1.0', '3.0', '1.0-3.0:cos', '-1.5-2:ln', '2.5:cos2', 1.0):
        assert get_cfg_range(text) == jcfg_range(text)


@pytest.mark.parametrize('shape', [(2, 8, 8, 4), (1, 16, 12, 4), (2, 64, 64, 4), (1, 7, 5, 4)])
def test_pyramid_noise_from_the_jax_draws(shape):
    """pyramid_combine on the JAX package's per-level draws (the split of
    its key) against its pyramid_noise."""
    key = jax.random.PRNGKey(sum(shape))
    keys = jax.random.split(key, 6)
    draws = [torch.from_numpy(np.array(jax.random.normal(keys[i], s)))
             for i, s in enumerate(pyramid_sizes(shape))]
    np.testing.assert_allclose(pyramid_combine(draws, 0.8).numpy(),
                               np.asarray(jpyramid_noise(key, shape, 0.8)), atol=2e-6, rtol=0)


def test_sdxl_dual_encode_and_its_gradients_match_jax(jax_sdxl_world):
    """encode_ids with both encoders' weights and emb_ext tables against
    encode_ids_dual: (ctx, pooled), and the gradients of a weighted sum of
    them with respect to the tables and a weight of each encoder."""
    jw, tw = jax_sdxl_world, port_sdxl_world(jax_sdxl_world)
    tk = TTokenizer.tiny(words=WORDS)
    word = tk.add_word('pt-xl', 2)
    jfe = jsdxl.SDXLTextEncoderFrontend(JTokenizer.tiny(words=WORDS), jw['te'], jw['te_params'],
                                        jw['te2'], jw['te2_params'])
    tfe = tsdxl.SDXLTextEncoderFrontend(tk, tw['te'], tw['te2'])
    ids, mult = tfe.tokenize_batch(['a photo of pt-xl cat', 'a {dog:1.3} painting'])
    assert word[0] in ids
    rng = np.random.default_rng(9)
    ext = {'clip_L': rng.standard_normal((2, D_TE)).astype(np.float32),
           'clip_bigG': rng.standard_normal((2, D_TE2)).astype(np.float32)}
    w_ctx = rng.standard_normal((2, 77, D_TE + D_TE2)).astype(np.float32)
    w_pool = rng.standard_normal((2, D_TE2)).astype(np.float32)

    def jloss(p1, p2, e):
        ctx, pooled = jfe.encode_ids_dual(p1, p2, jnp.asarray(ids), jnp.asarray(mult), emb_ext=e)
        return jnp.sum(ctx * w_ctx) + jnp.sum(pooled * w_pool), (ctx, pooled)
    (_, (jctx, jpooled)), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                             has_aux=True))(
        jw['te_params'], jw['te2_params'], ext)

    names = ('layers_0.self_attn.q_proj.weight', 'final_layer_norm.weight')
    params = {'te': {names[0]: tw['te'].get_parameter(names[0]).detach().clone()},
              'te2': {names[1]: tw['te2'].get_parameter(names[1]).detach().clone()}}
    text = {k: torch.from_numpy(v) for k, v in ext.items()}
    for t in pack_leaves(params) + list(text.values()):
        t.requires_grad_(True)
    ctx, pooled = tfe.encode_ids(torch.from_numpy(ids), torch.from_numpy(mult), params=params,
                                 emb_ext=text)
    ((ctx * torch.from_numpy(w_ctx)).sum() + (pooled * torch.from_numpy(w_pool)).sum()).backward()
    np.testing.assert_allclose(ctx.detach().numpy(), np.asarray(jctx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(jpooled), atol=1e-5, rtol=0)
    for k in ext:
        np.testing.assert_allclose(text[k].grad.numpy(), np.asarray(jgrads[2][k]), atol=1e-4,
                                   rtol=1e-4)
    jq = state_dict_from_params({'layers_0': {'self_attn': {'q_proj': jgrads[0]['layers_0'][
        'self_attn']['q_proj']}}})[names[0]]
    np.testing.assert_allclose(params['te'][names[0]].grad.numpy(), jq.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(params['te2'][names[1]].grad.numpy(),
                               np.asarray(jgrads[1]['final_layer_norm']['scale']), atol=1e-4,
                               rtol=1e-4)
    with torch.no_grad():
        plain = tfe.encode_ids(torch.from_numpy(ids), torch.from_numpy(mult), emb_ext=text)
    assert not plain[0].requires_grad


@pytest.mark.parametrize('init_text', [None, 'a photo of cat *[0.02, 2]'])
def test_create_embedding_matches_jax(tmp_path, jax_world, monkeypatch, init_text):
    """The port's tool against the JAX tool on the same tiny model (the
    JAX world's encoder table and tokenizer): the same vectors, bitwise."""
    monkeypatch.setattr(jcreate, 'build_models', lambda *a, **kw: dict(
        jax_world, tokenizer=JTokenizer.tiny(words=WORDS)))
    world = port_world(jax_world)
    monkeypatch.setattr(tcreate, 'build_models', lambda *a, **kw: world)
    jpath = jcreate.PTCreator('tiny', str(tmp_path / 'jax')).creat_word_pt('pt-w', 5, init_text)
    tpath = tcreate.main(['tiny', 'pt-w', '5', '--root', str(tmp_path / 'port')]
                         + (['--init_text', init_text] if init_text else []))
    name, vecs = load_webui_embedding(tpath)
    jname, jvecs = jload_embedding(jpath)
    assert name == jname == 'pt-w' and vecs.shape == (5, D_TE)
    np.testing.assert_array_equal(vecs, jvecs)
    with pytest.raises(FileExistsError):
        tcreate.main(['tiny', 'pt-w', '5', '--root', str(tmp_path / 'port')])
