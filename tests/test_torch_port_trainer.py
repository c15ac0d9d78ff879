"""The port's config-driven trainer against the JAX package's, at tiny
widths in fp32 on the CPU:

- the JAX ``Trainer`` and the port's on the same config and the same
  weights (the JAX trainer's world, carried across by ``ckpt/bridge.py``
  as ``Trainer(world=...)``), the port's pack set from the JAX pack and
  fed the JAX trainer's noise and timesteps (``train(draws=...)``): the
  same pack keys and shapes, and 3 steps' losses within rtol 1e-4 and
  every pack leaf within atol 2e-6 (``test_torch_port_train.py``'s step
  tolerances), for UNet + text-encoder LoRA under
  ``gradient_accumulation_steps: 2``, and layer-wise UNet fine-tuning
  with EMA; each
  case's saved ``unet-3``/``text_encoder-3`` files hold the same keys as
  the JAX trainer's and load in the other package's ``load_ckpt``;
- a run interrupted by SIGTERM and continued by ``resume.auto`` equals
  the uninterrupted run bit for bit (losses, pack, EMA);
- every ``cfgs/train/examples`` config: the eighteen the port trains run
  through ``main()`` on the tiny worlds (Lion's optimizer, the previewer's
  PNGs at 32 px, the TensorBoard file's losses and the W&B warning
  checked) (``tiny_sdxl`` for the SDXL ones;
  paths, steps, device, fp32 and a small bucket overridden; the words of
  the prompt-tuning configs made first by ``tools/create_embedding.py``;
  ``lora_conventional.yaml`` in a subprocess that then checks it loaded
  no ``jax``, ``hcpdiff_tpu``, ``optax``, ``PIL`` or ``yaml`` module), the
  others raise ``NotImplementedError`` naming their ROADMAP item.
"""
import importlib.util
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.ckpt.formats import load_safetensors
from hcpdiff_tpu.config import containerize as jcontainerize
from hcpdiff_tpu.models import clip as jclip
from hcpdiff_tpu.models import factory as jfactory
from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu.models import vae as jvae
from hcpdiff_tpu.trainer import trainer as jtrainer
from hcpdiff_tpu.utils.clip_tokenizer import CLIPTokenizer as JTokenizer
from hcpdiff_tpu_torch.ckpt import safetensors_io
from hcpdiff_tpu_torch.ckpt.bridge import (load_params, lora_overlay_from_params,
                                           state_dict_from_params)
from hcpdiff_tpu_torch.config import containerize
from hcpdiff_tpu_torch.models import clip as tclip
from hcpdiff_tpu_torch.models import factory as tfactory
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.models import vae as tvae
from hcpdiff_tpu_torch.trainer.step import pack_leaves
from hcpdiff_tpu_torch.trainer.trainer import Trainer, main
from hcpdiff_tpu_torch.utils.clip_tokenizer import CLIPTokenizer as TTokenizer
from hcpdiff_tpu_torch.utils.images import read_png, write_png
from tests.torch_port_common import random_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / 'cfgs' / 'train' / 'examples'
WORDS = ['cat', 'dog', 'photo', 'painting']
# see test_torch_port_train.py: at Adam's default eps a gradient element
# at fp32 noise level moves by a full lr
ADAM_EPS = 1e-3


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Tiny models gain nothing from intra-op threads, and the suite's
    parallel workers would oversubscribe the cores with them (10x slower
    under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def proj(tmp_path_factory):
    """64x64 PNGs with captions; DreamBooth's instance and class folders."""
    d = tmp_path_factory.mktemp('proj')
    rng = np.random.default_rng(3)
    for sub, n in (('imgs', 4), ('instance', 2), ('class/2_dog', 2)):
        (d / sub).mkdir(parents=True)
        for i in range(n):
            write_png(str(d / sub / f'img_{i}.png'),
                      rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    with open(d / 'imgs' / 'captions.json', 'w') as f:
        json.dump({f'img_{i}': f'a photo of cat {i}' for i in range(4)}, f)
    return d


@pytest.fixture(scope='module')
def jax_world():
    """The JAX factory's tiny world, its weights from random_params (no
    flax init to run)."""
    tk = JTokenizer.tiny(words=WORDS)
    te_cfg = jclip.CLIPTextConfig.tiny(vocab_size=tk.vocab_size, eos_token_id=tk.eos_token_id,
                                       bos_token_id=tk.bos_token_id)
    unet_cfg = junet.UNetConfig.tiny(cross_attention_dim=te_cfg.hidden_size)
    vae_cfg = jvae.VAEConfig.tiny()
    unet = junet.UNet2DCondition(unet_cfg, dtype=jnp.float32)
    vae = jvae.AutoencoderKL(vae_cfg, dtype=jnp.float32)
    te = jclip.CLIPTextModel(te_cfg, dtype=jnp.float32)
    return {'sdxl': False, 'unet': unet, 'unet_cfg': unet_cfg, 'vae': vae, 'vae_cfg': vae_cfg,
            'te': te, 'te_cfg': te_cfg, 'tokenizer': tk,
            'unet_params': random_params(unet, jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                                         jnp.zeros((1, 77, te_cfg.hidden_size)), seed=40),
            'vae_params': random_params(vae, jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(0),
                                        seed=41),
            'te_params': random_params(te, jnp.zeros((1, 77), jnp.int32), seed=42),
            'aliases': {'unet': jfactory.unet_alias_map(unet_cfg),
                        'te': jfactory.clip_alias_map(te_cfg),
                        'vae': jfactory.vae_alias_map(vae_cfg)}}


def port_world(jw):
    """The port's world on the JAX world's weights (CPU, fp32)."""
    te_cfg = tclip.CLIPTextConfig.tiny(vocab_size=jw['te_cfg'].vocab_size,
                                       eos_token_id=jw['te_cfg'].eos_token_id,
                                       bos_token_id=jw['te_cfg'].bos_token_id)
    unet_cfg = tunet.UNetConfig.tiny(cross_attention_dim=te_cfg.hidden_size)
    vae_cfg = tvae.VAEConfig.tiny()
    return {'sdxl': False, 'unet_cfg': unet_cfg, 'vae_cfg': vae_cfg, 'te_cfg': te_cfg,
            'unet': tfactory._finish(load_params(tunet.UNet2DCondition(unet_cfg),
                                                 jw['unet_params'])),
            'vae': tfactory._finish(load_params(tvae.AutoencoderKL(vae_cfg), jw['vae_params'])),
            'te': tfactory._finish(load_params(tclip.CLIPTextModel(te_cfg), jw['te_params'])),
            'tokenizer': TTokenizer.tiny(words=WORDS),
            'aliases': {'unet': tfactory.unet_alias_map(unet_cfg),
                        'te': tfactory.clip_alias_map(te_cfg),
                        'vae': tfactory.vae_alias_map(vae_cfg)}}


def _cfg(proj, exp_dir, **over):
    cfg = {
        'exp_dir': str(exp_dir), 'mixed_precision': 'fp32', 'seed': 1,
        'ckpt_type': 'safetensors',
        'train': {'train_steps': 3, 'save_step': 3, 'gradient_accumulation_steps': 1,
                  'max_grad_norm': 1.0, 'cfg_scale': '1.0', 'preemption': False,
                  'loss': {'criterion': {'_target_': 'hcpdiff_tpu.diffusion.losses.MinSNRLoss',
                                         'gamma': 2.0}},
                  'optimizer': {'_target_': 'optim.adamw', 'weight_decay': 1e-3,
                                'eps': ADAM_EPS},
                  'scheduler': {'name': 'constant_with_warmup', 'num_warmup_steps': 1,
                                'num_training_steps': 3}},
        'model': {'pretrained_model_name_or_path': 'tiny', 'gradient_checkpointing': False},
        'logger': [{'_target_': 'hcpdiff_tpu.loggers.CLILogger', 'log_step': 1}],
        'data': {'dataset1': {
            'batch_size': 2, 'cache_latents': True,
            'source': {'s1': {'img_root': str(proj / 'imgs'),
                              'caption_file': str(proj / 'imgs' / 'captions.json')}},
            'bucket': {'_target_': 'FixedBucket', 'target_size': 32}}},
        'tokenizer_pt': {'emb_dir': None, 'train': None},
    }
    for key, value in over.items():
        node = cfg
        *parents, leaf = key.split('.')
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


LORA = {'lora_unet': [{'lr': 1e-3, 'rank': 2, 'layers': ['re:.*\\.attn.?$', 're:.*\\.ff$']}],
        'lora_text_encoder': [{'lr': 5e-4, 'rank': 2,
                               'layers': ['re:.*self_attn$', 're:.*mlp$']}]}
CASES = {
    'lora_unet_te': LORA,
    'lora_unet_te_grad_accum_2': {**LORA, 'train.gradient_accumulation_steps': 2},
    'unet_ft_ema': {'unet': [{'lr': 1e-3, 'layers': ['re:.*attn2\\.to_(k|v)$',
                                                     're:.*time_embedding.*']}],
                    'model.ema': {'decay_max': 0.9999}},
}


def _jax_pack_as_port(pack, world):
    """The JAX pack in the port's layouts and names."""
    pack = jax.tree_util.tree_map(np.asarray, jax.device_get(pack))
    out = {}
    for key, tree in pack.items():
        module = world['unet'] if 'unet' in key else world['te']
        out[key] = (lora_overlay_from_params(tree, module) if key.startswith('lora')
                    else state_dict_from_params(tree))
    return out


def _shapes(pack):
    return {k: {p: (tuple(v.shape) if torch.is_tensor(v) else
                    {kk: tuple(vv.shape) for kk, vv in v.items()})
                for p, v in tree.items()} for k, tree in pack.items()}


def _assert_packs_close(got, want, atol):
    assert sorted(got) == sorted(want)
    for g, w in zip(pack_leaves(got), pack_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), atol=atol, rtol=0)


def _jax_draws(key, shape, accum):
    """The noise and t the JAX step draws from its key, per microbatch
    (test_torch_port_train.py's)."""
    keys = [key] if accum == 1 else list(jax.random.split(key, accum))
    out = []
    for k in keys:
        r_noise, r_t = jax.random.split(k)
        out.append((torch.from_numpy(np.array(jax.random.normal(r_noise, shape))),
                    torch.from_numpy(np.array(jax.random.randint(r_t, (shape[0],), 0, 1000)))))
    return out


@pytest.mark.parametrize('case', sorted(CASES))
def test_trainer_matches_jax(proj, tmp_path, jax_world, monkeypatch, case):
    over = CASES[case]
    monkeypatch.setattr(jtrainer, 'build_models', lambda *a, **kw: dict(jax_world))
    # one device: the JAX batch_size is per device (the suite runs 8 CPU devices)
    mesh = jtrainer.make_mesh
    monkeypatch.setattr(jtrainer, 'make_mesh', lambda **kw: mesh(devices=jax.devices()[:1]))
    jt = jtrainer.Trainer(jcontainerize(_cfg(proj, tmp_path / 'jax', **over)))
    calls, step_fn = [], jt._train_step

    def recorded(state, frozen, batch, rng):
        state, metrics = step_fn(state, frozen, batch, rng)
        calls.append((rng, float(metrics['loss'])))
        return state, metrics
    jt._train_step = recorded

    world = port_world(jax_world)
    tt = Trainer(containerize(_cfg(proj, tmp_path / 'port', device='cpu', **over)), world=world)
    jpack0 = _jax_pack_as_port(jt.state.pack, world)
    assert _shapes(tt.state.pack) == _shapes(jpack0)
    with torch.no_grad():                           # start from the JAX trainer's pack
        for tree in (tt.state.pack, tt.state.ema):
            for dst, src in zip(pack_leaves(tree or {}), pack_leaves(jpack0)):
                dst.copy_(src)

    assert jt.train() == tt.train(draws=lambda step, di, batch: _jax_draws(
        calls[step][0], tuple(batch['latents'].shape[-4:]), tt.grad_accum)) == 3
    np.testing.assert_allclose(tt.history, [loss for _, loss in calls], rtol=1e-4)
    _assert_packs_close(tt.state.pack, _jax_pack_as_port(jt.state.pack, world), atol=2e-6)
    if tt.state.ema is not None:
        _assert_packs_close(tt.state.ema, _jax_pack_as_port(jt.state.ema, world), atol=2e-6)

    # the saved files: the JAX trainer's keys, loadable by both packages
    for name, alias, lora, ft in (('unet', 'unet', 'lora_unet', 'unet_ft'),
                                  ('text_encoder', 'te', 'lora_te', 'te_ft')):
        jfile = tmp_path / 'jax' / 'ckpts' / f'{name}-3.safetensors'
        tfile = tmp_path / 'port' / 'ckpts' / f'{name}-3.safetensors'
        assert jfile.exists() == tfile.exists() == (lora in tt.pack or ft in tt.pack)
        if not tfile.exists():
            continue
        assert sorted(safetensors_io.load_file(str(tfile))) == sorted(load_safetensors(str(jfile)))
        mine = tt.ckpt_manager.load_ckpt(str(tfile), aliases=tt.aliases[alias])
        theirs = tt.ckpt_manager.load_ckpt(str(jfile), aliases=tt.aliases[alias])
        in_jax = jt.ckpt_manager.load_ckpt(str(tfile), aliases=jt.aliases[alias])
        for key, part in ((lora, 'lora'), (ft, 'base')):
            if key not in tt.pack:
                continue
            _assert_packs_close(mine[part], tt.pack[key], atol=0)
            _assert_packs_close(theirs[part], mine[part], atol=2e-6)
            _assert_packs_close(_jax_pack_as_port({key: in_jax[part]}, world)[key], mine[part],
                                atol=0)
        if tt.state.ema is not None:
            _assert_packs_close(mine['base_ema'], tt.state.ema[ft], atol=0)


def _resume_cfg(proj, exp_dir, **over):
    cfg = _cfg(proj, exp_dir, **LORA, **{'model.ema': {'decay_max': 0.9999},
                                         'train.train_steps': 4, 'train.save_step': 2,
                                         'train.preemption': True, 'device': 'cpu',
                                         'data.dataset1.cache_latents': False})
    cfg['train'].update(over)
    return containerize(cfg)


def test_interrupted_run_resumes_bitwise(proj, tmp_path):
    """Uninterrupted 4 steps, against 2 steps stopped by SIGTERM and 2 more
    through resume.auto: the same losses, pack and EMA, bit for bit (the
    data position crosses an epoch; the noise comes from the generator)."""
    whole = Trainer(_resume_cfg(proj, tmp_path / 'whole'))
    assert whole.train() == 4

    first = Trainer(_resume_cfg(proj, tmp_path / 'cut'))
    log = first.loggers.log

    def log_then_signal(datas, step):
        log(datas, step)
        if step == 2:
            signal.raise_signal(signal.SIGTERM)
    first.loggers.log = log_then_signal
    assert first.train() == 2 and first.preempted
    assert first.states.steps() == [2]

    rest = Trainer(_resume_cfg(proj, tmp_path / 'cut', resume={'auto': True}))
    assert rest.state.step == 2 and rest.data_pos == [(1, 0)]
    assert rest.train() == 4
    assert rest.history == whole.history[2:]
    for part in ('pack', 'ema'):
        for a, b in zip(pack_leaves(getattr(rest.state, part)),
                        pack_leaves(getattr(whole.state, part))):
            assert torch.equal(a, b)
    assert rest.states.steps() == [2, 4]


def test_weight_only_resume_loads_saved_files(proj, tmp_path):
    """train.resume.ckpt_path (the reference's weight-only resume): a new
    run's pack and EMA start as the saved unet-4 and text_encoder-4 files
    hold them, bit for bit, at resume.start_step."""
    first = Trainer(_resume_cfg(proj, tmp_path / 'a'))
    assert first.train() == 4
    ckpts = tmp_path / 'a' / 'ckpts'
    second = Trainer(_resume_cfg(proj, tmp_path / 'b', resume={
        'start_step': 4, 'ckpt_path': {'unet': [str(ckpts / 'unet-4.safetensors')],
                                       'TE': [str(ckpts / 'text_encoder-4.safetensors')]}}))
    assert second.start_step == 4
    for part in ('pack', 'ema'):
        for a, b in zip(pack_leaves(getattr(second.state, part)),
                        pack_leaves(getattr(first.state, part))):
            assert torch.equal(a, b)


RUNS = {  # config -> overrides beyond paths, steps and the device
    'lora_conventional.yaml': [],
    'min_snr.yaml': [],
    'locon.yaml': [],
    'fine-tuning.yaml': [],
    'ema.yaml': [],
    'DreamBooth.yaml': ['data.dataset_class.bucket.target_size=32'],
    'TextualInversion.yaml': [],
    'CustomDiffusion.yaml': [],
    'lora_anime_character.yaml': [],
    'DreamArtist.yaml': [],
    'DreamArtist++.yaml': [],
    'lora_sdxl.yaml': ['model.pretrained_model_name_or_path=tiny_sdxl'],
    'FT_sdxl.yaml': ['model.pretrained_model_name_or_path=tiny_sdxl'],
    'sd21_vpred.yaml': [],
    'controlnet.yaml': ['data.dataset1.bucket.target_size=32'],
    'Lion_optimizer.yaml': [],
    # a 32 px, 2-step preview at every step
    'preview_in_training.yaml': ['previewer.image_log_step=1', 'previewer.width=32',
                                 'previewer.height=32', 'previewer.num_steps=2'],
    'add_logger_tensorboard_wandb.yaml': [],
}
REFUSED = {'FT_sdxl_zero3.yaml': 8}
# the words each prompt-tuning config trains (made by create_embedding first)
WORDS_OF = {'TextualInversion.yaml': ['pt-cat1'], 'CustomDiffusion.yaml': ['pt-new1'],
            'lora_anime_character.yaml': ['pt-char1'],
            'DreamArtist.yaml': ['pt-catgirl1', 'pt-catgirl1-neg'],
            'DreamArtist++.yaml': ['pt-dog1', 'pt-dog1-neg']}


def _run_args(name, proj, tmp_path):
    """The config with the tiny world, this test's data, 2 steps on the CPU
    in fp32, and buckets small enough for the CPU."""
    src = 'data.dataset1.source.data_source1'
    args = ['--cfg', str(EXAMPLES / name), 'model.pretrained_model_name_or_path=tiny',
            'device=cpu', 'mixed_precision=fp32', f'exp_dir={tmp_path / "exp"}',
            'train.train_steps=2', 'train.save_step=2', 'logger.0.log_step=1',
            f'tokenizer_pt.emb_dir={tmp_path / "embs"}']
    if name == 'DreamBooth.yaml':
        args += [f'{src}.img_root={proj / "instance"}', 'data.dataset1.bucket.target_size=32',
                 f'data.dataset_class.source.data_source1.img_root={proj / "class"}']
    else:
        if name == 'controlnet.yaml':          # the images are their own condition
            args += [f'{src}.cond_root={proj / "imgs"}']
        args += [f'{src}.img_root={proj / "imgs"}',
                 f'{src}.caption_file={proj / "imgs" / "captions.json"}',
                 'data.dataset1.bucket.target_area=1024', 'data.dataset1.bucket.step_size=16']
    return args + RUNS[name]


def test_every_example_config_is_run_or_refused():
    assert sorted(RUNS) + sorted(REFUSED) and (
        sorted(p.name for p in EXAMPLES.glob('*.yaml')) == sorted(list(RUNS) + list(REFUSED)))


@pytest.mark.parametrize('name', sorted(set(RUNS) - {'lora_conventional.yaml'}))
def test_example_config_trains(proj, tmp_path, monkeypatch, name):
    monkeypatch.setenv('WANDB_MODE', 'disabled')       # where wandb is installed: no network
    from hcpdiff_tpu_torch.tools.create_embedding import main as create_embedding
    for word in WORDS_OF.get(name, []):
        create_embedding(['tiny', word, '2', '--init_text', 'a photo of cat', '--root',
                          str(tmp_path / 'embs')])
    trainer = main(_run_args(name, proj, tmp_path))
    assert len(trainer.history) == 2 * len(trainer.datasets)
    assert all(np.isfinite(trainer.history))
    ckpts = sorted(os.listdir(tmp_path / 'exp' / 'ckpts'))
    models = {'unet': 'unet', 'te': 'text_encoder', 'te2': 'text_encoder_2'}
    assert ckpts == sorted([f'{models[m]}-2.safetensors' for m in models
                            if f'lora_{m}' in trainer.pack or f'{m}_ft' in trainer.pack]
                           + [f'{w}-2.pt' for w in WORDS_OF.get(name, [])]
                           + ['plugin-2.safetensors'] * ('controlnet' in trainer.pack))
    assert ('controlnet' in trainer.pack) == (name == 'controlnet.yaml')
    assert trainer.sdxl == ('sdxl' in name) and trainer.dream_artist == (name == 'DreamArtist++.yaml')
    assert ('emb' in trainer.pack) == (name in WORDS_OF)
    assert trainer.noise_schedule.prediction_type == (
        'v_prediction' if name == 'sd21_vpred.yaml' else 'epsilon')
    if name == 'lora_sdxl.yaml':
        assert sorted(trainer.pack) == ['lora_te', 'lora_te2', 'lora_unet']
    if name in ('fine-tuning.yaml', 'ema.yaml', 'DreamBooth.yaml', 'FT_sdxl.yaml'):  # layers: ['']
        assert len(trainer.pack['unet_ft']) == len(list(trainer.unet.parameters()))
    if name == 'DreamBooth.yaml':
        assert len(trainer.datasets) == 2
        assert [len(s) for s in trainer.step_shapes] == [2, 2]
    if name == 'Lion_optimizer.yaml':
        assert type(trainer.state.optimizer).__name__ == 'Lion'
    if name == 'preview_in_training.yaml':
        for step in (1, 2):
            img = read_png(str(tmp_path / 'exp' / 'imgs' / f'{step}-preview.png'))
            assert img.shape == (32, 32, 3) and img.std() > 0
    if name == 'add_logger_tensorboard_wandb.yaml':
        from hcpdiff_tpu_torch.utils.tb_events import read_events
        (events,) = (tmp_path / 'exp' / 'tb').iterdir()
        got = [(v['tag'], e['step']) for e in read_events(str(events)) for v in e['values']]
        assert got == [('loss', 1), ('step', 1), ('loss', 2), ('step', 2)]
        warned = 'the wandb package is not installed' in (tmp_path / 'exp' / 'train.log').read_text()
        assert warned == (importlib.util.find_spec('wandb') is None)


def test_main_trains_lora_conventional_without_jax(proj, tmp_path):
    """python -m hcpdiff_tpu_torch.train on lora_conventional.yaml, in a
    fresh interpreter that then lists the JAX, PIL and yaml modules it
    loaded: none."""
    code = ('import sys\n'
            'from hcpdiff_tpu_torch.train import main\n'
            'trainer = main(sys.argv[1:])\n'
            'assert len(trainer.history) == 2, trainer.history\n'
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hcpdiff_tpu', 'PIL', 'yaml', "
            "'safetensors'))\n"
            'print(bad)\n')
    args = [sys.executable, '-c', code] + _run_args('lora_conventional.yaml', proj, tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    res = subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == '[]'
    assert sorted(os.listdir(tmp_path / 'exp' / 'ckpts')) == ['text_encoder-2.safetensors',
                                                             'unet-2.safetensors']


@pytest.mark.parametrize('name', sorted(REFUSED))
def test_unported_example_config_raises(tmp_path, name):
    with pytest.raises(NotImplementedError, match=f'ROADMAP.md queue 1 item {REFUSED[name]}'):
        main(['--cfg', str(EXAMPLES / name), f'exp_dir={tmp_path / "exp"}', 'device=cpu'])


def test_no_card_raises_without_device_cpu(proj, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='device=cpu'):
        main(_run_args('lora_conventional.yaml', proj, tmp_path) + ['device=cuda'])


def test_conv_and_linear_lora_files_match_jax(jax_world, tmp_path):
    """A LoRA on convs and linears (locon.yaml's layers) saved by both
    packages' managers from the same factors: the same keys and the same
    tensors (conv factors 4-D: W_down [r, cin, kh, kw], W_up [out, r, 1,
    1]), and each file loads in the other package to the same overlay."""
    from hcpdiff_tpu.adapt import overlay as jov
    from hcpdiff_tpu.ckpt.manager import CkptManagerSafe as JManager
    from hcpdiff_tpu_torch.ckpt.manager import CkptManagerSafe as TManager
    world = port_world(jax_world)
    aliases = jax_world['aliases']['unet']
    specs = [{'layers': ['re:.*resnets.*\\.conv[12]$', 're:.*downsamplers.*',
                         're:.*\\.attn.?$'], 'rank': 2}]
    ov, _ = jov.make_lora_overlay(jax.random.PRNGKey(4), jax_world['unet_params'], specs,
                                  aliases=aliases)
    rng = np.random.default_rng(5)
    ov = {p: {k: (rng.standard_normal(np.shape(v)).astype(np.float32) if k == 'up'
                  else np.asarray(v)) for k, v in e.items()} for p, e in ov.items()}
    conv = {p: jov._get_path(jax_world['unet_params'], p)['kernel'].shape for p in ov
            if jov._get_path(jax_world['unet_params'], p)['kernel'].ndim == 4}
    assert len(conv) >= 8
    JManager().save_model_with_lora(str(tmp_path / 'j.safetensors'), lora_overlay=ov,
                                    aliases=aliases, conv_shapes=conv)
    tov = lora_overlay_from_params(ov, world['unet'])
    TManager().save_model_with_lora(str(tmp_path / 't.safetensors'), world['unet'],
                                    lora_overlay=tov, aliases=world['aliases']['unet'])
    jsd = load_safetensors(str(tmp_path / 'j.safetensors'))
    tsd = safetensors_io.load_file(str(tmp_path / 't.safetensors'))
    assert sorted(tsd) == sorted(jsd)
    for key in jsd:
        np.testing.assert_array_equal(tsd[key].numpy(), jsd[key], err_msg=key)
    back = TManager().load_ckpt(str(tmp_path / 'j.safetensors'),
                                aliases=world['aliases']['unet'])['lora']
    _assert_packs_close(back, tov, atol=0)
    jback = JManager().load_ckpt(str(tmp_path / 't.safetensors'), aliases=aliases)['lora']
    _assert_packs_close(lora_overlay_from_params(jback, world['unet']), tov, atol=0)
