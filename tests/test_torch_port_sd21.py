"""SD2.1 (768-v) in the port against the JAX package, at tiny SD2-shaped
widths in fp32 on the CPU. SD2-shaped: heads given a level with one head
dim (D = 16 at both levels), a cross-attention width (48) that is neither
level's, and a ``gelu`` CLIP of that width.

- txt2img under v-prediction: prompt -> CLIP -> 4 DPM++ 2M CFG steps ->
  VAE decode, the port's ``DenoiseLoop`` against the JAX one from the same
  numpy latents, final latents and image at atol 1e-3 (the repo's loop
  bound);
- a diffusers-layout directory written by the port with Linear
  ``proj_in``/``proj_out`` (``use_linear_projection: true``, as SD2.1's
  own): the port's factory and the JAX factory read it to the same
  parameters, bit for bit, and the configs read back;
- ``cfgs/train/examples/sd21_vpred.yaml`` through both packages' config
  loaders and trainers on the tiny world, 2 steps, under its MSE loss and
  under Min-SNR (whose weight is the reference's min(gamma / SNR, 1)
  whatever the target): losses within rtol 1e-4 and every LoRA leaf
  within atol 2e-6 (``test_torch_port_trainer.py``'s tolerances).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.config import load as jload
from hcpdiff_tpu.diffusion import samplers as jsamplers
from hcpdiff_tpu.diffusion.schedules import NoiseSchedule as JSchedule
from hcpdiff_tpu.infer import pipeline as jpipe
from hcpdiff_tpu.models import clip as jclip
from hcpdiff_tpu.models import factory as jfactory
from hcpdiff_tpu.models import text_frontend as jtf
from hcpdiff_tpu.models import unet as junet
from hcpdiff_tpu.models import vae as jvae
from hcpdiff_tpu.trainer import trainer as jtrainer
from hcpdiff_tpu.utils.clip_tokenizer import CLIPTokenizer as JTokenizer
from hcpdiff_tpu_torch.ckpt import safetensors_io
from hcpdiff_tpu_torch.ckpt.bridge import load_params, state_dict_from_params
from hcpdiff_tpu_torch.config import load as tload
from hcpdiff_tpu_torch.diffusion import samplers as tsamplers
from hcpdiff_tpu_torch.diffusion.schedules import NoiseSchedule as TSchedule
from hcpdiff_tpu_torch.infer import pipeline as tpipe
from hcpdiff_tpu_torch.models import clip as tclip
from hcpdiff_tpu_torch.models import factory as tfactory
from hcpdiff_tpu_torch.models import text_frontend as ttf
from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.models import vae as tvae
from hcpdiff_tpu_torch.tools.random_diffusers import write_module
from hcpdiff_tpu_torch.trainer.step import pack_leaves
from hcpdiff_tpu_torch.trainer.trainer import Trainer
from hcpdiff_tpu_torch.utils.clip_tokenizer import CLIPTokenizer as TTokenizer
from tests.test_torch_port_trainer import (EXAMPLES, WORDS, _assert_packs_close, _jax_draws,
                                           _jax_pack_as_port, one_torch_thread, proj)
from tests.torch_port_common import random_params

__all__ = ['one_torch_thread', 'proj']       # fixtures shared with the trainer file
STEPS, GUIDANCE = 4, 7.5
CTX = 48                                    # the tiny CLIP's width, the UNet's cross-attention's
VPRED = dict(prediction_type='v_prediction')


def _configs(tk):
    """The JAX and port tiny SD2-shaped configs: (unet, vae, clip) each."""
    ids = dict(vocab_size=tk.vocab_size, eos_token_id=tk.eos_token_id,
               bos_token_id=tk.bos_token_id, hidden_size=CTX, num_attention_heads=4,
               hidden_act='gelu')
    unet = dict(num_heads=(2, 4), cross_attention_dim=CTX)
    return ((junet.UNetConfig.tiny(**unet), jvae.VAEConfig.tiny(),
             jclip.CLIPTextConfig.tiny(**ids)),
            (tunet.UNetConfig.tiny(**unet), tvae.VAEConfig.tiny(),
             tclip.CLIPTextConfig.tiny(**ids)))


@pytest.fixture(scope='module')
def sd2_world():
    """The tiny SD2-shaped world in both packages, on the same weights."""
    tk = JTokenizer.tiny(words=WORDS)
    (jucfg, jvcfg, jccfg), (tucfg, tvcfg, tccfg) = _configs(tk)
    ju, jv, jc = (junet.UNet2DCondition(jucfg, dtype=jnp.float32),
                  jvae.AutoencoderKL(jvcfg, dtype=jnp.float32), jclip.CLIPTextModel(jccfg))
    up = random_params(ju, jnp.zeros((1, 8, 8, 4)), jnp.array([0]), jnp.zeros((1, 77, CTX)),
                       seed=50)
    vp = random_params(jv, jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0), seed=51)
    cp = random_params(jc, jnp.zeros((1, 77), jnp.int32), seed=52)
    jw = {'sdxl': False, 'unet': ju, 'unet_cfg': jucfg, 'unet_params': up, 'vae': jv,
          'vae_cfg': jvcfg, 'vae_params': vp, 'te': jc, 'te_cfg': jccfg, 'te_params': cp,
          'tokenizer': tk,
          'aliases': {'unet': jfactory.unet_alias_map(jucfg), 'te': jfactory.clip_alias_map(jccfg),
                      'vae': jfactory.vae_alias_map(jvcfg)}}
    tw = {'sdxl': False, 'unet_cfg': tucfg, 'vae_cfg': tvcfg, 'te_cfg': tccfg,
          'unet': tfactory._finish(load_params(tunet.UNet2DCondition(tucfg), up)),
          'vae': tfactory._finish(load_params(tvae.AutoencoderKL(tvcfg), vp)),
          'te': tfactory._finish(load_params(tclip.CLIPTextModel(tccfg), cp)),
          'tokenizer': TTokenizer.tiny(words=WORDS),
          'aliases': {'unet': tfactory.unet_alias_map(tucfg), 'te': tfactory.clip_alias_map(tccfg),
                      'vae': tfactory.vae_alias_map(tvcfg)}}
    return jw, tw


def test_sd21_configs_are_sd2_shaped():
    """The full-width configs the card runs: D = 64 at every level, the
    OpenCLIP-H text width and a gelu CLIP; the tiny ones keep that shape."""
    cfg = tunet.UNetConfig.sd21()
    assert {c // h for c, h in zip(cfg.block_out_channels, cfg.num_heads)} == {64}
    clip = tclip.CLIPTextConfig.sd2()
    assert (clip.hidden_size, clip.num_hidden_layers, clip.hidden_act) == (1024, 23, 'gelu')
    assert cfg.cross_attention_dim == clip.hidden_size
    (ju, _, jc), (tu, _, tc) = _configs(JTokenizer.tiny(words=WORDS))
    assert {c // h for c, h in zip(tu.block_out_channels, tu.num_heads)} == {16}
    assert tu.cross_attention_dim not in tu.block_out_channels and tc.hidden_act == 'gelu'
    assert dataclasses.asdict(tu) == {k: v for k, v in dataclasses.asdict(ju).items()
                                      if k in dataclasses.asdict(tu)}


def test_vpred_txt2img_matches_jax(sd2_world):
    jw, tw = sd2_world
    jte = jtf.TextEncoderFrontend(jw['tokenizer'], jw['te'], jw['te_params'])
    tte = ttf.TextEncoderFrontend(tw['tokenizer'], tw['te'])
    prompts, negs = ['a photo of a cat', 'a {dog:1.2} painting'], ['', 'photo']
    jctx, _ = jte.encode(negs + prompts)
    tctx, _ = tte.encode(negs + prompts)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=1e-5)

    lat0 = np.random.default_rng(4).standard_normal((2, 16, 16, 4)).astype(np.float32)
    jloop = jpipe.DenoiseLoop(lambda p, x, t, c: jw['unet'].apply({'params': p}, x, t, c),
                              jsamplers.make_sampler('dpm++_2m', JSchedule.make(**VPRED), STEPS))
    jlat, _ = jloop(jw['unet_params'], jnp.asarray(lat0), jctx, jax.random.PRNGKey(0), GUIDANCE)
    tsched = TSchedule.make(**VPRED)
    assert tsched.prediction_type == 'v_prediction'
    tloop = tpipe.DenoiseLoop(tw['unet'], tsamplers.make_sampler('dpm++_2m', tsched, STEPS))
    tlat, _ = tloop(torch.from_numpy(lat0), tctx, GUIDANCE)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-3)
    # the same loop under epsilon prediction ends elsewhere: v is what ran
    eps_lat, _ = tpipe.DenoiseLoop(tw['unet'], tsamplers.make_sampler(
        'dpm++_2m', TSchedule.make(), STEPS))(torch.from_numpy(lat0), tctx, GUIDANCE)
    assert (eps_lat - tlat).abs().max() > 1e-2

    scale = jw['vae'].cfg.scaling_factor
    jraw = np.asarray(jw['vae'].apply({'params': jw['vae_params']}, jlat / scale,
                                      method='decode'))
    pipe = tpipe.DiffusionPipeline(tw['unet'], tw['vae'], tte, schedule=tsched)
    timg = pipe.decode(tlat)
    assert timg.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(timg, np.clip(jraw * 0.5 + 0.5, 0, 1), atol=1e-3)


def test_linear_projection_directory_loads_alike(sd2_world, tmp_path):
    """The port writes the tiny SD2-shaped world as an SD2.1 directory
    holds it; both factories read it to the very weights written."""
    _, tw = sd2_world
    root = tmp_path / 'sd21'
    for sub, key in (('unet', 'unet'), ('vae', 'vae'), ('text_encoder', 'te')):
        write_module(tw[key], str(root / sub), torch.float32,
                     linear_projection=True)
    with open(root / 'unet' / 'config.json') as f:
        config = json.load(f)
    assert config['use_linear_projection'] is True
    assert config['attention_head_dim'] == [2, 4] and config['cross_attention_dim'] == CTX
    stored = safetensors_io.load_file(str(root / 'unet' / 'diffusion_pytorch_model.safetensors'))
    projs = [k for k in stored if k.endswith(('proj_in.weight', 'proj_out.weight'))]
    assert projs and all(stored[k].dim() == 2 for k in projs)

    jw = jfactory.build_models(str(root), dtype=jnp.float32)
    got = tfactory.build_models(str(root), dtype=torch.float32, device='cpu')
    for key in ('unet', 'vae', 'te'):
        assert got[key + '_cfg'] == tw[key + '_cfg']
        want = tw[key].state_dict()
        mine = got[key].state_dict()
        theirs = state_dict_from_params(jw[key + '_params'])
        assert mine.keys() == want.keys() == theirs.keys(), key
        for name in want:
            assert torch.equal(mine[name], want[name]), name
            assert torch.equal(theirs[name], want[name]), name
    assert jw['unet_cfg'].cross_attention_dim == CTX and jw['te_cfg'].hidden_act == 'gelu'


def _vpred_args(proj, exp_dir, loss):
    src = 'data.dataset1.source.data_source1'
    args = ['model.pretrained_model_name_or_path=tiny', 'mixed_precision=fp32', 'seed=1',
            f'exp_dir={exp_dir}', 'train.train_steps=2', 'train.save_step=2',
            'train.optimizer.eps=1e-3', 'train.preemption=false', 'logger.0.log_step=1',
            f'{src}.img_root={proj / "imgs"}', f'{src}.caption_file={proj / "imgs" / "captions.json"}',
            'data.dataset1.batch_size=2', 'data.dataset1.bucket.target_area=1024',
            'data.dataset1.bucket.step_size=16']
    if loss == 'min_snr':
        args += ['train.loss.criterion._target_=hcpdiff_tpu.diffusion.losses.MinSNRLoss',
                 'train.loss.criterion.gamma=2.0']
    return args


@pytest.mark.parametrize('loss', ['mse', 'min_snr'])
def test_sd21_vpred_yaml_trains_as_jax(proj, sd2_world, tmp_path, monkeypatch, loss):
    jw, tw = sd2_world
    cfg = str(EXAMPLES / 'sd21_vpred.yaml')
    monkeypatch.setattr(jtrainer, 'build_models', lambda *a, **kw: dict(jw))
    mesh = jtrainer.make_mesh
    monkeypatch.setattr(jtrainer, 'make_mesh', lambda **kw: mesh(devices=jax.devices()[:1]))
    jt = jtrainer.Trainer(jload(cfg, _vpred_args(proj, tmp_path / 'jax', loss)))
    calls, step_fn = [], jt._train_step

    def recorded(state, frozen, batch, rng):
        state, metrics = step_fn(state, frozen, batch, rng)
        calls.append((rng, float(metrics['loss'])))
        return state, metrics
    jt._train_step = recorded

    tt = Trainer(tload(cfg, _vpred_args(proj, tmp_path / 'port', loss) + ['device=cpu']),
                 world=tw)
    assert tt.noise_schedule.prediction_type == jt.noise_schedule.prediction_type == \
        'v_prediction'
    assert type(tt.criterion).__name__ == type(jt.criterion).__name__ == (
        'MinSNRLoss' if loss == 'min_snr' else 'MSELoss')
    jpack0 = _jax_pack_as_port(jt.state.pack, tw)
    assert sorted(tt.state.pack) == sorted(jpack0) == ['lora_te', 'lora_unet']
    with torch.no_grad():
        for dst, src in zip(pack_leaves(tt.state.pack), pack_leaves(jpack0)):
            dst.copy_(src)
    assert jt.train() == tt.train(draws=lambda step, di, batch: _jax_draws(
        calls[step][0], tuple(batch['latents'].shape[-4:]), tt.grad_accum)) == 2
    np.testing.assert_allclose(tt.history, [l for _, l in calls], rtol=1e-4)
    _assert_packs_close(tt.state.pack, _jax_pack_as_port(jt.state.pack, tw), atol=2e-6)
    assert sorted(os.listdir(tmp_path / 'port' / 'ckpts')) == ['text_encoder-2.safetensors',
                                                               'unet-2.safetensors']
