"""ControlNet training in the port against the JAX package, at tiny widths
in fp32 on the CPU:

- ``Text2ImageCondSource`` and ``TextImageCondPairDataset``: the batches
  of both packages on the same PNGs (3:2 images under a seeded crop, RGB
  and RGBA condition images), ``cond`` bit for bit; the condition gets its
  own centred crop; a missing condition file and a JPEG raise;
- the ``Trainer`` with ``plugin_unet`` (a ControlNet) against the JAX
  ``Trainer`` (its builder's zero heads and copied blocks, ``random_params``
  elsewhere): the port's ControlNet started from the JAX one
  (``ckpt/bridge.py``), fed the JAX draws, two steps whose losses agree
  within rtol 1e-4 and whose ``zero_mid`` and
  ``cond_embedding.conv_out`` agree after each step within atol 2e-6
  (``test_torch_port_trainer.py``'s step tolerances), with and without
  the UNet's remat; the fresh builder's zero heads and copied blocks;
- ``plugin-2.safetensors``: the JAX keys, read back by both packages equal
  to the final pack, and a ``train.resume.ckpt_path.plugin`` resume.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.ckpt.formats import load_safetensors
from hcpdiff_tpu.ckpt.manager import CkptManagerSafe as JSafe
from hcpdiff_tpu.config import containerize as jcontainerize
from hcpdiff_tpu.data.buckets import FixedBucket as JFixed
from hcpdiff_tpu.data.dataset import TextImageCondPairDataset as JDataset
from hcpdiff_tpu.data.sources import Text2ImageCondSource as JSource
from hcpdiff_tpu.models import controlnet as jcn
from hcpdiff_tpu.trainer import trainer as jtrainer
from hcpdiff_tpu_torch.ckpt import safetensors_io
from hcpdiff_tpu_torch.ckpt.bridge import state_dict_from_params
from hcpdiff_tpu_torch.config import containerize
from hcpdiff_tpu_torch.data.buckets import FixedBucket
from hcpdiff_tpu_torch.data.dataset import TextImageCondPairDataset
from hcpdiff_tpu_torch.data.sources import Text2ImageCondSource
from hcpdiff_tpu_torch.models.controlnet import ControlNet, build_controlnet
from hcpdiff_tpu_torch.trainer.trainer import Trainer
from hcpdiff_tpu_torch.utils.images import read_png, write_png
from tests.test_torch_port_trainer import _cfg, _jax_draws, jax_world, port_world  # noqa: F401
from tests.torch_port_common import random_params

ATOL_STEP, RTOL_LOSS = 2e-6, 1e-4
WATCHED = ('zero_mid.weight', 'cond_embedding.conv_out.weight')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def proj(tmp_path_factory):
    """4 PNGs of 48x32 with captions, and their conditions: RGB, and one
    RGBA (its alpha dropped)."""
    d = tmp_path_factory.mktemp('cn_train')
    (d / 'imgs').mkdir()
    (d / 'cond').mkdir()
    rng = np.random.default_rng(11)
    for i in range(4):
        write_png(str(d / 'imgs' / f'img_{i}.png'), rng.integers(0, 256, (32, 48, 3), np.uint8))
        ch = 4 if i == 1 else 3
        write_png(str(d / 'cond' / f'img_{i}.png'), rng.integers(0, 256, (32, 48, ch), np.uint8))
    with open(d / 'imgs' / 'captions.json', 'w') as f:
        f.write('{' + ', '.join(f'"img_{i}": "a photo of cat {i}"' for i in range(4)) + '}')
    return d


def test_cond_dataset_batches_match_jax(proj, tmp_path):
    def batches(src_cls, ds_cls, bucket_cls):
        src = src_cls(str(proj / 'imgs'), cond_root=str(proj / 'cond'),
                      caption_file=str(proj / 'imgs' / 'captions.json'))
        ds = ds_cls(src, bucket_cls(target_size=(32, 32)), vae_scale=2).build(2)
        ds.bucket.rest(1)
        return [ds.get_batch(bi, epoch=1, step_seed=bi) for bi in range(len(ds))]
    mine, theirs = (batches(Text2ImageCondSource, TextImageCondPairDataset, FixedBucket),
                    batches(JSource, JDataset, JFixed))
    assert len(mine) == len(theirs) == 2
    for m, j in zip(mine, theirs):
        assert sorted(m) == sorted(j) == ['cond', 'images', 'loss_weight', 'prompts']
        assert m['cond'].shape == (2, 32, 32, 3) and m['cond'].dtype == np.float32
        for key in ('cond', 'images'):
            np.testing.assert_array_equal(m[key], j[key])
        assert m['prompts'] == j['prompts']
    # the condition's own centre crop, not the image's seeded one
    src = Text2ImageCondSource(str(proj / 'imgs'), cond_root=str(proj / 'cond'))
    whole = src.get_cond_image(str(proj / 'imgs' / 'img_1.png'))
    assert whole.shape == (32, 48, 3)
    np.testing.assert_array_equal(whole, read_png(str(proj / 'cond' / 'img_1.png'))[:, :, :3])
    with pytest.raises(FileNotFoundError, match='no cond image'):
        src.get_cond_image(str(tmp_path / 'other.png'))
    (tmp_path / 'jpg').mkdir()
    (tmp_path / 'jpg' / 'img_0.jpg').write_bytes(b'\xff\xd8\xff\xe0 not decoded')
    with pytest.raises(ValueError, match='img_0.jpg.*PNG'):
        Text2ImageCondSource(str(proj / 'imgs'), cond_root=str(tmp_path / 'jpg')).get_cond_image(
            str(proj / 'imgs' / 'img_0.png'))


def _train_cfg(proj, exp_dir, **over):
    """controlnet.yaml's training settings on the tiny world: batch 2 of
    the cond dataset at 32 px, the latent cache, 2 steps saving at 2."""
    cfg = _cfg(proj, exp_dir, **over)
    cfg['train'].update(train_steps=2, save_step=2,
                        scheduler={'name': 'constant', 'num_training_steps': 2})
    cfg['plugin_unet'] = {'controlnet1': {
        '_target_': 'hcpdiff_tpu.models.controlnet.ControlNet', '_partial_': True, 'lr': 1e-3}}
    cfg['data']['dataset1'].update(_target_='hcpdiff_tpu.data.dataset.TextImageCondPairDataset')
    cfg['data']['dataset1']['source']['s1'].update(
        _target_='hcpdiff_tpu.data.sources.Text2ImageCondSource', cond_root=str(proj / 'cond'))
    return cfg


def _watched(pack):
    return {n: pack['controlnet'][n].detach().clone() for n in WATCHED}


def _jax_builder(rng, unet_cfg, unet_params, vae_scale=8, dtype=jnp.float32, **_):
    """The JAX builder's ControlNet (zero heads, the UNet's blocks copied)
    with random_params' weights elsewhere: no flax init to run."""
    cn = jcn.ControlNet(unet_cfg, dtype=dtype, cond_stages=int(math.log2(vae_scale)))
    params = random_params(cn, jnp.zeros((1, 8, 8, unet_cfg.in_channels)), jnp.array([0]),
                           jnp.zeros((1, 77, unet_cfg.cross_attention_dim)),
                           jnp.zeros((1, 8 * vae_scale, 8 * vae_scale, 3)), seed=43)
    params = {k: (jax.tree_util.tree_map(np.zeros_like, v) if k.startswith('zero_') else v)
              for k, v in params.items()}
    params['cond_embedding']['conv_out'] = jax.tree_util.tree_map(
        np.zeros_like, params['cond_embedding']['conv_out'])
    return cn, jax.tree_util.tree_map(jnp.asarray, jcn.init_from_unet(params, unet_params))


@pytest.fixture(scope='module')
def jax_run(proj, jax_world, tmp_path_factory):
    """The JAX Trainer's two ControlNet steps: its initial ControlNet, each
    step's (key, loss, watched weights), its final ControlNet and its
    plugin file."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcn.ControlNet, 'from_unet', staticmethod(_jax_builder))
    mp.setattr(jtrainer, 'build_models', lambda *a, **kw: dict(jax_world))
    mesh = jtrainer.make_mesh
    mp.setattr(jtrainer, 'make_mesh', lambda **kw: mesh(devices=jax.devices()[:1]))
    exp = tmp_path_factory.mktemp('jax_cn')
    try:
        jt = jtrainer.Trainer(jcontainerize(_train_cfg(proj, exp)))
    finally:
        mp.undo()
    init = state_dict_from_params(jax.device_get(jt.state.pack['controlnet']))
    calls, step_fn = [], jt._train_step

    def recorded(state, frozen, batch, rng):
        state, metrics = step_fn(state, frozen, batch, rng)
        cn = state_dict_from_params(jax.device_get(state.pack['controlnet']))
        calls.append((rng, float(metrics['loss']), {n: cn[n] for n in WATCHED}))
        return state, metrics
    jt._train_step = recorded
    assert jt.train() == 2
    final = state_dict_from_params(jax.device_get(jt.state.pack['controlnet']))
    return {'init': init, 'calls': calls, 'final': final,
            'plugin': str(exp / 'ckpts' / 'plugin-2.safetensors')}


@pytest.mark.parametrize('remat', [False, True])
def test_controlnet_trainer_matches_jax(proj, tmp_path, jax_world, jax_run, remat):
    world = port_world(jax_world)
    cfg = _train_cfg(proj, tmp_path / 'port', device='cpu')
    cfg['model']['gradient_checkpointing'] = remat
    tt = Trainer(containerize(cfg), world=world)
    assert sorted(tt.state.pack) == ['controlnet'] and tt.unet.remat == remat
    assert sorted(tt.state.pack['controlnet']) == sorted(jax_run['init'])
    with torch.no_grad():                          # start from the JAX trainer's ControlNet
        for n, p in tt.state.pack['controlnet'].items():
            p.copy_(jax_run['init'][n])
    assert not any(p.requires_grad for p in tt.unet.parameters())
    watched, step_fn = [], tt._train_step

    def recorded(*a, **kw):
        out = step_fn(*a, **kw)
        watched.append(_watched(out[0].pack))
        return out
    tt._train_step = recorded
    calls = jax_run['calls']
    assert tt.train(draws=lambda step, di, batch: _jax_draws(
        calls[step][0], tuple(batch['latents'].shape), 1)) == 2
    np.testing.assert_allclose(tt.history, [loss for _, loss, _ in calls], rtol=RTOL_LOSS)
    for step, (mine, (_, _, theirs)) in enumerate(zip(watched, calls)):
        for n in WATCHED:
            np.testing.assert_allclose(mine[n].numpy(), theirs[n].numpy(), atol=ATOL_STEP,
                                       rtol=0, err_msg=f'{n} after step {step + 1}')
    init = jax_run['init']
    # the zero heads move at once; the condition encoder once they are nonzero
    assert not torch.equal(watched[0]['zero_mid.weight'], init['zero_mid.weight'])
    assert torch.equal(watched[0]['cond_embedding.conv_out.weight'],
                       init['cond_embedding.conv_out.weight'])
    assert not torch.equal(watched[1]['cond_embedding.conv_out.weight'],
                           init['cond_embedding.conv_out.weight'])
    for n, p in tt.state.pack['controlnet'].items():
        np.testing.assert_allclose(p.detach().numpy(), jax_run['final'][n].numpy(),
                                   atol=ATOL_STEP, rtol=0, err_msg=n)


def test_plugin_file_reads_back_and_resumes(proj, tmp_path, jax_world, jax_run):
    world = port_world(jax_world)
    first = Trainer(containerize(_train_cfg(proj, tmp_path / 'a', device='cpu')), world=world)
    assert first.train() == 2
    path = str(tmp_path / 'a' / 'ckpts' / 'plugin-2.safetensors')
    final = {n: p.detach() for n, p in first.state.pack['controlnet'].items()}
    assert sorted(os.listdir(tmp_path / 'a' / 'ckpts')) == ['plugin-2.safetensors']
    assert sorted(safetensors_io.load_file(path)) == sorted(load_safetensors(jax_run['plugin']))
    mine = first.ckpt_manager.load_plugins(path)
    in_jax = state_dict_from_params(JSafe().load_plugins(path)['controlnet1'])
    assert sorted(mine) == ['controlnet1']
    for got in (mine['controlnet1'], in_jax):
        assert sorted(got) == sorted(final)
        for n, v in final.items():
            assert torch.equal(got[n], v), n

    # a weight-only resume: from the port's file, and from the JAX one
    for src, want in ((path, final), (jax_run['plugin'], jax_run['final'])):
        cfg = _train_cfg(proj, tmp_path / 'b', device='cpu')
        cfg['train']['resume'] = {'start_step': 2, 'ckpt_path': {'plugin': [src]}}
        second = Trainer(containerize(cfg), world=port_world(jax_world))
        assert second.start_step == 2
        for n, v in want.items():
            assert torch.equal(second.state.pack['controlnet'][n], v), n


def test_fresh_controlnet_zero_heads_and_copied_blocks(jax_world):
    world = port_world(jax_world)
    gen = torch.Generator().manual_seed(8)
    net = ControlNet.from_unet(gen, world['unet'], vae_scale=2)
    assert ControlNet.from_unet is build_controlnet and net.cond_embedding.stages == 1
    own, unet = net.state_dict(), world['unet'].state_dict()
    for n, v in own.items():
        if n.startswith(('zero_', 'cond_embedding.conv_out.')):
            assert not v.any(), n
        elif n in unet:
            assert torch.equal(v, unet[n]), n
        else:
            assert n.startswith('cond_embedding.') and v.abs().sum() > 0 or 'bias' in n, n
    again = ControlNet.from_unet(torch.Generator().manual_seed(8), world['unet'], vae_scale=2)
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(), again.parameters()))
