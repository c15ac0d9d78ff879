"""The port's workflow engine against the JAX package's, at tiny widths in
fp32 on the CPU, on a tiny SD1.5 directory written by the JAX package:

- ``resolve_from_memory`` against the JAX one, ``ExecAction`` (a program's
  ``hcpdiff_tpu.``/``hcpdiff.`` imports get the port's objects, ``jax``
  raises) and ``LoopAction``;
- every ``cfgs/workflow/*.yaml`` through the port's CLI at 32 px, 3 steps,
  the initial latents the JAX workflow draws fed to both: the images of
  ``text2img.yaml``, ``text2img_controlnet.yaml`` (a JAX-written plugin,
  its shipped program at 32 px) and ``highres_fix_latent.yaml`` under
  ``sampler=euler`` against the JAX workflow's within atol 1e-3 (the
  repo's loop bound), ``text2img_lora.yaml`` equal to ``text2img.yaml``
  (``actions_pre_lora`` is not run) and ``highres_fix_pixel.yaml`` to
  ``highres_fix_latent.yaml`` (its pixel note is text); the shipped
  highres config (DPM++ 2M in both loops) raises in both packages, the
  port's ``ValueError`` naming the two shapes;
- the LoRA and part actions (JAX-written files: the UNet's output against
  the JAX actions', atol 1e-4, and back to the base bitwise on the LoRA's
  removal), the
  plugin actions and ``InputFeederAction`` as the JAX package's
  ``tests/test_controlnet.py`` runs them, and sliced decoding.

The JAX workflows run their UNet and VAE under ``jax.jit`` (``JitRunner``):
the same functions, compiled once a shape instead of op by op.
- both resize actions, up and down, against ``jax.image.resize``
  (atol 1e-5);
- a subprocess that runs ``text2img_controlnet.yaml`` through ``python -m
  hcpdiff_tpu_torch.infer_workflow`` and loads no ``jax`` or
  ``hcpdiff_tpu`` module.
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.adapt import overlay as jov
from hcpdiff_tpu.ckpt.manager import CkptManagerSafe as JSafe
from hcpdiff_tpu.config import load as jload
from hcpdiff_tpu.models import controlnet as jcn
from hcpdiff_tpu.models.unet import UNetConfig
from hcpdiff_tpu.workflow import actions as jact
from hcpdiff_tpu.workflow import base as jbase
from hcpdiff_tpu_torch.infer_workflow import main
from hcpdiff_tpu_torch.utils.images import write_png
from hcpdiff_tpu_torch.workflow import actions as tact
from hcpdiff_tpu_torch.workflow import base as tbase
from tests.test_torch_port_visualizer import _write_jax_dir
from tests.torch_port_common import random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WF = os.path.join(ROOT, 'cfgs', 'workflow')
ATOL_MODEL, ATOL_LOOP, ATOL_RESIZE = 1e-4, 1e-3, 1e-5
SEED = 42                                   # the configs' SeedAction


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The tiny SD1.5 directory, a ControlNet plugin file (random_params,
    zero convs included, so the plugin changes the images) and a 32 px
    condition PNG."""
    root = tmp_path_factory.mktemp('wf')
    _write_jax_dir('sd15', str(root / 'sd15'))
    out = {'root': root, 'dir': str(root / 'sd15'), 'plugin': str(root / 'plugin.safetensors'),
           'cond': str(root / 'cond.png')}
    net = jcn.ControlNet(UNetConfig.tiny(cross_attention_dim=32), dtype=jnp.float32,
                         cond_stages=1)
    params = random_params(net, jnp.zeros((1, 8, 8, 4)), jnp.array([0]), jnp.zeros((1, 77, 32)),
                           jnp.zeros((1, 16, 16, 3)), seed=9)
    JSafe().save_plugins(out['plugin'], {'controlnet1': params})
    write_png(out['cond'], np.random.default_rng(4).integers(0, 256, (32, 32, 3), np.uint8))
    return out


def _latents(seed, shape):
    """The standard normal latents JAX's MakeLatentAction draws."""
    return np.array(jax.random.normal(jax.random.split(jax.random.PRNGKey(seed))[1], shape))


def _args(world, name, out):
    """Overrides for the tiny directory at 32 px, 3 steps (highres: 3 more
    at 64 px), saving under ``out``."""
    args = ['prepare.0.pretrained_model=' + world['dir'], 'prepare.0.dtype=fp32',
            'actions.3.N_steps=3', 'actions.4.width=32', 'actions.4.height=32']
    if name.startswith('highres'):
        args += ['actions.6.width=64', 'actions.6.height=64', 'actions.6.scale=2',
                 'actions.7.N_steps=3', f'actions.10.save_root={out}/']
    elif name == 'text2img_controlnet.yaml':
        prog = jload(os.path.join(WF, name))['actions'][5]['prog'].replace('512, 512', '32, 32')
        args += [f'memory.plugin_path={world["plugin"]}', f'memory.cond_image={world["cond"]}',
                 'actions.5.prog=' + '; '.join(prog.strip().splitlines()),
                 f'actions.8.save_root={out}/']
    else:
        args += [f'actions.7.save_root={out}/']
    return args


_JITTED = {}


def _jit(memory):
    """The JAX memory's UNet callable and VAE under ``jax.jit`` (eager
    dispatch compiles every op anew at each shape: minutes on the CPU);
    without a plugin, the first run's jitted functions (the same modules
    of the same directory), so that a shape compiles once a process."""
    vae = memory['vae']
    if 'unet_apply_base' in memory:
        memory['unet_apply'] = jax.jit(memory['unet_apply'])
    else:
        memory['unet_apply'] = _JITTED.setdefault('unet', jax.jit(memory['unet_apply']))
    memory['vae'] = types.SimpleNamespace(cfg=vae.cfg, apply=_JITTED.setdefault(
        'vae', jax.jit(vae.apply, static_argnames='method')))


class JitRunner(jbase.WorkflowRunner):
    """The JAX runner, its models jitted after the prepare actions."""

    def start(self):
        states = self.run(self._build_actions(self.cfgs.get('prepare')), {})
        _jit(self.memory)
        return self.run(self._build_actions(self.cfgs.get('actions')), states)


def _run_both(world, tmp_path, monkeypatch, name, extra=()):
    """(JAX states, port states) of one config under the same overrides."""
    args = _args(world, name, tmp_path / 'jax') + list(extra)
    jstates = JitRunner(jload(os.path.join(WF, name), args)).start()
    monkeypatch.setattr(tact, 'draw_latents', lambda gen, shape: torch.from_numpy(
        _latents(SEED, shape)))
    tstates = main(['--cfg', os.path.join(WF, name), 'device=cpu']
                   + _args(world, name, tmp_path / 'port') + list(extra))
    return jstates, tstates


EULER = ['actions.3.sampler=euler', 'actions.7.sampler=euler']


@pytest.mark.parametrize('name', ['text2img.yaml', 'text2img_controlnet.yaml',
                                  'highres_fix_latent.yaml'])
def test_workflow_matches_jax(world, tmp_path, monkeypatch, name):
    extra = EULER if name.startswith('highres') else []
    jstates, tstates = _run_both(world, tmp_path, monkeypatch, name, extra)
    side = 64 if name.startswith('highres') else 32
    assert tstates['images'].shape == np.asarray(jstates['images']).shape == (1, side, side, 3)
    np.testing.assert_allclose(tstates['images'], np.asarray(jstates['images']), atol=ATOL_LOOP)
    assert sorted(os.listdir(tmp_path / 'port')) == ['0-img.png']
    if name == 'text2img_controlnet.yaml':
        assert isinstance(tstates['cond'], np.ndarray) and tstates['cond'].shape == (1, 32, 32, 3)
        np.testing.assert_array_equal(tstates['cond'], np.asarray(jstates['cond']))


@pytest.mark.parametrize('name,same_as', [('text2img_lora.yaml', 'text2img.yaml'),
                                          ('highres_fix_pixel.yaml', 'highres_fix_latent.yaml')])
def test_derived_configs_run_as_their_base(world, tmp_path, monkeypatch, name, same_as):
    monkeypatch.setattr(tact, 'draw_latents', lambda gen, shape: torch.from_numpy(
        _latents(SEED, shape)))
    extra = EULER if name.startswith('highres') else []
    got = main(['--cfg', os.path.join(WF, name), 'device=cpu']
               + _args(world, name, tmp_path / 'a') + extra)
    want = main(['--cfg', os.path.join(WF, same_as), 'device=cpu']
                + _args(world, same_as, tmp_path / 'b') + extra)
    np.testing.assert_array_equal(got['images'], want['images'])


def test_highres_under_a_stateful_sampler_raises_in_both(world, tmp_path, monkeypatch):
    args = _args(world, 'highres_fix_latent.yaml', tmp_path / 'jax')
    assert 'actions.7.sampler=euler' not in args
    with pytest.raises(TypeError, match='incompatible shapes'):
        JitRunner(jload(os.path.join(WF, 'highres_fix_latent.yaml'), args)).start()
    with pytest.raises(ValueError, match=r'\(1, 16, 16, 4\).*\(1, 32, 32, 4\).*euler'):
        main(['--cfg', os.path.join(WF, 'highres_fix_latent.yaml'), 'device=cpu']
             + _args(world, 'highres_fix_latent.yaml', tmp_path / 'port'))


def test_resolve_exec_and_loop():
    mem = {'unet': {'params': 42}, 'name': 'x'}
    spec = {'a': '${hcp.from_memory:name}', 'b': ['${hcp.from_memory:unet.params}'],
            'c': 'plain ${other}'}
    assert tbase.resolve_from_memory(spec, mem) == jbase.resolve_from_memory(spec, mem) == {
        'a': 'x', 'b': [42], 'c': 'plain ${other}'}

    prog = ('from hcpdiff_tpu.data.processor import ControlNetProcessor\n'
            'import hcpdiff_tpu.data.processor as p\n'
            'import hcpdiff_tpu.workflow\n'
            'from hcpdiff.data import TextImageCondPairDataset\n'
            'import math\n'
            "states['y'] = states['x'] * 2\n"
            "states['mods'] = [ControlNetProcessor.__module__, p.__name__,\n"
            '                  hcpdiff_tpu.workflow.LoopAction.__module__,\n'
            '                  TextImageCondPairDataset.__module__, math.__name__]\n'
            "memory['seen'] = True")
    mem = {}
    states = tbase.ExecAction(prog=prog)(memory=mem, x=21)
    assert states['y'] == 42 and mem['seen'] is True
    assert states['mods'] == ['hcpdiff_tpu_torch.data.processor', 'hcpdiff_tpu_torch.data.processor',
                              'hcpdiff_tpu_torch.workflow.base', 'hcpdiff_tpu_torch.data.dataset',
                              'math']
    for bad in ('import jax.numpy as jnp', 'from flax import linen'):
        with pytest.raises(ImportError, match='does not import'):
            tbase.ExecAction(prog=bad)(memory={})

    class Add(tbase.BasicAction):
        def forward(self, acc=0, t=None, **states):
            return {'acc': acc + t, **states}
    states = tbase.LoopAction(loop_value={'timesteps': 't'}, actions=[Add()])(
        memory={}, timesteps=[1, 2, 3], acc=0)
    assert states == {'acc': 6}


def _memories(world):
    jm, tm = {}, {'device': 'cpu'}
    jact.LoadModelsAction(pretrained_model=world['dir'], dtype='fp32')(memory=jm)
    tact.LoadModelsAction(pretrained_model=world['dir'], dtype='fp32')(memory=tm)
    return jm, tm


def _inputs(side=8, lat=2):
    rng = np.random.default_rng(6)
    return (rng.standard_normal((1, side, side, 4)).astype(np.float32), np.array([10]),
            rng.standard_normal((1, 77, 32)).astype(np.float32),
            rng.uniform(0, 1, (1, side * lat, side * lat, 3)).astype(np.float32))


def test_lora_and_part_actions_match_jax(world, tmp_path):
    jm, tm = _memories(world)
    x, t, ctx, _ = _inputs()
    base = tm['unet_apply'](torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    ov, _ = jov.make_lora_overlay(jax.random.PRNGKey(4), jm['unet_params'],
                                  [{'layers': ['re:.*\\.attn.?$'], 'rank': 2}],
                                  aliases=jm['aliases']['unet'])
    rng = np.random.default_rng(5)
    ov = {p: {k: (rng.standard_normal(np.shape(v)).astype(np.float32) if k == 'up'
                  else np.asarray(v)) for k, v in e.items()} for p, e in ov.items()}
    path = str(tmp_path / 'lora.safetensors')
    JSafe().save_model_with_lora(path, lora_overlay=ov, aliases=jm['aliases']['unet'])
    for mod, mem in ((jact, jm), (tact, tm)):
        mod.BuildModelLoaderAction()(memory=mem)
        mod.LoadLoraAction(path=path, alpha=0.8)(memory=mem)
    japply = jax.jit(jm['unet_apply'])
    xt, tt, ct = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)
    got = tm['unet_apply'](xt, tt, ct)
    assert float(abs(got - base).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(japply(jm['unet_params'], x, t, ctx)),
                               atol=ATOL_MODEL)
    for mod, mem in ((jact, jm), (tact, tm)):
        mod.RemoveLoraAction()(memory=mem)
    assert torch.equal(tm['unet_apply'](xt, tt, ct), base)
    # a part file (conv_in fine-tuned) blended in at alpha 0.5
    part = str(tmp_path / 'part.safetensors')
    JSafe().save_model_with_lora(part, base={'conv_in': jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.5, jm['unet_params']['conv_in'])})
    for mod, mem in ((jact, jm), (tact, tm)):
        mod.LoadPartAction(path=part, alpha=0.5)(memory=mem)
    got = tm['unet_apply'](xt, tt, ct)
    assert float(abs(got - base).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(japply(jm['unet_params'], x, t, ctx)),
                               atol=ATOL_MODEL)


def test_plugin_and_input_feeder_actions(world, tmp_path):
    """The JAX package's tests/test_controlnet.py cases in the port (the
    loaded plugin against JAX: test_workflow_matches_jax's ControlNet
    workflow)."""
    tm = {'device': 'cpu'}
    tact.LoadModelsAction(pretrained_model=world['dir'], dtype='fp32')(memory=tm)
    x, t, ctx, cond = (torch.from_numpy(a) for a in _inputs())
    apply = lambda **kw: tm['unet_apply'](x, t, ctx, **kw)      # noqa: E731
    base = apply()
    tact.LoadPluginAction(path=world['plugin'], name='controlnet1', alpha=0.7)(memory=tm)
    with_plugin = apply(cond=cond)
    net = tm['plugins']['controlnet1'][0]
    down, mid = net(x, t, ctx, cond, conditioning_scale=0.7)
    assert torch.equal(with_plugin, tm['unet'](x, t, ctx, down_residuals=down, mid_residual=mid))
    assert float(abs(with_plugin - base).max()) > 1e-2
    assert torch.equal(apply(), base)                     # no condition: inert
    tact.RemovePluginAction(name='controlnet1')(memory=tm)
    assert torch.equal(apply(cond=cond), base) and tm['pipe'].plugins == []

    tact.BuildPluginAction(name='cn')(memory=tm)          # zero heads: the base output
    assert 'cn' in tm['plugins']
    np.testing.assert_allclose(apply(cond=cond).numpy(), base.numpy(), atol=1e-6)
    tact.RemovePluginAction(name='cn')(memory=tm)
    with pytest.raises(ValueError, match='cannot resolve'):
        tact.BuildPluginAction(cfg={'_target_': 'hcpdiff_tpu.models.no_such.Net'})(memory=tm)

    img = str(tmp_path / 'c.png')
    write_png(img, np.full((8, 8, 3), 128, np.uint8))
    states = tact.InputFeederAction({'cond': img, 'tag': 7}, width=16, height=16)(memory=tm, bs=2)
    jstates = jact.InputFeederAction({'cond': img, 'tag': 7}, width=16, height=16)(memory={},
                                                                                  bs=2)
    assert states['cond'].shape == (2, 16, 16, 3) and states['tag'] == 7 and states['bs'] == 2
    np.testing.assert_allclose(states['cond'], np.asarray(jstates['cond']), atol=1e-6)


def test_vae_slicing_and_tiling():
    memory = {'device': 'cpu'}
    tact.LoadModelsAction(pretrained_model='tiny', dtype='fp32')(memory=memory)
    lat = torch.randn(3, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    plain = tact.DecodeAction()(memory=memory, latents=lat)['images']
    tact.VaeOptimizeAction(slicing=True)(memory=memory)
    sliced = tact.DecodeAction()(memory=memory, latents=lat)['images']
    assert plain.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(plain, sliced, atol=1e-5)
    with pytest.raises(NotImplementedError, match='tiling'):
        tact.VaeOptimizeAction(tiling=True)


@pytest.mark.parametrize('size', [(64, 64), (16, 16), (40, 24)])
def test_resize_actions_match_jax(size):
    w, h = size
    rng = np.random.default_rng(7)
    lat = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    got = tact.LatentResizeAction(width=w * 8, height=h * 8)(latents=torch.from_numpy(lat))
    want = jact.LatentResizeAction(width=w * 8, height=h * 8)(latents=jnp.asarray(lat))
    np.testing.assert_allclose(got['latents'].numpy(), np.asarray(want['latents']),
                               atol=ATOL_RESIZE)
    img = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    got = tact.ImageResizeAction(width=w, height=h)(images=img)['images']
    want = jact.ImageResizeAction(width=w, height=h)(images=img)['images']
    assert isinstance(got, np.ndarray) and got.shape == (1, h, w, 3)
    np.testing.assert_allclose(got, want, atol=ATOL_RESIZE)


def test_int8_workflow_quantizes_each_weight_once(world, tmp_path, monkeypatch):
    """text2img.yaml under HCP_INT8=1 at 1 and at 3 steps (one UNet call a
    step): each run quantizes its UNet's int8 weights once, at its first
    call, so both count the same quantizations; the runner builds its
    models outside inference mode, so their codes are kept."""
    from hcpdiff_tpu_torch.ops import int8 as tint8
    monkeypatch.setenv('HCP_INT8', '1')
    counts = []
    for steps in (1, 3):
        q0 = tint8.weight_codes.quantizations
        states = main(['--cfg', os.path.join(WF, 'text2img.yaml'), 'device=cpu']
                      + _args(world, 'text2img.yaml', tmp_path / str(steps))
                      + [f'actions.3.N_steps={steps}'])
        assert np.isfinite(states['images']).all()
        counts.append(tint8.weight_codes.quantizations - q0)
    assert counts[0] > 0 and counts[1] == counts[0]


def test_cli_loads_no_jax(world, tmp_path):
    """text2img_controlnet.yaml (its shipped program's hcpdiff_tpu import
    included) through python -m hcpdiff_tpu_torch.infer_workflow in a
    fresh interpreter, which then lists the JAX modules it loaded: none."""
    code = ('import sys\n'
            'from hcpdiff_tpu_torch.infer_workflow import main\n'
            'states = main(sys.argv[1:])\n'
            "assert states['images'].shape == (1, 32, 32, 3)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hcpdiff_tpu', 'PIL', 'yaml'))\n"
            'print(bad)\n')
    name = 'text2img_controlnet.yaml'
    args = ([sys.executable, '-c', code, '--cfg', os.path.join(WF, name), 'device=cpu']
            + _args(world, name, tmp_path / 'out'))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    res = subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == '[]'
    assert os.listdir(tmp_path / 'out') == ['0-img.png']
