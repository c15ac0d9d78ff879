"""Tensor-parallel UNet inference in the port (``hcpdiff_tpu_torch/parallel/tp.py``
and the UNet's ``_tp_call`` sublayers) against the JAX UNet:

- the tiny UNet (and the tiny SDXL UNet with its pooled embedding and
  time_ids) under (tp, data) = (2, 1) and (1, 2) on 2 CPU ``gloo`` ranks
  matches the JAX UNet, which is not tensor-parallel, on the same numpy
  weights within 1e-4 in fp32, on every rank; the tiny pipeline's txt2img
  with it gives the plain UNet's images (the denoise loop unchanged);
- ``tp > 1`` raises with ``qkv_bias``, with the fused-sublayer route and
  with a batch the data axis does not divide; the validation errors of
  ``tests/test_tp.py:test_tp_validation_errors`` (a head count tp does not
  divide, a UNet whose cfg.tp is not the mesh's, a mesh the world does
  not fill);
- in one process: the column- and row-parallel shares of a sublayer sum
  to the whole sublayer.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.models.unet import UNet2DCondition as JUNet
from hcpdiff_tpu.models.unet import UNetConfig as JConfig
from hcpdiff_tpu_torch.models.unet import (CrossAttention, GEGLUFeedForward, UNet2DCondition,
                                           UNetConfig)
from hcpdiff_tpu_torch.parallel.tp import make_tp_mesh, tp_unet_apply, tp_unet_config
from tests.torch_port_common import one_torch_thread, random_params  # noqa: F401
from tests.torch_port_dist import launch

MESHES = ((2, 1), (1, 2))
CASES = {'sd': ('tiny', {'num_heads': (4, 4)}, False),
         'sdxl': ('tiny_sdxl', {'num_heads': (2, 2)}, True)}


def _case(name, seed):
    cfg_name, kw, sdxl = CASES[name]
    cfg = getattr(JConfig, cfg_name)(**kw)
    model = JUNet(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    B = 2
    x = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    t = np.array([100, 700], np.int32)
    ctx = rng.standard_normal((B, 7, cfg.cross_attention_dim)).astype(np.float32)
    extras = {}
    if sdxl:
        extras = {'pooled_text_emb': rng.standard_normal((B, 32)).astype(np.float32),
                  'time_ids': rng.uniform(0, 64, (B, 6)).astype(np.float32)}
    init_kw = {k: jnp.asarray(v[:1]) for k, v in extras.items()}
    params = random_params(model, jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                           jnp.zeros((1, 7, cfg.cross_attention_dim)), seed=seed, **init_kw)
    ref = np.asarray(model.apply({'params': params}, x, t, ctx, **extras))
    return {'cfg': cfg_name, 'cfg_kw': kw, 'params': params, 'x': x, 't': t, 'ctx': ctx,
            'extras': extras}, ref


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp('tp')
    cases, refs = {}, {}
    for seed, name in enumerate(CASES):
        cases[name], refs[name] = _case(name, seed + 50)
    with open(out / 'inputs.pkl', 'wb') as f:
        pickle.dump(cases, f)
    return refs, launch('tp', 2, out, inputs=str(out / 'inputs.pkl'), meshes=MESHES)


@pytest.mark.parametrize('mesh', MESHES, ids=lambda m: f'tp{m[0]}_data{m[1]}')
@pytest.mark.parametrize('name', sorted(CASES))
def test_tp_unet_matches_jax(world, name, mesh):
    refs, ranks = world
    for r, res in enumerate(ranks):
        out = res['out'][(name, *mesh)].numpy()
        assert out.shape == refs[name].shape
        np.testing.assert_allclose(out, refs[name], atol=1e-4, rtol=1e-4, err_msg=f'rank {r}')


@pytest.mark.parametrize('mesh', MESHES, ids=lambda m: f'tp{m[0]}_data{m[1]}')
def test_tp_unet_runs_the_txt2img_loop_unchanged(world, mesh):
    """The tiny pipeline's txt2img (3 DPM++ 2M steps, CFG-doubled batch of
    4) with the tensor-parallel UNet gives the UNet's images, on every rank."""
    _, ranks = world
    for res in ranks:
        np.testing.assert_allclose(res['out'][('txt2img', *mesh)], res['out']['txt2img'],
                                   atol=1e-4, rtol=0)


def test_tp_raises_on_qkv_bias_fused_route_and_batch(world):
    _, ranks = world
    for res in ranks:
        errors = res['errors']
        assert 'does not split over the 2 ranks' in errors['batch']
        assert 'qkv_bias' in errors['qkv_bias']
        assert 'fused-sublayer route' in errors['fused']


def test_tp_validation_errors():
    cfg = UNetConfig.tiny()          # heads (2, 4)
    with pytest.raises(ValueError, match='does not divide'):
        tp_unet_config(cfg, 4)
    mesh = make_tp_mesh(tp=1)
    with pytest.raises(ValueError, match='cfg.tp'):
        tp_unet_apply(UNet2DCondition(tp_unet_config(cfg, 2)), mesh)
    with pytest.raises(ValueError, match='!= 1 devices'):
        make_tp_mesh(tp=3)
    unbound = UNet2DCondition(tp_unet_config(cfg, 2))
    with pytest.raises(RuntimeError, match='tp_unet_apply'), torch.no_grad():
        unbound(torch.zeros(1, 8, 8, 4), torch.zeros(1), torch.zeros(1, 7, 32))


@pytest.mark.parametrize('tp', (2, 4))
def test_tp_shares_sum_to_the_sublayer(tp):
    """Each member's column-parallel share, all-reduced (here summed in one
    process), is the whole sublayer."""
    torch.manual_seed(tp)
    x, ctx, res = torch.randn(2, 16, 32), torch.randn(2, 7, 24), torch.randn(2, 16, 32)
    for whole, share in ((CrossAttention(32, 4, 24), CrossAttention(32, 4, 24, tp=tp)),
                         (GEGLUFeedForward(32), GEGLUFeedForward(32, tp=tp))):
        share.load_state_dict(whole.state_dict())
        args = (x, ctx) if isinstance(whole, CrossAttention) else (x,)
        bias = share.to_out.bias if isinstance(whole, CrossAttention) else share.out.bias
        with torch.no_grad():
            want = whole(*args, res=res)
            parts = []
            for idx in range(tp):
                share.tp_bind = (None, idx)
                parts.append(share(*args, res=res) - bias - res)
        torch.testing.assert_close(sum(parts) + bias + res, want, atol=1e-5, rtol=1e-5)
