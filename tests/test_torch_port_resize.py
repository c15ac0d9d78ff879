"""The workflow's ``resize`` (``hcpdiff_tpu_torch/workflow/actions.py``)
against ``jax.image.resize`` on the CPU, fp32 within atol 1e-5, for every
method name it takes: 'nearest'; 'linear', 'bilinear', 'trilinear',
'triangle'; 'cubic', 'bicubic', 'tricubic' (Keys, a = -0.5); 'lanczos3';
'lanczos5'. Each upscales (the highres fix's latent doubling), downscales
(antialiased) and resizes by non-integer factors, one axis up and the
other down; both resize actions take the method from their config."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcpdiff_tpu.workflow import actions as jact
from hcpdiff_tpu_torch.workflow import actions as tact
from tests.torch_port_common import one_torch_thread  # noqa: F401

ATOL = 1e-5
METHODS = ['nearest', 'linear', 'bilinear', 'trilinear', 'triangle', 'cubic', 'bicubic',
           'tricubic', 'lanczos3', 'lanczos5']
SHAPES = {'up_2x': ((2, 16, 16, 4), (32, 32)), 'down_3x': ((1, 48, 36, 3), (16, 12)),
          'non_integer': ((2, 21, 10, 3), (13, 17)), 'one_axis': ((1, 9, 14, 2), (9, 33))}


@pytest.mark.parametrize('shape', list(SHAPES))
@pytest.mark.parametrize('method', METHODS)
def test_resize_matches_jax_image_resize(method, shape):
    (b, h, w, c), (ho, wo) = SHAPES[shape]
    x = np.random.default_rng(h * w + len(method)).standard_normal((b, h, w, c)).astype(np.float32)
    got = tact.resize(torch.from_numpy(x), ho, wo, method)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (b, ho, wo, c), method))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize('method', ['nearest', 'bicubic', 'lanczos3'])
def test_resize_actions_take_the_method(method):
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    got = tact.LatentResizeAction(width=96, height=128, method=method)(
        latents=torch.from_numpy(lat))['latents']
    want = jact.LatentResizeAction(width=96, height=128, method=method)(latents=jnp.asarray(lat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want['latents']), atol=ATOL, rtol=0)
    img = rng.uniform(0, 1, (2, 20, 30, 3)).astype(np.float32)
    got = tact.ImageResizeAction(width=11, height=7, method=method)(images=img)['images']
    want = jact.ImageResizeAction(width=11, height=7, method=method)(images=img)['images']
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_an_unknown_method_raises_as_jax_does():
    x = torch.zeros(1, 4, 4, 1)
    with pytest.raises(ValueError, match='Unknown resize method "area"'):
        tact.resize(x, 8, 8, 'area')
    with pytest.raises(ValueError, match='Unknown resize method "area"'):
        jax.image.resize(jnp.zeros((1, 4, 4, 1)), (1, 8, 8, 1), 'area')
