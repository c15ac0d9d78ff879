"""The port's native image route (``utils/native.py`` over its copy of
``csrc/image_ops.cpp``; ``HCP_NATIVE_IMG=1`` in ``data/utils.py`` and
``data/dataset.py``) against the JAX package's ``utils/native.py`` and
against the port's default route.

Bounds: the two libraries are one source built with one set of flags, so
their arrays agree within 1e-6. Against the default route (Pillow's
bicubic, which rounds to uint8 between its two passes, where the native
filter stays in float) the JAX package's own test's bounds
(tests/test_native.py): mean |diff| < 1/127.5, max < 6/127.5. They hold
for images with content, such as the committed JPEGs and smooth fields
(about 0.3 levels mean, 1.1 at most); on uniform noise they do not:
Pillow clips the bicubic filter's overshoot to 0..255 between its passes
and the native filter does not, which moved a 96x64 noise image's 48x32
crop by up to 8.4 levels.
"""
import filecmp
import os

import numpy as np
import pytest

from hcpdiff_tpu.utils import native as jnative
from hcpdiff_tpu_torch.data import dataset as tdataset
from hcpdiff_tpu_torch.data import sources as tsources
from hcpdiff_tpu_torch.data import buckets as tbuckets
from hcpdiff_tpu_torch.data import utils as tutils
from hcpdiff_tpu_torch.utils import native
from tests.torch_port_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_DIR = os.path.join(ROOT, 'tests', 'data', 'torch_port_jpeg')
MEAN_BOUND, MAX_BOUND = 1.0 / 127.5, 6.0 / 127.5


@pytest.fixture(scope='module')
def jax_lib():
    if not jnative.available():
        pytest.skip('the JAX package could not build its native library (no toolchain)')
    return jnative


def _images(seed=0, smooth=False):
    """uint8 RGB images of four sizes: uniform noise, or (``smooth``) a
    sinusoid a channel with noise of 6 levels."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in ((80, 120), (64, 64), (50, 70), (97, 33)):
        if not smooth:
            out.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            continue
        y, x = np.mgrid[0:h, 0:w]
        waves = [127.5 + 90 * np.sin(rng.uniform(0.02, 0.2) * x + rng.uniform(0.02, 0.2) * y
                                     + rng.uniform(0, 6)) for _ in range(3)]
        noisy = np.stack(waves, -1) + rng.normal(0, 6, (h, w, 3))
        out.append(np.clip(noisy, 0, 255).astype(np.uint8))
    return out


def test_source_is_the_repository_copy():
    assert filecmp.cmp(native.SOURCE, os.path.join(ROOT, 'csrc', 'image_ops.cpp'), shallow=False)


def test_library_matches_the_jax_package(jax_lib):
    imgs = _images()
    geo = [((64, 48), (0, 0), (64, 48)), ((48, 48), (8, 0), (32, 48)),
           ((70, 50), (3, 2), (64, 48)), ((40, 120), (4, 30), (32, 64))]
    for img, (rs, cr, tg) in zip(imgs, geo):
        np.testing.assert_allclose(native.resize_crop_normalize(img, rs, cr, tg),
                                   jax_lib.resize_crop_normalize(img, rs, cr, tg), atol=1e-6)
    for img in _images(2, smooth=True):
        np.testing.assert_allclose(native.resize_crop_normalize(img, (40, 48), (4, 8), (32, 32)),
                                   jax_lib.resize_crop_normalize(img, (40, 48), (4, 8), (32, 32)),
                                   atol=1e-6)


@pytest.mark.parametrize('seed', [None, 3])
def test_native_crop_matches_the_default_route(seed):
    """resize_crop_fix_native against resize_crop_fix + to_model_input:
    equal crop info (the same seeded draws), arrays within the bounds."""
    for img, size in zip(_images(1, smooth=True), ((64, 48), (32, 40), (48, 48), (24, 64))):
        r1 = None if seed is None else np.random.default_rng(seed)
        r2 = None if seed is None else np.random.default_rng(seed)
        arr, info = tutils.resize_crop_fix_native(img, size, r1)
        plain, pinfo = tutils.resize_crop_fix(img, size, r2)
        assert info == pinfo and arr.shape == (size[1], size[0], 3) and arr.dtype == np.float32
        diff = np.abs(arr - tutils.to_model_input(plain))
        assert diff.mean() < MEAN_BOUND and diff.max() < MAX_BOUND


def test_dataset_batches_under_hcp_native_img(monkeypatch):
    """get_batch on the committed JPEGs (512x512 and 640x448) with
    HCP_NATIVE_IMG=1 against the default route: the images within the
    bounds, crop info (SDXL's time_ids) and prompts equal; a non-RGB image
    is not routed natively."""
    batches = {}
    for flag in ('0', '1'):
        monkeypatch.setenv('HCP_NATIVE_IMG', flag)
        src = tsources.Text2ImageSource(JPEG_DIR,
                                        caption_file=os.path.join(JPEG_DIR, 'captions.json'))
        ds = tdataset.TextImagePairDataset(src, tbuckets.FixedBucket(target_size=(320, 256)),
                                           vae_scale=8, with_crop_info=True)
        ds.build(2)
        batches[flag] = [ds.get_batch(bi, epoch=1, step_seed=7) for bi in range(len(ds.bucket))]
    for plain, nat in zip(batches['0'], batches['1']):
        assert sorted(plain) == sorted(nat)
        np.testing.assert_array_equal(nat['time_ids'], plain['time_ids'])
        assert nat['prompts'] == plain['prompts']
        diff = np.abs(nat['images'] - plain['images'])
        assert 0 < diff.max() < MAX_BOUND and diff.mean() < MEAN_BOUND   # routed natively
    gray = np.zeros((8, 8), np.uint8)
    monkeypatch.setenv('HCP_NATIVE_IMG', '1')
    assert tutils.native_route(np.zeros((8, 8, 3), np.uint8)) and not tutils.native_route(gray)
    monkeypatch.setenv('HCP_NATIVE_IMG', '0')
    assert not tutils.native_route(np.zeros((8, 8, 3), np.uint8))


def test_failed_build_raises_naming_the_log(tmp_path):
    broken = tmp_path / 'image_ops.cpp'
    broken.write_text('this is not C++\n')
    with pytest.raises(RuntimeError, match='image_ops_build.log'):
        native.build(broken)
    assert 'rc ' in native.BUILD_LOG.read_text()


def test_decoder_builds_beside_image_ops(tmp_path):
    """One build helper for both libraries: the decoder's library sits
    beside image_ops' in _build/ under its own name, both load, and a
    decoder that does not build raises naming the library and its log."""
    ops, dec = native.build(), native.build(native.DECODE_SOURCE, 'image_decode')
    assert ops.parent == dec.parent == native.BUILD_DIR
    assert ops.name.startswith('libhcp_image_ops_') and dec.name.startswith('libhcp_image_decode_')
    assert native.library().hcp_image_ops_version() == native.VERSION
    assert native.decoder().hcp_image_decode_version() == native.DECODE_VERSION
    broken = tmp_path / 'image_decode.cpp'
    broken.write_text('this is not C++ either\n')
    with pytest.raises(RuntimeError, match=r'image_decode \(image_decode.cpp\).*'
                                           r'image_decode_build.log'):
        native.build(broken, 'image_decode')
    assert 'rc ' in (native.BUILD_DIR / 'image_decode_build.log').read_text()
