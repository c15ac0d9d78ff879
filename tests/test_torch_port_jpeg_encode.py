"""The port's baseline JPEG encoder (``utils/jpeg.py:encode_jpeg``) and the
``DiskInterface`` options that use it, on the CPU:

- the encoder against Pillow (installed where the tests run, not on the card's machine)
  at quality 95, 75 and 50 on seeded RGB and L images of 64x48 and 17x13
  (odd sides: partial MCUs, libjpeg's dummy blocks) and 1x1: the bytes
  are Pillow's, so Pillow's decoder and the port's ``decode_jpeg`` read
  the same pixels; the quantisation tables equal Pillow's at every
  quality; the islow forward DCT and the quantiser against a float DCT
  and plain division;
- the round trip's error bounds that chip_smoke.py's ``tools_phase``
  holds each JPEG to: at quality 95, uniform noise (JPEG's worst case)
  decodes within ``RMS_BOUND_Q95`` levels RMS of the image, and Pillow's
  JPEG (and so the port's) decodes within ``PLAIN_RMS_BOUND_Q95`` of
  ``jpeg.plain_round_trip``, a float version of the codec, where a JPEG
  at quality 50 or of the image shifted by a pixel does not;
- ``DiskInterface``: ``jpg`` at a ``quality`` writes the JAX
  interface's bytes (Pillow's), ``save_cfg: false`` writes no YAML,
  ``webp`` writes one lossless frame (Pillow and ``read_webp`` give the
  pixels back), an unknown type raises, ``DiskAnimInterface`` takes the
  options.
"""
import io
import os

import numpy as np
import pytest
from PIL import Image

from hcpdiff_tpu.infer import interfaces as jinterfaces
from hcpdiff_tpu_torch.infer import interfaces as tinterfaces
from hcpdiff_tpu_torch.utils import images, jpeg
from tests.torch_port_common import one_torch_thread  # noqa: F401

# the RMS error (in 8-bit levels, over all pixels and channels) of a
# quality-95 round trip of uniform noise: 59.4 at 64x48 and 59.1 at
# 512x512; the bound chip_smoke.py holds each decoded JPEG to
RMS_BOUND_Q95 = 64.0
# the RMS distance (levels) of a quality-95 JPEG, decoded, from
# jpeg.plain_round_trip of its image: the integer DCTs' and colour
# tables' rounding, at most 1.82 on uniform noise and 1.28-1.29 on the
# smooth images here; a JPEG at quality 50 lies 3.3-25 away, one of the
# image shifted a pixel 11-71
PLAIN_RMS_BOUND_Q95 = 2.5


def _pillow_bytes(img, quality):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, 'JPEG', quality=quality)
    return buf.getvalue()


def _image(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == 'noise':
        return rng.integers(0, 256, shape, dtype=np.uint8)
    h, w = shape[:2]
    yy, xx = np.mgrid[:h, :w]
    base = 128 + 60 * np.sin(yy / 5.0 + rng.uniform(0, 6)) * np.cos(xx / 7.0)
    planes = [base + 20 * k + rng.normal(0, 4, (h, w)) for k in range(shape[2] if len(shape) == 3
                                                                          else 1)]
    out = np.clip(np.stack(planes, axis=-1), 0, 255).astype(np.uint8)
    return out if len(shape) == 3 else out[:, :, 0]


@pytest.mark.parametrize('quality', [95, 75, 50])
@pytest.mark.parametrize('shape', [(48, 64, 3), (13, 17, 3), (48, 64), (13, 17), (1, 1, 3)])
@pytest.mark.parametrize('kind', ['noise', 'smooth'])
def test_encoder_writes_pillows_bytes(shape, quality, kind):
    img = _image(shape, kind, sum(shape) + quality)
    data = jpeg.encode_jpeg(img, quality)
    assert data == _pillow_bytes(img, quality)
    with Image.open(io.BytesIO(data)) as im:
        ref = np.asarray(im)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), ref)


@pytest.mark.parametrize('quality', [1, 10, 25, 49, 50, 51, 80, 95, 100])
def test_quality_tables_are_pillows(quality):
    img = np.zeros((8, 8, 3), np.uint8)
    with Image.open(io.BytesIO(_pillow_bytes(img, quality))) as im:
        want = im.quantization
    got = jpeg.quality_tables(quality)
    for t in (0, 1):
        assert list(got[t]) == list(want[t])            # natural order


def test_fdct_and_quantize_against_float_reference():
    """The islow DCT is the orthonormal 2-D DCT-II scaled by 8, within its
    13-bit constants' error; quantisation divides by 8 * q with rounding."""
    rng = np.random.default_rng(3)
    blocks = rng.integers(0, 256, (50, 8, 8), dtype=np.uint8)
    k = np.arange(8)
    basis = np.sqrt(2 / 8) * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    basis[0] /= np.sqrt(2)
    ref = 8 * np.einsum('ui,nij,vj->nuv', basis, blocks.astype(np.float64) - 128, basis)
    got = jpeg.fdct_islow(blocks)
    assert np.abs(got - ref).max() <= 4.0
    qt = jpeg.quality_tables(75)[0]
    q = jpeg.quantize(got, qt).reshape(-1, 64)
    plain = np.sign(got.reshape(-1, 64)) * np.floor(np.abs(got.reshape(-1, 64)) / (8 * qt) + 0.5)
    assert np.abs(q - plain).max() <= 1 and (q == plain).mean() > 0.99


def test_round_trip_error_bound_at_quality_95():
    for shape in ((48, 64, 3), (512, 512, 3)):
        img = _image(shape, 'noise', 7)
        back = jpeg.decode_jpeg(jpeg.encode_jpeg(img, 95)).astype(np.float64)
        rms = float(np.sqrt(((back - img) ** 2).mean()))
        assert rms <= RMS_BOUND_Q95
    smooth = _image((48, 64, 3), 'smooth', 7)
    back = jpeg.decode_jpeg(jpeg.encode_jpeg(smooth, 95)).astype(np.float64)
    assert float(np.sqrt(((back - smooth) ** 2).mean())) <= 4.0


def _rms(a, b):
    return float(np.sqrt(((np.asarray(a, np.float64) - b) ** 2).mean()))


@pytest.mark.parametrize('shape', [(48, 64, 3), (13, 17, 3), (512, 512, 3), (13, 17)])
@pytest.mark.parametrize('kind', ['noise', 'smooth'])
def test_plain_round_trip_bounds_a_decoded_jpeg(shape, kind):
    img = _image(shape, kind, 11)
    plain = jpeg.plain_round_trip(img, 95)
    pillow = np.asarray(Image.open(io.BytesIO(_pillow_bytes(img, 95))))
    port = jpeg.decode_jpeg(jpeg.encode_jpeg(img, 95))
    assert _rms(pillow, plain) <= PLAIN_RMS_BOUND_Q95
    assert _rms(port, plain) <= PLAIN_RMS_BOUND_Q95
    # the check fails a wrong JPEG: another quality, or a shifted image
    worse = np.asarray(Image.open(io.BytesIO(_pillow_bytes(img, 50))))
    shifted = np.asarray(Image.open(io.BytesIO(_pillow_bytes(np.roll(img, 1, axis=1), 95))))
    assert _rms(worse, plain) > PLAIN_RMS_BOUND_Q95
    assert _rms(shifted, plain) > PLAIN_RMS_BOUND_Q95


def test_encoder_refuses_other_inputs():
    with pytest.raises(ValueError, match='uint8'):
        jpeg.encode_jpeg(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match=r'\[H, W\]'):
        jpeg.encode_jpeg(np.zeros((8, 8, 4), np.uint8))


def _batch(seed=0, n=2, h=17, w=13):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


INFO = {'prompt': 'a cat', 'negative_prompt': '', 'seed': 5, 'width': 13, 'height': 17}


@pytest.mark.parametrize('image_type, quality', [('jpg', 80), ('jpeg', 95), ('png', 95)])
def test_disk_interface_writes_the_jax_interfaces_bytes(tmp_path, image_type, quality):
    imgs = _batch()
    outs = {}
    for name, mod in (('jax', jinterfaces), ('port', tinterfaces)):
        root = str(tmp_path / name)
        itf = mod.DiskInterface(root, image_type=image_type, quality=quality)
        paths = itf.on_infer_finish(imgs, INFO)
        assert [os.path.basename(p) for p in paths] == [f'0-img.{image_type}',
                                                         f'1-img.{image_type}']
        assert sorted(os.listdir(root)) == sorted(
            [f'{i}-img.{image_type}' for i in range(2)] + [f'{i}-img.yaml' for i in range(2)])
        outs[name] = [open(p, 'rb').read() for p in paths]
    if image_type == 'png':           # zlib streams differ; the pixels do not
        for a, b in zip(outs['jax'], outs['port']):
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(a))),
                                          images.decode_png(b))
    else:
        assert outs['jax'] == outs['port']


def test_disk_interface_save_cfg_false_and_counter(tmp_path):
    root = str(tmp_path / 'out')
    for mod, sub in ((jinterfaces, 'jax'), (tinterfaces, 'port')):
        d = os.path.join(root, sub)
        itf = mod.DiskInterface(d, image_type='jpg', quality=80, save_cfg=False)
        itf.on_infer_finish(_batch(), INFO)
        again = mod.DiskInterface(d, image_type='jpg', save_cfg=False)
        assert again.counter == 2
        again.on_infer_finish(_batch(1, n=1), INFO)
        assert sorted(os.listdir(d)) == ['0-img.jpg', '1-img.jpg', '2-img.jpg']


def test_disk_interface_webp_is_lossless(tmp_path):
    imgs = _batch(2)
    want = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    itf = tinterfaces.DiskInterface(str(tmp_path), image_type='webp')
    paths = itf.on_infer_finish(imgs, INFO)
    for p, img in zip(paths, want):
        np.testing.assert_array_equal(images.read_webp(p), img)
        with Image.open(p) as im:
            np.testing.assert_array_equal(np.asarray(im.convert('RGB')), img)


def test_disk_interface_refuses_an_unknown_type(tmp_path):
    with pytest.raises(ValueError, match="'gif'"):
        tinterfaces.DiskInterface(str(tmp_path), image_type='gif')


def test_anim_interface_takes_the_options(tmp_path):
    itf = tinterfaces.DiskAnimInterface(str(tmp_path), image_type='jpg', quality=70,
                                        save_cfg=False, frame_ms=90)
    frames = [_batch(s) for s in range(3)]
    for i, f in enumerate(frames):
        itf.on_inter_step(i, 3, None, None, f)
    imgs = _batch(9)
    itf.on_infer_finish(imgs, INFO)
    assert sorted(os.listdir(tmp_path)) == ['0-img.jpg', '0-steps.webp', '1-img.jpg',
                                            '1-steps.webp']
    want = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    assert open(tmp_path / '1-img.jpg', 'rb').read() == _pillow_bytes(want[1], 70)
    anim = images.read_webp_anim(str(tmp_path / '1-steps.webp'))
    assert [f['duration'] for f in anim['frames']] == [90] * 3
