"""The port's training data pipeline and lr schedules against the JAX
package's, on the CPU:

- buckets: the same sizes, and the same files in the same batches in the
  same order over three epochs, for every bucket kind;
- crops: ``resize_crop_fix``/``pad_crop_fix`` (Pillow in the JAX package,
  the port's copy of Pillow's bicubic here) and the RGBA composite, bit
  for bit;
- ``get_batch`` through ``CycleData`` for 4 steps: images or cached
  latents, ``input_ids``, ``token_mult`` and ``att_mask`` bitwise equal,
  with caption augmentations drawing from the same numpy seeds;
- caption loaders and header probing; what the port refuses to read;
- ``make_schedule`` against optax's schedules at every step, for all 7
  names: within 1e-7 at the configs' learning rates, and at lr 1 within
  1e-7 plus two float32 ulps (2.4e-7 relative; the cosines differ from
  XLA's by an ulp).
"""
import json
import os

import numpy as np
import pytest
from PIL import Image

from hcpdiff_tpu.data import buckets as jbuckets
from hcpdiff_tpu.data import captions as jcaptions
from hcpdiff_tpu.data import dataset as jdataset
from hcpdiff_tpu.data import sources as jsources
from hcpdiff_tpu.data import transforms as jtransforms
from hcpdiff_tpu.data import utils as jutils
from hcpdiff_tpu.models.text_frontend import TextEncoderFrontend as JFrontend
from hcpdiff_tpu.trainer.optimizers import make_schedule as jschedule
from hcpdiff_tpu.utils.clip_tokenizer import CLIPTokenizer as JTokenizer
from hcpdiff_tpu_torch.data import buckets as tbuckets
from hcpdiff_tpu_torch.data import captions as tcaptions
from hcpdiff_tpu_torch.data import dataset as tdataset
from hcpdiff_tpu_torch.data import sources as tsources
from hcpdiff_tpu_torch.data import transforms as ttransforms
from hcpdiff_tpu_torch.data import utils as tutils
from hcpdiff_tpu_torch.data.img_size import get_image_size
from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend as TFrontend
from hcpdiff_tpu_torch.trainer.optimizers import make_schedule as tschedule
from hcpdiff_tpu_torch.utils.clip_tokenizer import CLIPTokenizer as TTokenizer
from hcpdiff_tpu_torch.utils.images import write_png
from tests.torch_port_common import one_torch_thread  # noqa: F401

WORDS = ['cat', 'dog', 'photo', 'painting']
# (w, h) of a mixed set of files: squares, 3:2, 2:3, a panorama, duplicates
SIZES = ([(512, 512)] * 7 + [(768, 512)] * 5 + [(512, 768)] * 4 + [(1024, 256)] * 2
         + [(640, 480)] * 3 + [(333, 517)])

BUCKETS = {
    'fixed': (lambda m: m.FixedBucket(target_size=(320, 256)), 3),
    'ratio_files': (lambda m: m.RatioBucket.from_files(target_area=512 * 512, num_bucket=4), 3),
    'ratio_ratios': (lambda m: m.RatioBucket.from_ratios(target_area=384 * 384, step_size=64,
                                                         num_bucket=5), 2),
    'size': (lambda m: m.SizeBucket(step_size=32, num_bucket=3), 2),
    'long_edge': (lambda m: m.LongEdgeBucket(target_edge=448, step_size=16, num_bucket=3), 4),
}


@pytest.mark.parametrize('kind', sorted(BUCKETS))
def test_buckets_match_jax(kind):
    make, bs = BUCKETS[kind]
    infos = [(f'f{i}.png', s) for i, s in enumerate(SIZES)]
    jb, tb = make(jbuckets), make(tbuckets)
    jb.build(infos, bs)
    tb.build(infos, bs)
    assert len(tb) == len(jb) > 0
    for epoch in range(3):
        jb.rest(epoch)
        tb.rest(epoch)
        for i in range(len(jb)):
            (jidx, jsize), (tidx, tsize) = jb[i], tb[i]
            assert tuple(tsize) == tuple(jsize)
            np.testing.assert_array_equal(tidx, jidx)


def test_odd_latent_buckets_raise():
    """SD1.5's step_size 8 gives a 3:2 image a 624x416 bucket (latents
    78x52), which the UNet's x2 upsample cannot give back; the build
    names it and the step size that avoids it."""
    infos = [('a.png', (768, 512))] * 4 + [('b.png', (512, 512))] * 4
    b = tbuckets.RatioBucket.from_files(target_area=512 * 512, num_bucket=2)
    b.build(infos, 4)
    assert (624, 416) in b.used_sizes()
    with pytest.raises(ValueError, match=r'\(624, 416\).*step_size: 64'):
        b.check_sizes(64)
    ok = tbuckets.RatioBucket.from_files(target_area=512 * 512, step_size=64, num_bucket=2)
    ok.build(infos, 4)
    assert sorted(ok.used_sizes()) == [(512, 512), (640, 448)]
    ok.check_sizes(64)


# ----------------------------------------------------------------- crops

@pytest.mark.parametrize('shape,size', [((48, 64, 3), (32, 32)), ((64, 40, 3), (24, 40)),
                                        ((50, 50, 3), (64, 48))])
def test_crops_match_pillow(shape, size):
    arr = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    for seed in (None, 1, 2):
        rj = None if seed is None else np.random.default_rng(seed)
        rt = None if seed is None else np.random.default_rng(seed)
        jimg, jinfo = jutils.resize_crop_fix(Image.fromarray(arr), size, rj)
        timg, tinfo = tutils.resize_crop_fix(arr, size, rt)
        np.testing.assert_array_equal(timg, np.asarray(jimg))
        assert tinfo == jinfo
    jimg, jinfo = jutils.pad_crop_fix(Image.fromarray(arr), size)
    timg, tinfo = tutils.pad_crop_fix(arr, size)
    np.testing.assert_array_equal(timg, np.asarray(jimg))
    assert tinfo == jinfo
    np.testing.assert_array_equal(tutils.to_model_input(timg), jutils.to_model_input(jimg))


def test_rgba_composite_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    rgba = rng.integers(0, 256, (20, 30, 4), dtype=np.uint8)
    rgba[0, :10, 3] = 0
    rgba[1, :10, 3] = 255
    path = str(tmp_path / 'a.png')
    write_png(path, rgba)
    for bg in ((255, 255, 255), (10, 200, 30)):
        ref = np.asarray(jutils.composite_rgba(Image.open(path), bg))
        np.testing.assert_array_equal(tutils.load_rgb(path, bg), ref)


def test_non_png_images_raise_naming_the_file(tmp_path):
    """A progressive JPEG, a BMP, a TIFF and a JPEG-compressed TIFF, which
    the port refused before it had their decoders, load as the JAX package
    loads them; a WebP-compressed TIFF (which Pillow's libtiff cannot read
    either) and a file that is no image raise, naming the file."""
    path = str(tmp_path / 'photo.jpg')
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(path, progressive=True)
    assert get_image_size(path) == (8, 8)
    np.testing.assert_array_equal(tutils.load_rgb(path),
                                  np.asarray(jutils.composite_rgba(Image.open(path))))
    Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).save(path)
    np.testing.assert_array_equal(tutils.load_rgb(path), np.asarray(Image.open(path)))
    bmp = str(tmp_path / 'photo.bmp')
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(bmp)
    np.testing.assert_array_equal(tutils.load_rgb(bmp), np.asarray(Image.open(bmp)))
    tif = str(tmp_path / 'photo.tif')
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(tif)
    np.testing.assert_array_equal(tutils.load_rgb(tif), np.asarray(Image.open(tif)))
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(tif, compression='jpeg')
    np.testing.assert_array_equal(tutils.load_rgb(tif),
                                  np.asarray(jutils.composite_rgba(Image.open(tif))))
    data = bytearray(open(tif, 'rb').read())
    data[data.index(b'\x03\x01\x03\x00\x01\x00\x00\x00\x07\x00') + 8] = 0x51   # 50001
    data[data.index(b'\x03\x01\x03\x00\x01\x00\x00\x00\x51\x00') + 9] = 0xC3
    open(tif, 'wb').write(bytes(data))
    with pytest.raises(ValueError, match='photo.tif: WebP-compressed TIFF'):
        tutils.load_rgb(tif)
    junk = tmp_path / 'junk.png'
    junk.write_bytes(b'not an image')
    with pytest.raises(ValueError, match='junk.png'):
        get_image_size(str(junk))
    with pytest.raises(ValueError, match='junk.png'):
        tutils.load_rgb(str(junk))


# --------------------------------------------------------------- batches

@pytest.fixture(scope='module')
def image_dir(tmp_path_factory):
    """PNGs of three sizes (one RGBA), captions, and attention maps."""
    d = tmp_path_factory.mktemp('imgs')
    att = d / 'att'
    att.mkdir()
    rng = np.random.default_rng(2)
    caps = {}
    for i in range(7):
        shape = (64, 64, 3) if i < 4 else (48, 72, 3) if i < 6 else (64, 64, 4)
        write_png(str(d / f'img_{i}.png'), rng.integers(0, 256, shape, dtype=np.uint8))
        write_png(str(att / f'img_{i}.png'), rng.integers(0, 256, shape[:2], dtype=np.uint8))
        caps[f'img_{i}'] = f'photo, cat {i}, painting, dog'
    with open(d / 'captions.json', 'w') as f:
        json.dump(caps, f)
    return d


def _encode(images):
    """A deterministic stand-in for the VAE: [N, H, W, 3] -> [N, H/2, W/2, 4]."""
    x = images[:, ::2, ::2]
    return np.concatenate([x, x.mean(-1, keepdims=True)], -1).astype(np.float32)


def _datasets(image_dir, bucket, cached, att):
    out = []
    for src_mod, ds_mod, tr, bk, fe, tk in (
            (jsources, jdataset, jtransforms, jbuckets, JFrontend, JTokenizer),
            (tsources, tdataset, ttransforms, tbuckets, TFrontend, TTokenizer)):
        kw = dict(caption_file=str(image_dir / 'captions.json'),
                  text_transforms=tr.Compose([tr.TagShuffle(), tr.TagDropout(p=0.3)]))
        if att:
            src = src_mod.Text2ImageAttMapSource(str(image_dir), att_map_root=str(image_dir / 'att'),
                                                 **kw)
        else:
            src = src_mod.Text2ImageSource(str(image_dir), **kw)
        tok = tk.tiny(words=WORDS)
        frontend = fe(tok, None, None) if fe is JFrontend else fe(tok, None)
        ds = ds_mod.TextImagePairDataset(src, bucket(bk), frontend=frontend, vae_scale=2)
        ds.build(2)
        if cached:
            ds.cache_all_latents(_encode)
        out.append(ds)
    return out


@pytest.mark.parametrize('case', ['images_fixed', 'latents_ratio', 'att_mask'])
def test_batches_match_jax(image_dir, case):
    """4 steps of CycleData (crossing an epoch): every array bitwise equal."""
    if case == 'latents_ratio':
        bucket = lambda m: m.RatioBucket.from_files(target_area=32 * 32, step_size=16,
                                                    num_bucket=2)
    else:
        bucket = lambda m: m.FixedBucket(target_size=32)
    jds, tds = _datasets(image_dir, bucket, cached=case == 'latents_ratio',
                         att=case == 'att_mask')
    assert [p for p, _ in tds.files] == [p for p, _ in jds.files]
    jit, tit = iter(jdataset.CycleData(jds)), iter(tdataset.CycleData(tds))
    for _ in range(4):
        jb, tb = next(jit), next(tit)
        assert sorted(tb) == sorted(jb)
        for key in jb:
            np.testing.assert_array_equal(np.asarray(tb[key]), np.asarray(jb[key]), err_msg=key)
        assert ('latents' in tb) == (case == 'latents_ratio')
        assert ('att_mask' in tb) == (case == 'att_mask')


def test_cycle_data_starts_where_it_is_told(image_dir):
    """A resumed run's data: starting at (epoch 1, batch 1) gives what the
    uninterrupted iterator gives there."""
    _, tds = _datasets(image_dir, lambda m: m.FixedBucket(target_size=32), False, False)
    n = len(tds)
    full = iter(tdataset.CycleData(tds))
    want = [next(full) for _ in range(n + 3)][n + 1:]
    start = iter(tdataset.DataGroup([tds], start=[(1, 1)]))
    for w in want:
        got = next(start)[0]
        for key in w:
            np.testing.assert_array_equal(got[key], w[key])
    start.close()


@pytest.mark.parametrize('kind', ['json', 'yaml', 'txt'])
def test_caption_loaders_match_jax(tmp_path, kind):
    caps = {'a.png': 'x, y', 'b': "a 'quoted': caption"}
    if kind == 'json':
        path = tmp_path / 'c.json'
        path.write_text(json.dumps(caps))
    elif kind == 'yaml':
        path = tmp_path / 'c.yaml'
        path.write_text(''.join(f'{k}: "{v}"\n' for k, v in caps.items()))
    else:
        path = tmp_path
        for k, v in caps.items():
            (tmp_path / f'{os.path.splitext(k)[0]}.txt').write_text(v)
    got = tcaptions.auto_caption_loader(str(path))()
    assert got == jcaptions.auto_caption_loader(str(path))() == {'a': 'x, y',
                                                               'b': "a 'quoted': caption"}


# ------------------------------------------------------------- schedules

NAMES = ['constant', 'constant_with_warmup', 'linear', 'cosine', 'cosine_with_restarts',
         'polynomial', 'one_cycle']


@pytest.mark.parametrize('name', NAMES)
def test_make_schedule_matches_optax(name):
    for lr, warm, total, kw in ((1e-4, 50, 300, {}), (1e-6, 20, 200, {}),
                                (3e-4, 0, 57, {}), (1e-5, 5, 40,
                                                    dict(num_cycles=3, power=2.0,
                                                         min_lr_ratio=0.1))):
        j, t = jschedule(name, lr, warm, total, **kw), tschedule(name, lr, warm, total, **kw)
        steps = np.arange(total + 5)
        np.testing.assert_allclose([t(int(s)) for s in steps], [float(j(int(s))) for s in steps],
                                   rtol=0, atol=1e-7)
    for warm, total in ((10, 100), (3, 11)):
        j, t = jschedule(name, 1.0, warm, total), tschedule(name, 1.0, warm, total)
        steps = np.arange(total + 5)
        np.testing.assert_allclose([t(int(s)) for s in steps], [float(j(int(s))) for s in steps],
                                   rtol=2.4e-7, atol=1e-7)


def test_latent_cache_file_is_the_jax_one(image_dir, tmp_path):
    """``cache_dir``: the JAX dataset's latents_<md5>.npz loads into the
    port's dataset, entry for entry, and the port writes the same file."""
    bucket = lambda m: m.FixedBucket(target_size=32)
    jds, tds = _datasets(image_dir, bucket, cached=False, att=False)
    jds.cache_dir, tds.cache_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    jds.cache_all_latents(_encode)
    tds.cache_dir = jds.cache_dir
    assert tds.load_latent_cache()
    assert sorted(tds._latent_cache) == sorted(jds._latent_cache)
    for key, value in jds._latent_cache.items():
        latent, crop_info = tds._latent_cache[key]
        np.testing.assert_array_equal(latent, value)
        assert crop_info is None            # a disk cache keeps no crop geometry
    tds.cache_dir = str(tmp_path / 'port')
    tds.cache_all_latents(_encode)
    assert os.listdir(tds.cache_dir) == os.listdir(jds.cache_dir)


def test_webui_embeddings_interchange(tmp_path):
    from hcpdiff_tpu.ckpt import formats as jformats
    from hcpdiff_tpu_torch.ckpt import formats as tformats
    vecs = np.random.default_rng(7).standard_normal((3, 32)).astype(np.float32)
    tformats.save_webui_embedding(str(tmp_path / 'a.pt'), vecs, 'pt-a', 5)
    jformats.save_webui_embedding(str(tmp_path / 'b.pt'), vecs, 'pt-b', 5)
    for path, name in (('a.pt', 'pt-a'), ('b.pt', 'pt-b')):
        for mod in (jformats, tformats):
            got_name, got = mod.load_webui_embedding(str(tmp_path / path))
            assert got_name == name
            np.testing.assert_array_equal(got, vecs)


def test_data_group_hands_a_worker_error_to_the_loop(image_dir):
    """An error on the prefetch thread (here a dataset that fails its second
    batch) is raised in the training loop, and closing stops the thread."""
    import threading
    _, tds = _datasets(image_dir, lambda m: m.FixedBucket(target_size=32), False, False)
    real, calls = tds.get_batch, []

    def failing(bi, **kw):
        calls.append(bi)
        if len(calls) == 2:
            raise RuntimeError('unreadable image')
        return real(bi, **kw)
    tds.get_batch = failing
    before = threading.active_count()
    it = iter(tdataset.DataGroup([tds]))
    next(it)
    with pytest.raises(RuntimeError, match='unreadable image'):
        next(it)
    it.close()
    assert threading.active_count() == before
