"""The port's baseline JPEG decoder (``utils/jpeg.py``) against Pillow
(libjpeg-turbo with its defaults), on files Pillow writes from seeded
arrays: bitwise, for quality 50/90/100, 4:4:4/4:2:2/4:2:0, greyscale,
restart intervals, optimized Huffman tables, comment and EXIF segments
and odd sizes. Progressive files decode as Pillow decodes them; a
progressive file patched to sequential arithmetic coding raises naming the
file (``test_torch_port_jpeg_rare.py`` holds arithmetic coding). Every
port reader takes JPEG through it (``data/utils.py``'s
``load_rgb``/``load_gray``, ``utils/images.py:read_image``), the files
committed under tests/data/torch_port_jpeg decode as Pillow decodes them, and
``lora_conventional.yaml`` trains 2 steps on a folder of JPEGs."""
import io
import json
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from hcpdiff_tpu_torch.data.utils import load_gray, load_rgb
from hcpdiff_tpu_torch.utils.images import decode_jpeg, read_image, read_jpeg

ROOT = pathlib.Path(__file__).resolve().parent.parent
COMMITTED = ROOT / 'tests' / 'data' / 'torch_port_jpeg'


def _photo(h, w, channels, seed):
    """A smooth image with noise (bicubic-enlarged random cells), so every
    quality keeps AC coefficients of all sizes."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, channels), dtype=np.uint8)
    img = np.asarray(Image.fromarray(cells.squeeze(-1) if channels == 1 else cells).resize(
        (w, h), Image.BICUBIC), np.float32)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def _jpeg(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, 'JPEG', **kw)
    return buf.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


CASES = [(q, sub, size) for q in (50, 90, 100) for sub in (0, 1, 2)
         for size in ((61, 97), (48, 64))]


@pytest.mark.parametrize('quality,subsampling,size', CASES)
def test_colour_jpeg_is_bitwise_pillow(quality, subsampling, size):
    data = _jpeg(_photo(*size, 3, seed=quality + subsampling), quality=quality,
                 subsampling=subsampling)
    got = decode_jpeg(data)
    assert got.shape == size + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pillow(data))


@pytest.mark.parametrize('quality', [50, 90, 100])
def test_greyscale_jpeg_is_bitwise_pillow(quality):
    data = _jpeg(_photo(61, 97, 1, seed=quality), quality=quality)
    got = decode_jpeg(data)
    assert got.shape == (61, 97)
    np.testing.assert_array_equal(got, _pillow(data))


@pytest.mark.parametrize('kw', [dict(restart_marker_blocks=3, subsampling=2),
                                dict(restart_marker_rows=1, subsampling=0),
                                dict(optimize=True, subsampling=1),
                                dict(comment=b'made by a test', exif=b'Exif\0\0' + bytes(40))],
                         ids=['restart_blocks', 'restart_rows', 'optimized', 'comment_exif'])
def test_restarts_tables_and_segments_are_bitwise_pillow(kw):
    data = _jpeg(_photo(61, 97, 3, seed=5), quality=85, **kw)
    np.testing.assert_array_equal(decode_jpeg(data), _pillow(data))


def test_progressive_jpeg_raises_naming_the_file(tmp_path):
    """A progressive JPEG, which the Python decoder refused, now decodes as
    Pillow decodes it through every reader; with its SOF byte patched to
    0xC9 (sequential arithmetic coding, its scans' parameters progressive),
    libjpeg only warns and follows its buffer mode, and the port raises,
    naming the file."""
    path = tmp_path / 'prog.jpg'
    data = _jpeg(_photo(32, 32, 3, seed=1), progressive=True)
    path.write_bytes(data)
    np.testing.assert_array_equal(read_jpeg(str(path)), _pillow(data))
    np.testing.assert_array_equal(load_rgb(str(path)), _pillow(data))
    arith = bytearray(data)
    arith[arith.index(b'\xff\xc2') + 1] = 0xC9
    path.write_bytes(bytes(arith))
    with pytest.raises(ValueError, match='prog.jpg: corrupt or cut JPEG data .a sequential scan '
                                         'with progressive parameters'):
        read_jpeg(str(path))
    with pytest.raises(ValueError, match='prog.jpg: corrupt'):
        load_rgb(str(path))


def test_every_reader_takes_jpeg(tmp_path):
    path = str(tmp_path / 'a.jpg')
    data = _jpeg(_photo(61, 97, 3, seed=2), quality=90)
    pathlib.Path(path).write_bytes(data)
    with Image.open(path) as im:
        rgb, grey = np.asarray(im.convert('RGB')), np.asarray(im.convert('L'))
    for got, want in ((load_rgb(path), rgb), (load_rgb(path, bg_color=None), rgb),
                      (load_gray(path), grey), (read_image(path, 'RGB'), rgb),
                      (read_image(path, 'L'), grey)):
        np.testing.assert_array_equal(got, want)


def test_committed_jpegs_decode_as_pillow():
    files = sorted(COMMITTED.glob('*.jpg'))
    assert len(files) >= 4 and sum(f.stat().st_size for f in files) < 300_000
    for f in files:
        with Image.open(f) as im:
            np.testing.assert_array_equal(read_jpeg(str(f)), np.asarray(im), err_msg=f.name)


def test_lora_conventional_trains_on_jpegs(tmp_path):
    from hcpdiff_tpu_torch.trainer.trainer import main
    imgs = tmp_path / 'imgs'
    imgs.mkdir()
    for i in range(4):
        (imgs / f'img_{i}.jpg').write_bytes(_jpeg(_photo(64, 64, 3, seed=10 + i), quality=90,
                                                  subsampling=2))
    with open(imgs / 'captions.json', 'w') as f:
        json.dump({f'img_{i}': f'a photo of cat {i}' for i in range(4)}, f)
    src = 'data.dataset1.source.data_source1'
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = main(['--cfg', str(ROOT / 'cfgs/train/examples/lora_conventional.yaml'),
                        'model.pretrained_model_name_or_path=tiny', 'device=cpu',
                        'mixed_precision=fp32', f'exp_dir={tmp_path / "exp"}',
                        'train.train_steps=2', 'train.save_step=2', 'logger.0.log_step=1',
                        f'tokenizer_pt.emb_dir={tmp_path / "embs"}', f'{src}.img_root={imgs}',
                        f'{src}.caption_file={imgs / "captions.json"}',
                        'data.dataset1.bucket.target_area=1024',
                        'data.dataset1.bucket.step_size=16'])
    finally:
        torch.set_num_threads(n)
    assert len(trainer.history) == 2 and all(np.isfinite(trainer.history))
    assert (tmp_path / 'exp' / 'ckpts' / 'unet-2.safetensors').exists()
