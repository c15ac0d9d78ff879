"""The port's output interfaces against the JAX package's, on the CPU:

- ``utils/images.py``'s animated WebP writer: Pillow (in this sandbox, not
  on the card's machine) decodes every frame bitwise equal to what was
  written, at even and odd sizes, with the frame count, duration, loop and
  canvas written; the port's own reader gives back the chunks and pixels,
  and refuses other layouts;
- ``DiskAnimInterface`` against the JAX one on the same frames: the port
  writes ``{n}-steps.webp`` beside each ``{n}-img.png``, lossless; the JAX
  one writes every image of a batch to ``{last n}-steps.webp`` (the
  reference defect the port does not copy: only the last animation is
  kept, and lossy), with the same frame count and duration;
- the Visualizer through ``main()`` with the animation and WebUI
  interfaces: each file's frames are the decoded x0 previews of
  ``txt2img(return_x0_history=True)`` bitwise, and the ``[hcp-...]`` lines
  equal the JAX Visualizer's on the same config.
"""
import contextlib
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from hcpdiff_tpu.config import load as jload
from hcpdiff_tpu.infer import interfaces as jinterfaces
from hcpdiff_tpu.infer.visualizer import Visualizer as JVisualizer
from hcpdiff_tpu_torch.infer import interfaces as tinterfaces
from hcpdiff_tpu_torch.infer.visualizer import main
from hcpdiff_tpu_torch.utils import images
from tests.test_torch_port_visualizer import _write_jax_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, 'cfgs', 'infer', 'text2img.yaml')
STEPS = 3
CPU = ['device=cpu', 'dtype=fp32', 'infer_args.width=32', 'infer_args.height=32',
       f'infer_args.inference_steps={STEPS}', 'bs=2', 'seed=5']
ANIM = 'hcpdiff_tpu.infer.interfaces.DiskAnimInterface'
WEBUI = 'hcpdiff_tpu.infer.interfaces.WebUIInterface'


def _pillow_frames(path):
    with Image.open(path) as im:
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append((np.asarray(im.convert('RGB')), im.info.get('duration')))
        return out, im.info.get('loop'), im.size


@pytest.mark.parametrize('shape, n', [((32, 32), 3), ((37, 53), 2), ((1, 5), 1), ((8, 9), 4)])
def test_webp_frames_decode_bitwise_in_pillow(tmp_path, shape, n):
    rng = np.random.default_rng(sum(shape) + n)
    frames = [rng.integers(0, 256, shape + (3,), dtype=np.uint8) for _ in range(n)]
    path = str(tmp_path / 'a.webp')
    images.write_webp_anim(path, frames, 120)
    got, loop, size = _pillow_frames(path)
    assert len(got) == n and loop == 0 and size == (shape[1], shape[0])
    for (img, duration), want in zip(got, frames):
        np.testing.assert_array_equal(img, want)
        assert duration == 120
    back = images.read_webp_anim(path)
    assert back['canvas'] == (shape[1], shape[0]) and back['loop'] == 0
    assert back['flags'] == 0x02 and len(back['frames']) == n
    for f, want in zip(back['frames'], frames):
        assert f['offset'] == (0, 0) and f['size'] == (shape[1], shape[0])
        assert f['duration'] == 120 and f['flags'] == 0x02
        np.testing.assert_array_equal(f['image'], want)


def test_webp_layout_odd_chunks_and_refusals(tmp_path):
    """RIFF size, chunk order, a VP8L payload of odd length padded to even,
    the 14-bit size fields, and the reader's refusals."""
    frame = np.zeros((3, 3, 3), np.uint8)
    vp8l = images.encode_vp8l(frame)
    data = images.encode_webp_anim([frame], 40)
    assert data[:4] == b'RIFF' and struct.unpack('<I', data[4:8])[0] == len(data) - 8
    assert data[12:16] == b'VP8X' and data[30:34] == b'ANIM' and data[44:48] == b'ANMF'
    anmf = struct.unpack('<I', data[48:52])[0]
    assert anmf == 16 + 8 + len(vp8l) + len(vp8l) % 2 and len(data) % 2 == 0
    assert vp8l[0] == 0x2f
    bits = int.from_bytes(vp8l[1:5], 'little')
    assert (bits & 0x3fff, (bits >> 14) & 0x3fff, bits >> 28) == (2, 2, 0)
    with pytest.raises(ValueError, match='sides'):
        images.encode_vp8l(np.zeros((1, 16385, 3), np.uint8))
    with pytest.raises(ValueError, match='one size'):
        images.encode_webp_anim([frame, np.zeros((4, 3, 3), np.uint8)], 40)
    bad = str(tmp_path / 'bad.webp')
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(bad, lossless=True)
    with pytest.raises(ValueError, match='chunks'):
        images.read_webp_anim(bad)


def test_disk_anim_interface_against_jax(tmp_path):
    """The same two-image batch and three steps' frames into both: the port
    writes 0- and 1-steps.webp, the JAX one only 1-steps.webp (the last
    image's, lossy)."""
    rng = np.random.default_rng(3)
    frames = [rng.uniform(0, 1, (2, 16, 24, 3)).astype(np.float32) for _ in range(STEPS)]
    imgs = rng.uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    out = {}
    for name, mod in (('port', tinterfaces), ('jax', jinterfaces)):
        root = str(tmp_path / name)
        itf = mod.DiskAnimInterface(save_root=root)
        assert itf.need_inter_imgs and itf.frame_ms == 150
        for i, f in enumerate(frames):
            itf.on_inter_step(i, STEPS, None, None, f)
        itf.on_infer_finish(imgs, {'seed': 1})
        out[name] = root
    assert sorted(os.listdir(out['port'])) == ['0-img.png', '0-img.yaml', '0-steps.webp',
                                               '1-img.png', '1-img.yaml', '1-steps.webp']
    assert sorted(os.listdir(out['jax'])) == ['0-img.png', '0-img.yaml', '1-img.png',
                                              '1-img.yaml', '1-steps.webp']
    jframes, jloop, _ = _pillow_frames(os.path.join(out['jax'], '1-steps.webp'))
    for b in range(2):
        got, loop, size = _pillow_frames(os.path.join(out['port'], f'{b}-steps.webp'))
        assert len(got) == len(jframes) == STEPS and loop == jloop and size == (24, 16)
        for (img, duration), f, (_, jduration) in zip(got, frames, jframes):
            np.testing.assert_array_equal(img, (np.clip(f[b], 0, 1) * 255).astype(np.uint8))
            assert duration == jduration == 150
    # the JAX file holds the last image's frames (lossy: near, not equal)
    last = [(np.clip(f[1], 0, 1) * 255).astype(np.uint8) for f in frames]
    assert all(np.abs(j.astype(int) - w).mean() < np.abs(j.astype(int) - (np.clip(
        f[0], 0, 1) * 255).astype(int)).mean() for (j, _), w, f in zip(jframes, last, frames))


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('anim') / 'sd15')
    _write_jax_dir('sd15', path)
    return path


def _lines(text):
    return [ln for ln in text.splitlines() if ln.startswith('[hcp-')]


def _cfg(tmp_path, out, *targets):
    """A config on text2img.yaml whose interface list is ``targets``, each
    saving to ``out``."""
    path = str(tmp_path / f'cfg_{len(targets)}_{os.path.basename(out)}.yaml')
    with open(path, 'w') as f:
        f.write(f'_base_: [{CFG}]\ninterface:\n')
        for tgt in targets:
            f.write(f'  - _target_: {tgt}\n    save_root: {out}\n')
    return path


def _over(model_dir, out):
    return [f'pretrained_model={model_dir}', f'output_dir={out}', *CPU]


def test_visualizer_anim_and_webui_against_jax(model_dir, tmp_path):
    out = str(tmp_path / 'port')
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        viser, imgs = main(['--cfg', _cfg(tmp_path, out, ANIM, WEBUI), *_over(model_dir, out)])
    lines = _lines(buf.getvalue())
    assert [type(i).__name__ for i in viser.interfaces] == ['DiskAnimInterface', 'WebUIInterface']
    # the frames are the decoded x0 previews of the same request
    c = viser.cfgs
    ref, x0s = viser.pipe.txt2img(c.prompt, c.neg_prompt, width=32, height=32, num_steps=STEPS,
                                  guidance_scale=float(c.infer_args.guidance_scale), seed=5,
                                  batch_size=2, return_x0_history=True)
    np.testing.assert_array_equal(imgs, ref)
    assert x0s.shape[0] == STEPS
    for b in range(2):
        back = images.read_webp_anim(str(tmp_path / 'port' / f'{b}-steps.webp'))
        assert back['canvas'] == (32, 32) and len(back['frames']) == STEPS
        for si, f in enumerate(back['frames']):
            want = (np.clip(viser.pipe.decode(x0s[si])[b], 0, 1) * 255).astype(np.uint8)
            np.testing.assert_array_equal(f['image'], want)
    # the JAX Visualizer on the same config: the same lines, frames, duration
    jout = str(tmp_path / 'jax')
    jv = JVisualizer(jload(_cfg(tmp_path, jout, ANIM, WEBUI), _over(model_dir, jout)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jv.vis_to_dir(num=1)
    assert lines == _lines(buf.getvalue())
    assert lines == [f'[hcp-progress] {i}/{STEPS} t=None' for i in range(STEPS)] + [
        '[hcp-finish] n=2']
    jframes, _, _ = _pillow_frames(str(tmp_path / 'jax' / '1-steps.webp'))
    got, _, _ = _pillow_frames(str(tmp_path / 'port' / '1-steps.webp'))
    assert [d for _, d in got] == [d for _, d in jframes]


def test_webui_alone_prints_the_finish_line_only(model_dir, tmp_path):
    """Without an interface asking for x0 previews no step hook runs, in
    both packages: WebUIInterface alone prints only its finish line."""
    out = {}
    for name in ('port', 'jax'):
        cfg = _cfg(tmp_path, str(tmp_path / name), WEBUI)
        over = _over(model_dir, str(tmp_path / name)) + ['num=2']
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if name == 'port':
                main(['--cfg', cfg, *over])
            else:
                JVisualizer(jload(cfg, over)).vis_to_dir(num=2)
        out[name] = _lines(buf.getvalue())
    assert out['port'] == out['jax'] == ['[hcp-finish] n=2'] * 2
    assert not os.path.exists(tmp_path / 'port') or not os.listdir(tmp_path / 'port')


def test_anim_refuses_image_modes(model_dir, tmp_path):
    init = str(tmp_path / 'init.png')
    images.write_png(init, np.zeros((32, 32, 3), np.uint8))
    out = str(tmp_path / 'out')
    with pytest.raises(ValueError, match='txt2img requests only'):
        main(['--cfg', _cfg(tmp_path, out, ANIM), *_over(model_dir, out), 'mode=i2i',
              f'init_image={init}'])
