"""The port's loggers (``loggers/base.py``, ``utils/tb_events.py``) against
the JAX package's on the same calls:

- ``TBLogger``: the event file the port writes with the stdlib, read back
  by ``tensorboard``'s ``EventAccumulator`` and by the port's own reader
  (every CRC checked), gives the same (tag, step, value) triples as the
  file the JAX ``TBLogger`` writes through ``SummaryWriter``, and the same
  image pixels;
- ``CLILogger.log_image`` writes the same PNG pixels as the JAX one;
  ``WebUILogger`` prints the same progress lines;
- ``WanDBLogger`` without ``wandb`` switches itself off as the JAX one does,
  and the group prints one warning naming the package; ``log_step`` is the
  gcd over the enabled loggers, as in JAX;
- a corrupted byte fails the reader's CRC check; an unknown logger raises.
"""
import os
import sys
import types

import numpy as np
import pytest
from PIL import Image

from hcpdiff_tpu.loggers import base as jbase
from hcpdiff_tpu_torch.loggers import base as tbase
from hcpdiff_tpu_torch.utils.images import read_png
from hcpdiff_tpu_torch.utils.tb_events import read_events
from tests.torch_port_common import one_torch_thread  # noqa: F401

CALLS = [({'loss': 0.5, 'step': 1}, 1), ({'loss': 0.25, 'lr': 1e-4, 'step': 2, 'note': 'x'}, 2),
         ({'loss': 0.125, 'step': 5}, 5)]


def _image():
    rng = np.random.default_rng(0)
    img = rng.random((12, 16, 3)).astype(np.float32)
    img[0, 0] = [-0.5, 1.5, 1.0]                     # clipped
    return img


def _drive(logger):
    for datas, step in CALLS:
        logger.log(datas, step)
    logger.log_image({'preview': _image()}, 5)


def _accumulated(log_dir):
    ea = pytest.importorskip('tensorboard.backend.event_processing.event_accumulator')
    acc = ea.EventAccumulator(str(log_dir), size_guidance={'images': 0, 'scalars': 0})
    acc.Reload()
    scalars = sorted((tag, e.step, e.value) for tag in acc.Tags()['scalars']
                     for e in acc.Scalars(tag))
    images = {tag: [(e.step, e.width, e.height, e.encoded_image_string) for e in acc.Images(tag)]
              for tag in acc.Tags()['images']}
    return scalars, images


def _pixels(png: bytes) -> np.ndarray:
    import io
    return np.asarray(Image.open(io.BytesIO(png)))


@pytest.fixture(autouse=True)
def no_tensorflow(monkeypatch):
    """tensorboard's own switch to its TensorFlow stub (the JAX TBLogger's
    ``SummaryWriter`` would import TensorFlow, ~20 s, which writing and
    reading event files do not need)."""
    monkeypatch.setitem(sys.modules, 'tensorboard.compat.notf',
                        types.ModuleType('tensorboard.compat.notf'))


def test_tensorboard_file_reads_back_as_the_jax_loggers(tmp_path):
    pytest.importorskip('torch.utils.tensorboard')
    jlog = jbase.TBLogger(exp_dir=str(tmp_path / 'jax'))
    assert jlog.enabled and jlog.writer is not None
    _drive(jlog)
    jlog.writer.close()
    tlog = tbase.TBLogger(exp_dir=str(tmp_path / 'port'))
    _drive(tlog)
    tlog.close()
    jscalars, jimages = _accumulated(tmp_path / 'jax' / 'tb')
    tscalars, timages = _accumulated(tmp_path / 'port' / 'tb')
    assert tscalars == jscalars and len(tscalars) == 7
    assert sorted(timages) == sorted(jimages) == ['preview']
    (jstep, jw, jh, jpng), = jimages['preview']
    (tstep, tw, th, tpng), = timages['preview']
    assert (tstep, tw, th) == (jstep, jw, jh) == (5, 16, 12)
    np.testing.assert_array_equal(_pixels(tpng), _pixels(jpng))

    (path,) = (tmp_path / 'port' / 'tb').iterdir()
    assert path.name.startswith('events.out.tfevents.')
    events = read_events(str(path))
    assert events[0]['file_version'] == 'brain.Event:2'
    mine = sorted((v['tag'], e['step'], v['simple_value']) for e in events for v in e['values']
                  if 'simple_value' in v)
    assert mine == tscalars
    (img,) = [v['image'] for e in events for v in e['values'] if 'image' in v]
    assert (img['height'], img['width'], img['colorspace']) == (12, 16, 3)
    np.testing.assert_array_equal(_pixels(img['png']), _pixels(jpng))

    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 1
    bad = tmp_path / 'bad'
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match='CRC|cut'):
        read_events(str(bad))


def test_cli_images_and_webui_lines_match_jax(tmp_path, capsys):
    for pkg, d in ((jbase, 'jax'), (tbase, 'port')):
        os.makedirs(tmp_path / d)
        logger = pkg.CLILogger(exp_dir=str(tmp_path / d), log_step=1)
        logger.log_image({'preview': _image(), 'raw': (_image() * 255).astype(np.uint8)}, 3)
        logger.disable()
        logger.log_image({'preview': _image()}, 4)
        assert not (tmp_path / d / 'imgs' / '4-preview.png').exists()
    for name in ('3-preview.png', '3-raw.png'):
        np.testing.assert_array_equal(read_png(str(tmp_path / 'port' / 'imgs' / name)),
                                      np.asarray(Image.open(tmp_path / 'jax' / 'imgs' / name)))
    capsys.readouterr()
    lines = []
    for pkg in (jbase, tbase):
        logger = pkg.WebUILogger(exp_dir=None, log_step=1)
        for datas, step in CALLS:
            logger.log(datas, step)
        lines.append([l for l in capsys.readouterr().out.splitlines() if 'hcp-progress' in l])
    assert lines[0] == lines[1] and len(lines[0]) == 3
    assert lines[1][0] == '[hcp-progress] step=1 loss=0.5 step=1'


def test_wandb_switches_off_with_one_warning(tmp_path, capsys, monkeypatch):
    """Without wandb (this is the CPU suite's case; where it is installed,
    the warning case cannot happen and its disabled mode is forced)."""
    monkeypatch.setenv('WANDB_MODE', 'disabled')
    monkeypatch.setitem(sys.modules, 'wandb', None)        # import wandb raises ImportError
    cfg = [{'_target_': 'hcpdiff_tpu.loggers.CLILogger', 'log_step': 20},
           {'_target_': 'hcpdiff_tpu.loggers.TBLogger', 'log_step': 6},
           {'_target_': 'hcpdiff_tpu.loggers.WanDBLogger', 'log_step': 5}]
    jgroup = jbase.build_loggers(cfg, str(tmp_path))
    tgroup = tbase.build_loggers(cfg, str(tmp_path))
    assert [l.enabled for l in tgroup.loggers] == [l.enabled for l in jgroup.loggers] == [
        True, True, False]
    assert tgroup.log_step == jgroup.log_step == 2
    out = capsys.readouterr().out
    assert out.count('the wandb package is not installed') == 1
    tgroup.loggers[0].disable()
    assert tgroup.log_step == 6
    tgroup.add_logger(tbase.WebUILogger(log_step=4))
    assert tgroup.log_step == 2
    tgroup.close()


def test_unknown_logger_raises():
    """...while the reference's and the JAX package's paths resolve by their
    class name."""
    group = tbase.build_loggers([{'_target_': 'hcpdiff.loggers.WebUILogger', 'log_step': 3},
                                 {'_target_': 'hcpdiff_tpu.loggers.CLILogger', 'log_step': 6}])
    assert [type(l) for l in group.loggers] == [tbase.WebUILogger, tbase.CLILogger]
    assert group.log_step == 3
    group.close()
    with pytest.raises(ValueError, match='unknown _target_'):
        tbase.build_loggers([{'_target_': 'hcpdiff_tpu.loggers.NoSuchLogger'}])
