"""The reference's ``_target_: hcpdiff.…`` paths in the port: every public
name of the JAX package's ``compat`` (ControlNet's dataset and the workflow
actions among them) resolves through the port's ``locate('hcpdiff.…')`` to
the port's object of the same name; the shipped configs that name such
paths resolve all their targets; and the port's new modules are among the
import rule's files."""
import inspect
import pathlib

import pytest

import hcpdiff_tpu.compat as jcompat
from hcpdiff_tpu_torch import compat
from hcpdiff_tpu_torch.config import load
from hcpdiff_tpu_torch.config.instantiate import instantiate, locate
from tests.test_torch_port_imports import FILES

ROOT = pathlib.Path(__file__).resolve().parent.parent
PUBLIC = sorted(n for n in dir(jcompat) if not n.startswith('_'))


def _public(obj):
    return {n for n in vars(obj) if not n.startswith('_')}


def _check(path, jobj):
    """``hcpdiff.<path>`` in the port against the JAX compat's object:
    modules are the port's module of the same path, namespaces hold the
    same names (each checked in turn), classes and functions are the
    port's of the same name."""
    obj = locate(f'hcpdiff.{path}')
    if inspect.ismodule(jobj):
        assert obj.__name__ == jobj.__name__.replace('hcpdiff_tpu.', 'hcpdiff_tpu_torch.', 1)
    elif inspect.isclass(jobj) and jobj.__module__ == jcompat.__name__ or not (
            inspect.isclass(jobj) or callable(jobj)):
        assert _public(obj) == _public(jobj), path        # a namespace
        for name in _public(jobj):
            _check(f'{path}.{name}', getattr(jobj, name))
    else:
        assert obj.__module__.startswith('hcpdiff_tpu_torch.'), (path, obj.__module__)
        assert obj.__name__ == jobj.__name__


@pytest.mark.parametrize('name', PUBLIC)
def test_every_public_name_resolves_or_refuses(name):
    _check(name, getattr(jcompat, name))


def test_reference_paths_reach_the_port_classes():
    from hcpdiff_tpu_torch.data.buckets import RatioBucket
    from hcpdiff_tpu_torch.data.sources import Text2ImageAttMapSource
    from hcpdiff_tpu_torch.data.transforms import TemplateFill
    assert locate('hcpdiff.data.bucket.RatioBucket.from_files') == RatioBucket.from_files
    assert locate('hcpdiff.data.source.Text2ImageAttMapSource') is Text2ImageAttMapSource
    assert locate('hcpdiff.utils.caption_tools.TemplateFill') is TemplateFill
    assert locate('hcpdiff.data.TextImagePairDataset') is compat.TextImagePairDataset
    with pytest.raises(ImportError):
        locate('hcpdiff.no_such_thing')


def _targets(node):
    if isinstance(node, dict):
        if '_target_' in node:
            yield str(node['_target_'])
        for v in node.values():
            yield from _targets(v)
    elif isinstance(node, list):
        for v in node:
            yield from _targets(v)


@pytest.mark.parametrize('cfg', ['cfgs/train/examples/DreamArtist.yaml',
                                 'cfgs/train/dataset/regularization_dataset.yaml'])
def test_shipped_configs_resolve_every_target(cfg):
    """Every _target_ of the config that names a module path resolves (the
    short optimizer names and torchvision's Compose, which the trainer
    reads itself, aside), and the regularization dataset's text
    transforms instantiate."""
    cfgs = load(str(ROOT / cfg))
    paths = [t for t in _targets(cfgs) if t.startswith(('hcpdiff.', 'hcpdiff_tpu.'))]
    assert any(p.startswith('hcpdiff.') for p in paths)
    for path in paths:
        assert locate(path) is not None, path
    if 'regularization' in cfg:
        tt = cfgs.data.dataset_class.source.data_source1.text_transforms.transforms
        assert type(instantiate(tt[0])).__name__ == 'TemplateFill'


def test_import_rule_covers_the_new_modules():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for module in ('compat.py', 'utils/cfg_parse.py', 'tools/create_embedding.py',
                   'workflow/base.py', 'workflow/actions.py', 'infer_workflow.py',
                   'trainer/optim_classes.py', 'utils/tb_events.py', 'utils/jpeg.py',
                   'loggers/preview.py'):
        assert f'hcpdiff_tpu_torch/{module}' in names


def test_controlnet_processor_is_the_port_class(tmp_path):
    """ControlNetProcessor, a stand-in before, is the port's class under the
    reference's path (held to the JAX one in test_torch_port_controlnet.py)."""
    import numpy as np
    from hcpdiff_tpu_torch.data.processor import ControlNetProcessor
    from hcpdiff_tpu_torch.utils.images import write_png
    cls = locate('hcpdiff.data.data_processor.ControlNetProcessor')
    assert cls is ControlNetProcessor is compat.ControlNetProcessor
    path = str(tmp_path / 'c.png')
    write_png(path, np.full((8, 8, 3), 255, np.uint8))
    out = instantiate({'_target_': 'hcpdiff.data.data_processor.ControlNetProcessor',
                       'image': path})(width=4, height=4, batch_size=2)
    assert out.shape == (2, 4, 4, 3) and (out == 1.0).all()
