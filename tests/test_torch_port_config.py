"""The port's config stack and safetensors I/O against the JAX package's and
the reference libraries, on the CPU:

- ``config/yaml_lite.py`` against PyYAML's SafeLoader with the JAX
  loader's YAML 1.2 float rule (``hcpdiff_tpu.config.loader.yaml_load``)
  on every file under ``cfgs/infer`` and ``cfgs/train``, its writer read
  back by ``yaml.safe_load``, and its refusals named by file and line;
- the port's ``config.load`` against ``hcpdiff_tpu.config.load`` on every
  ``cfgs/infer`` file, with and without dotlist overrides;
- ``ckpt/safetensors_io.py`` against ``safetensors.torch`` and
  ``safetensors.numpy``, both ways, in F32, F16, BF16 and I64.
"""
import pathlib

import numpy as np
import pytest
import torch
import yaml

import hcpdiff_tpu.config as jcfg
from hcpdiff_tpu.config.loader import yaml_load as jax_yaml_load
import hcpdiff_tpu_torch.config as tcfg
from hcpdiff_tpu_torch.ckpt import safetensors_io
from hcpdiff_tpu_torch.config import yaml_lite

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFGS = ROOT / 'cfgs'
YAMLS = sorted((CFGS / 'infer').rglob('*.yaml')) + sorted((CFGS / 'train').rglob('*.yaml'))
INFER = sorted((CFGS / 'infer').rglob('*.yaml'))
OVERRIDES = ['seed=3', 'bs=2', 'infer_args.width=256', 'infer_args.guidance_scale=5',
             'prompt=a photo of a cat, 1girl', 'new.list=[1, 2.5, x]', 'merge=---',
             "neg_prompt='quoted: yes'", 'dtype=fp32', 'infer_args.karras=true']


def _rel(p):
    return str(p.relative_to(ROOT))


@pytest.mark.parametrize('path', YAMLS, ids=_rel)
def test_reader_matches_pyyaml(path):
    text = path.read_text()
    assert yaml_lite.loads(text, str(path)) == jax_yaml_load(text)


@pytest.mark.parametrize('path', YAMLS, ids=_rel)
def test_writer_round_trips(path):
    tree = yaml_lite.load(path)
    text = yaml_lite.dumps(tree)
    assert yaml.safe_load(text) == tree
    assert yaml_lite.loads(text) == tree


def test_writer_quotes_what_would_read_back_otherwise():
    tree = {'a': 'yes', 'b': '1e-4', 'c': '', 'd': 'it\'s: x # y', 'e': 'line\nbreak\t"q"',
            'f': None, 'g': [True, 0.1, 1e-05, float('inf'), -3], 'h': {}, 'i': [],
            'j': [[1, 2], {'k': 'v', 'l': ['m']}], 'n': '~', 'o': '${hcp.eval:"1+1"}',
            'p': '- item', 'q': 'plain text/path_1.png', 'r': '12:30', 's': '0x10'}
    text = yaml_lite.dumps(tree)
    assert yaml.safe_load(text) == tree
    assert yaml_lite.loads(text) == tree


@pytest.mark.parametrize('text', [
    '', 'a', '0.8', '1e-4', '.5', '-.inf', '[a, b]', '{a: 1, b: [1, 2]}', 'a: b', 'yes',
    'Off', '0x1f', '017', '0b101', '1_000', '1:30', '~', "'it''s'", '"x\\ty\\u00e9"', 'a #c',
    'k: v  # c\nl:\n- 1\n- {m: n}\n', 'a: [1,\n  2,\n]\nb: 2', 'x: "a: b"', '3.', '+1'])
def test_reader_matches_pyyaml_on_scalars_and_documents(text):
    assert yaml_lite.loads(text) == jax_yaml_load(text)


@pytest.mark.parametrize('text, what', [
    ('a: |\n  b\n', 'block scalars'), ('a: >\n  b\n', 'block scalars'),
    ('a: &x 1\nb: *x\n', 'anchors and aliases'), ('a: *x\n', 'anchors and aliases'),
    ('a: 1\n---\nb: 2\n', 'one document'), ('a: !!str 1\n', 'tags'),
    ('a: 2023-04-01\n', 'timestamps'), ("a: 'open\n  more'\n", 'close on their line'),
    ('a: b\n  c\n', 'multi-line'), ('<<: {a: 1}\n', 'merge keys')])
def test_reader_refuses_with_file_and_line(text, what):
    with pytest.raises(yaml_lite.YAMLError, match=r'cfg\.yaml:\d+: .*' + what):
        yaml_lite.loads(text, 'cfg.yaml')


def _plain(cfg):
    """to_plain, with dtypes by name and hcp.time strings left out."""
    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        if hasattr(v, 'dtype') or isinstance(v, torch.dtype) or type(v).__name__ == 'type':
            return str(v).split('.')[-1].strip("'>")
        return v
    return walk(cfg)


@pytest.mark.parametrize('overrides', [[], OVERRIDES], ids=['plain', 'overrides'])
@pytest.mark.parametrize('path', INFER, ids=_rel)
def test_load_matches_jax(path, overrides):
    assert _plain(tcfg.to_plain(tcfg.load(str(path), overrides))) == \
        _plain(jcfg.to_plain(jcfg.load(str(path), overrides)))


def test_resolvers_and_interpolation_match_jax(tmp_path):
    p = tmp_path / 'c.yaml'
    p.write_text('size: 512\narea: ${hcp.eval:"512*512"}\nmirror: ${size}\n'
                 'msg: "img-${size}px"\nsub:\n  a: 1\n  b: ${.a}\n'
                 'dt: ${hcp.dtype:fp16}\namp: ${hcp.dtype:amp}\nbf: ${hcp.dtype:bf16}\n'
                 'when: ${hcp.time:}\n')
    t, j = tcfg.load(str(p)), jcfg.load(str(p))
    assert (t.dt, t.amp, t.bf) == (torch.float16, torch.float32, torch.bfloat16)
    del t['when'], j['when']
    assert _plain(tcfg.to_plain(t)) == _plain(jcfg.to_plain(j))


def test_locate_rewrites_the_jax_package_and_never_imports_it():
    from hcpdiff_tpu_torch.infer.interfaces import DiskInterface
    assert tcfg.locate('hcpdiff_tpu.infer.interfaces.DiskInterface') is DiskInterface
    with pytest.raises(ImportError, match='hcpdiff_tpu_torch.infer.interfaces.NoSuch'):
        tcfg.locate('hcpdiff_tpu.infer.interfaces.NoSuch')
    with pytest.raises(ImportError, match='does not import'):
        tcfg.locate('jax.numpy.float32')
    built = tcfg.instantiate({'_target_': 'hcpdiff_tpu.config.node.Cfg', 'a': 1})
    assert isinstance(built, tcfg.Cfg) and built.a == 1


def test_save_config_reads_back(tmp_path):
    cfg = tcfg.load(str(CFGS / 'infer' / 'inpaint.yaml'), OVERRIDES)
    tcfg.save_config(cfg, str(tmp_path / 'out.yaml'))
    assert yaml.safe_load((tmp_path / 'out.yaml').read_text()) == tcfg.to_plain(cfg)


# ------------------------------------------------------------- safetensors

def _tensors(dtype):
    g = torch.Generator().manual_seed(0)
    if dtype == torch.int64:
        return {'w': torch.randint(-2**40, 2**40, (5, 3), generator=g), 'b': torch.arange(7),
                'empty': torch.zeros(0, 2, dtype=dtype)}
    return {'layer.weight': torch.randn(6, 4, generator=g).to(dtype),
            'layer.bias': torch.randn(6, generator=g).to(dtype),
            'scalar': torch.tensor(1.5).to(dtype), 'conv': torch.randn(2, 3, 3, 1, generator=g).to(dtype),
            'odd': torch.randn(3, generator=g).to(dtype)}


DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64]


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_safetensors_written_here_read_by_the_library(dtype, tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load
    t = _tensors(dtype)
    safetensors_io.save_file(t, str(tmp_path / 'a.safetensors'), metadata={'format': 'pt'})
    got = torch_load(str(tmp_path / 'a.safetensors'))
    assert got.keys() == t.keys()
    for k in t:
        assert got[k].dtype == dtype and torch.equal(got[k], t[k]), k
    if dtype != torch.bfloat16:                  # numpy has no bfloat16
        got = np_load(str(tmp_path / 'a.safetensors'))
        for k in t:
            np.testing.assert_array_equal(got[k], t[k].numpy())


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_safetensors_written_by_the_library_read_here(dtype, tmp_path):
    from safetensors.torch import save_file as torch_save
    t = _tensors(dtype)
    torch_save(t, str(tmp_path / 'b.safetensors'), metadata={'format': 'pt'})
    got = safetensors_io.load_file(str(tmp_path / 'b.safetensors'))
    assert got.keys() == t.keys()
    for k in t:
        assert got[k].dtype == dtype and got[k].shape == t[k].shape and torch.equal(got[k], t[k])
