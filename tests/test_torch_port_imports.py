"""The PyTorch port imports no JAX and nothing of the JAX package: an AST
walk over every module of hcpdiff_tpu_torch (and chip_smoke.py, which
drives it on the card). Not even a module of hcpdiff_tpu that imports no
JAX: the port keeps its own copy of what it needs (the CLIP tokenizer is
hcpdiff_tpu_torch/utils/clip_tokenizer.py)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / 'hcpdiff_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']
ALLOWED_FROM_JAX_PACKAGE = set()


def _absolute_imports(tree):
    """Dotted names of every absolute import; ``from a.b import c`` yields
    ``a.b.c`` (c may be a module or a name in a.b)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield from (f'{node.module}.{alias.name}' for alias in node.names)


def _violations(source: str):
    bad = []
    for name in _absolute_imports(ast.parse(source)):
        top = name.split('.')[0]
        if top in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'):
            bad.append(name)
        elif top == 'hcpdiff_tpu' and not any(name == m or name.startswith(m + '.')
                                              for m in ALLOWED_FROM_JAX_PACKAGE):
            bad.append(name)
    return bad


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    assert _violations(path.read_text()) == []


def test_checker_catches_jax_imports():
    assert _violations('import jax.numpy as jnp') == ['jax.numpy']
    assert _violations('from flax import linen') == ['flax.linen']
    assert _violations('from hcpdiff_tpu.models import unet') == ['hcpdiff_tpu.models.unet']
    assert _violations('from hcpdiff_tpu.utils import clip_tokenizer') == [
        'hcpdiff_tpu.utils.clip_tokenizer']
    assert _violations('def f():\n    import jax\n') == ['jax']
    assert _violations('from .ops import attention') == []
