"""Nothing the benchmark runs imports JAX, its libraries or the JAX
package, compared by whole top-level names; the reference imports nothing
of the program; nothing reads the JAX package's benchmarks."""
import re

from hcpbench.harness import HERE
from hcpbench.nojax import banned, imported

SOURCES = sorted(HERE.rglob('*.py'))


def test_top_level_names_compared_whole():
    assert banned(['hcpdiff_tpu_torch', 'hcpdiff_tpu_torch.ops', 'jaxtyping', 'flaxen']) == []
    assert banned(['hcpdiff_tpu.x', 'jax.numpy', 'jaxlib', 'flax.linen', 'optax']) == \
        ['flax.linen', 'hcpdiff_tpu.x', 'jax.numpy', 'jaxlib', 'optax']


def test_no_source_imports_jax():
    found = {str(p.relative_to(HERE)): banned(imported(p)) for p in SOURCES}
    assert not {k: v for k, v in found.items() if v}


def test_imported_sees_every_form(tmp_path):
    src = tmp_path / 'm.py'
    src.write_text('import jax.numpy as jnp\nfrom flax import linen\nfrom . import x\n'
                   'import importlib\nimportlib.import_module("optax")\n'
                   '__import__("hcpdiff_tpu")\n')
    assert banned(imported(src)) == ['flax', 'hcpdiff_tpu', 'jax.numpy', 'optax']


def test_reference_imports_nothing_of_the_program():
    for p in sorted((HERE / 'reference').glob('*.py')):
        tops = {n.split('.')[0] for n in imported(p)}
        assert tops <= {'__future__', 'math', 're', 'typing', 'numpy', 'torch'}, (p, tops)


def test_nothing_reads_the_jax_benchmarks():
    pattern = re.compile(r'bench(_train)?\.py|tools_dev|BENCH_')
    for p in SOURCES + sorted(HERE.rglob('*.json')):
        if p.name != 'test_hcpbench_nojax.py':
            assert not pattern.search(p.read_text()), p
