"""The port's grouped frozen-base cast (``utils/casting.py``) against the JAX
package's ``cast_tree_bf16`` and ``.to(torch.bfloat16)``, and the freeing
it exists for: each group's fp32 tensors are gone before the next group is
cast."""
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from hcpdiff_tpu.utils.casting import cast_tree_bf16 as jax_cast
from hcpdiff_tpu_torch.utils.casting import cast_tree_bf16
from tests.torch_port_common import one_torch_thread  # noqa: F401

MIB = 1 << 20


def _tree(seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32))
    return {'unet': {'a.weight': t(64, 32), 'b.weight': t(300), 'steps': torch.arange(5)},
            'te': {'c.weight': t(7, 9), 'd.bias': t(9).double(), 'name': 'clip'},
            'list': [t(4, 4), t(1)]}


def test_every_fp32_tensor_becomes_its_bf16_rounding():
    tree, ref = _tree(), _tree()
    same = {id(tree['unet']['steps']), id(tree['te']['d.bias'])}
    out = cast_tree_bf16(tree, group_bytes=1024)
    assert out is tree
    jax_out = jax_cast({'unet': {'a': jnp.asarray(ref['unet']['a.weight'].numpy())}},
                       group_bytes=1024)['unet']['a']
    for got, want in ((out['unet']['a.weight'], ref['unet']['a.weight']),
                      (out['unet']['b.weight'], ref['unet']['b.weight']),
                      (out['te']['c.weight'], ref['te']['c.weight']),
                      (out['list'][0], ref['list'][0]), (out['list'][1], ref['list'][1])):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    np.testing.assert_array_equal(out['unet']['a.weight'].float().numpy(),
                                  np.asarray(jax_out.astype(jnp.float32)))
    # other dtypes and non-tensor leaves pass through untouched
    assert {id(out['unet']['steps']), id(out['te']['d.bias'])} == same
    assert out['te']['name'] == 'clip'


class _Watch(TorchFunctionMode):
    """At each ``Tensor.to``, which of the watched fp32 tensors are alive."""

    def __init__(self, refs):
        super().__init__()
        self.refs, self.alive = refs, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.to:
            self.alive.append([r() is not None for r in self.refs])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('group_mib,per_group', [(2, 2), (3, 3), (1, 1)])
def test_each_group_is_freed_before_the_next(group_mib, per_group):
    """Six 1 MiB fp32 tensors, groups closing at ``group_mib`` MiB: when a
    tensor is cast, the tensors of every earlier group are freed and those
    of its own and later groups are alive."""
    tree = {f'w{i}': torch.full((MIB // 4,), float(i)) for i in range(6)}
    refs = [weakref.ref(t) for t in tree.values()]
    watch = _Watch(refs)
    with watch:
        cast_tree_bf16(tree, group_bytes=group_mib * MIB)
    assert len(watch.alive) == 6
    for i, alive in enumerate(watch.alive):
        first = i // per_group * per_group      # the first tensor of i's group
        assert alive == [j >= first for j in range(6)], (i, alive)
    assert all(r() is None for r in refs)
    assert all(t.dtype == torch.bfloat16 and float(t[0]) == i for i, t in enumerate(tree.values()))
