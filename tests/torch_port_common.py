"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_port_*.py).

Parameters come from ``jax.eval_shape`` of the flax module's ``init`` (no
init compile) filled by a numpy generator, so both packages read the same
seeded numbers: dense/conv kernels ~ N(0, 1/fan_in), norm scales
1 + N(0, 0.1^2), biases N(0, 0.1^2), embedding tables N(0, 0.02^2).
"""
import math

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for torch while a module's tests run (a module
    imports this fixture to use it). The tiny models gain nothing from
    threads, and under the suite's parallel workers each torch process's
    intra-op threads oversubscribe the cores: a float64 gradcheck of the
    tiny attention took 2 s alone and 153 s so."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(module, *init_args, seed: int = 0, **init_kw):
    """Nested dicts of fp32 numpy arrays shaped like ``module``'s params."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args,
                            **init_kw)['params']
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == 'kernel':
            std = 1.0 / math.sqrt(math.prod(shape[:-1]))
            return (std * rng.standard_normal(shape)).astype(np.float32)
        if name == 'scale':
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == 'bias':
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)
