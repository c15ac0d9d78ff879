"""``_target_`` object instantiation (hydra.utils.instantiate parity; a
copy of ``hcpdiff_tpu/config/instantiate.py`` for the port).

The reference drives *everything* through hydra instantiation
(hcpdiff/train_ac.py:55, hcpdiff/visualizer.py:26): any config node with a
``_target_`` key becomes a live object; ``_partial_: True`` defers call args
via functools.partial (datasets, optimizers).

Extra over hydra: a short-name registry so shipped configs can reference
framework classes without long import paths. The shipped configs name the
JAX package's classes (``hcpdiff_tpu.infer.interfaces.DiskInterface``):
a leading ``hcpdiff_tpu.`` is rewritten to ``hcpdiff_tpu_torch.``, and a
target that does not exist there raises rather than importing the JAX
package. The reference's own paths (``hcpdiff.data.TextImagePairDataset``)
are read in ``hcpdiff_tpu_torch/compat.py``, as the JAX package reads them
in its ``compat``. JAX itself is never imported through a config string.
"""
from __future__ import annotations

import functools
import importlib
from typing import Any, Callable, Dict

from .node import Cfg

_REGISTRY: Dict[str, Any] = {}

# the JAX package's module paths and the reference's -> the port's
_PREFIXES = (('hcpdiff_tpu.', 'hcpdiff_tpu_torch.'), ('hcpdiff.', 'hcpdiff_tpu_torch.compat.'))
# top-level packages a config string may not import
_REFUSED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax')


def register(name: str, obj: Any = None):
    """Register an object under a short target name. Usable as decorator."""
    if obj is None:
        def deco(o):
            _REGISTRY[name] = o
            return o
        return deco
    _REGISTRY[name] = obj
    return obj


def locate(path: str) -> Any:
    """Import ``pkg.mod.Class`` (or registry short name) and return the object."""
    if path in _REGISTRY:
        return _REGISTRY[path]
    for old, new in _PREFIXES:
        if path.startswith(old):
            path = new + path[len(old):]
            break
    if path.split('.')[0] in _REFUSED:
        raise ImportError(f'the PyTorch port does not import {path!r}')
    parts = path.split('.')
    for i in range(len(parts) - 1, 0, -1):
        mod_name = '.'.join(parts[:i])
        try:
            mod = importlib.import_module(mod_name)
        except ImportError:
            continue
        obj = mod
        try:
            for attr in parts[i:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    raise ImportError(f'cannot locate target: {path}')


def instantiate(node: Any, **kwargs: Any) -> Any:
    """Recursively build objects from a config tree.

    - dict with ``_target_`` -> call target(**children) (children instantiated
      first); ``_partial_: True`` -> functools.partial(target, **children);
      ``_args_: [...]`` -> positional args.
    - other dicts/lists -> recurse.
    """
    if isinstance(node, dict):
        if '_target_' in node:
            spec = dict(node)
            target = locate(str(spec.pop('_target_')))
            partial = bool(spec.pop('_partial_', False))
            pos = [instantiate(a) for a in spec.pop('_args_', [])]
            built = {k: instantiate(v) for k, v in spec.items()}
            built.update(kwargs)
            if partial:
                return functools.partial(target, *pos, **built)
            return target(*pos, **built)
        return Cfg({k: instantiate(v) for k, v in node.items()})
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node
