"""``${...}`` interpolation with custom resolvers (a copy of
``hcpdiff_tpu/config/interp.py`` whose ``hcp.dtype`` gives torch dtypes;
the registry is this module's own, so the JAX package's is untouched).

Covers the reference's resolver surface (hcpdiff/utils/cfg_resolvers.py:1-16):

- ``${path.to.node}``            absolute reference into the config tree
- ``${hcp.eval:"512*512"}``      python-expression eval
- ``${hcp.time:}``               timestamp string (%Y-%m-%d-%H-%M-%S)
- ``${hcp.dtype:fp16}``          dtype object (torch dtypes)
- ``${times:2*3}``               legacy alias of hcp.eval

Plus workflow-engine support for ``${hcp.from_memory:key}`` placeholders,
which must survive resolution untouched until runtime
(reference: hcpdiff/workflow/__init__.py:12-15).
"""
from __future__ import annotations

import re
import time
from typing import Any, Callable, Dict

from .node import Cfg

_RESOLVERS: Dict[str, Callable[..., Any]] = {}


def register_resolver(name: str, fn: Callable[..., Any]) -> None:
    _RESOLVERS[name] = fn


def _hcp_eval(expr: str) -> Any:
    return eval(expr, {'__builtins__': {}}, {'min': min, 'max': max, 'int': int,
                                             'float': float, 'len': len, 'round': round})


def _hcp_time(fmt: str = '%Y-%m-%d-%H-%M-%S') -> str:
    return time.strftime(fmt or '%Y-%m-%d-%H-%M-%S')


def _hcp_dtype(name: str) -> Any:
    import torch
    table = {
        'fp32': torch.float32, 'float32': torch.float32, 'amp': torch.float32,
        'fp16': torch.float16, 'float16': torch.float16,
        'bf16': torch.bfloat16, 'bfloat16': torch.bfloat16,
    }
    return table[str(name)]


register_resolver('hcp.eval', _hcp_eval)
register_resolver('hcp.time', _hcp_time)
register_resolver('hcp.dtype', _hcp_dtype)
register_resolver('times', _hcp_eval)

# markers that must not be resolved at load time (workflow runtime injection)
_DEFERRED_PREFIXES = ('hcp.from_memory',)

_PATTERN = re.compile(r'\$\{([^${}]+)\}')


def _resolve_expr(expr: str, root: Cfg, here: tuple) -> Any:
    expr = expr.strip()
    if ':' in expr and not expr.startswith('.'):
        name, _, arg = expr.partition(':')
        name = name.strip()
        if name in _RESOLVERS:
            arg = arg.strip()
            if arg.startswith(("'", '"')) and arg.endswith(("'", '"')) and len(arg) >= 2:
                arg = arg[1:-1]
            return _RESOLVERS[name](arg) if arg != '' else _RESOLVERS[name]()
        raise KeyError(f'unknown config resolver: {name}')
    if expr.startswith('.'):
        # OmegaConf relative paths: ${.x} = sibling, ${..x} = parent's sibling
        ups = len(expr) - len(expr.lstrip('.'))
        rest = expr.lstrip('.')
        # ${.x} -> container.x ; ${..x} -> container-parent.x ; etc.
        drop = ups - 1
        base = here[:len(here) - drop] if drop <= len(here) else ()
        expr = '.'.join(list(base) + ([rest] if rest else []))
    sentinel = object()
    val = root.get_path(expr, sentinel)
    if val is sentinel:
        raise KeyError(f'interpolation target not found: ${{{expr}}}')
    return val


def _resolve_value(value: Any, root: Cfg, here: tuple = (), depth: int = 0) -> Any:
    if not isinstance(value, str) or '${' not in value:
        return value
    if depth > 20:
        raise RecursionError(f'interpolation too deep: {value!r}')
    if any(p in value for p in _DEFERRED_PREFIXES):
        return value  # resolved at workflow runtime
    m = _PATTERN.fullmatch(value)
    if m:  # whole-string interpolation keeps the native type
        out = _resolve_expr(m.group(1), root, here)
        return _resolve_value(out, root, here, depth + 1)

    def sub(mm: re.Match) -> str:
        return str(_resolve_value('${%s}' % mm.group(1), root, here, depth + 1))

    out = _PATTERN.sub(sub, value)
    return _resolve_value(out, root, here, depth + 1) if '${' in out else out


def resolve(cfg: Cfg) -> Cfg:
    """Eagerly resolve all interpolations in the tree (in place).

    Relative paths are resolved against the *parent container* of the value
    (OmegaConf semantics: ``${.k}`` is a sibling key)."""

    def walk(node: Any, here: tuple) -> Any:
        if isinstance(node, dict):
            for k in list(node.keys()):
                node[k] = walk(node[k], here + (str(k),))
            return node
        if isinstance(node, list):
            for i, v in enumerate(node):
                node[i] = walk(v, here + (str(i),))
            return node
        return _resolve_value(node, cfg, here[:-1])

    return walk(cfg, ())
