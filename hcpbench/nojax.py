"""The benchmark runs the PyTorch port alone: no module of JAX, its
libraries or the JAX package may be loaded. Names are compared by their
top-level part (before the first dot) as a whole word, since the port's
package name begins with the JAX package's.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

BANNED = frozenset({'jax', 'jaxlib', 'flax', 'optax', 'hcpdiff_tpu'})


def top(name: str) -> str:
    return name.split('.', 1)[0]


def banned(names: Iterable[str]) -> List[str]:
    """The names whose top-level package is banned, sorted."""
    return sorted({n for n in names if top(n) in BANNED})


def loaded() -> List[str]:
    """Banned modules in this process's ``sys.modules``."""
    return banned(list(sys.modules))


def imported(path: Path) -> List[str]:
    """Every absolute module name a Python file imports: ``import`` and
    ``from ... import`` statements, and ``importlib.import_module`` or
    ``__import__`` calls with a literal name."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names: List[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Attribute) and node.func.attr == 'import_module')
                   or (isinstance(node.func, ast.Name) and node.func.id == '__import__'))):
            names.append(node.args[0].value)
    return names
