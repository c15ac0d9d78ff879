"""Config tree node types (a copy of ``hcpdiff_tpu/config/node.py``; the
port imports nothing of the JAX package).

A minimal, dependency-free stand-in for OmegaConf's DictConfig/ListConfig,
covering exactly the feature set HCP-Diffusion relies on
(reference: hcpdiff/utils/utils.py:43-72, hcpdiff/utils/cfg_resolvers.py:1-16):

- attribute AND item access (``cfg.train.loss`` / ``cfg['train']['loss']``)
- recursive merge with override semantics
- the ``'---'`` deletion sentinel (a key whose merged value is '---' is removed)
- ``${path.to.key}`` interpolation + ``${resolver:args}`` custom resolvers
- dotlist overrides (``a.b.c=value``) for CLI parity

We intentionally keep nodes as thin subclasses of dict/list so that yaml dump,
json, and plain-python consumers work unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

from .yaml_lite import YAMLError, loads

DELETE_SENTINEL = '---'


class Cfg(dict):
    """dict with attribute access. Missing attribute -> AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split('.'):
            if isinstance(node, dict) and part in node:
                node = node[part]
            elif isinstance(node, (list, tuple)) and part.lstrip('-').isdigit():
                idx = int(part)
                if -len(node) <= idx < len(node):
                    node = node[idx]
                else:
                    return default
            else:
                return default
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split('.')
        node: Any = self
        for part in parts[:-1]:
            if isinstance(node, list):
                node = node[int(part)]
            else:
                if part not in node or not isinstance(node[part], (dict, list)):
                    node[part] = Cfg()
                node = node[part]
        if isinstance(node, list):
            node[int(parts[-1])] = value
        else:
            node[parts[-1]] = value


def containerize(obj: Any) -> Any:
    """Recursively convert plain dicts/lists into Cfg/list trees."""
    if isinstance(obj, dict):
        return Cfg({k: containerize(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return [containerize(v) for v in obj]
    return obj


def to_plain(obj: Any) -> Any:
    """Convert a Cfg tree back to plain dict/list (for yaml dump)."""
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    return obj


def merge(base: Any, override: Any) -> Any:
    """Recursive override merge (OmegaConf.merge semantics subset).

    dict+dict merge per-key; everything else: override wins. The deletion
    sentinel is handled in a post-pass (remove_deleted) so that
    ``key: '---'`` in an override removes the key from the merged tree
    (reference: hcpdiff/utils/utils.py:46-55 remove_config_undefined).
    """
    if isinstance(base, dict) and isinstance(override, dict):
        out = Cfg(base)
        for k, v in override.items():
            if k in out:
                out[k] = merge(out[k], v)
            else:
                out[k] = v
        return out
    return override


def remove_deleted(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Cfg({k: remove_deleted(v) for k, v in obj.items() if not _is_del(v)})
    if isinstance(obj, list):
        return [remove_deleted(v) for v in obj if not _is_del(v)]
    return obj


def _is_del(v: Any) -> bool:
    return isinstance(v, str) and v == DELETE_SENTINEL


def _parse_scalar(text: str) -> Any:
    """Parse a CLI override value with yaml scalar rules (1.2 floats); a
    value that is not YAML stays the text."""
    try:
        return loads(text)
    except YAMLError:
        return text


def apply_dotlist(cfg: Cfg, dotlist: Iterable[str]) -> Cfg:
    """Apply ``a.b=v`` CLI overrides (OmegaConf.from_dotlist parity)."""
    for item in dotlist:
        if '=' not in item:
            raise ValueError(f"override '{item}' is not of the form key=value")
        key, _, raw = item.partition('=')
        cfg.set_path(key.strip(), containerize(_parse_scalar(raw)))
    return cfg
