"""Config loading: yaml + ``_base_`` inheritance + CLI overrides (a copy of
``hcpdiff_tpu/config/loader.py`` that reads and writes YAML with
``yaml_lite``, since the port runs without PyYAML).

Semantics mirror the reference loader (hcpdiff/utils/utils.py:43-72):

1. read the file (``yaml_lite``: PyYAML's safe rules, YAML 1.2 floats)
2. if it has ``_base_: [paths...]`` — load each base recursively (relative to
   the current file, falling back to CWD and the shipped ``cfgs/`` tree),
   merge them left-to-right, then merge the current file on top
3. drop keys whose value is the ``'---'`` deletion sentinel
4. apply CLI ``key=value`` dotlist overrides
5. resolve ``${...}`` interpolations
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

from . import yaml_lite
from .node import Cfg, apply_dotlist, containerize, merge, remove_deleted, to_plain
from .interp import resolve

# package-shipped config root (repo_root/cfgs)
_PKG_CFG_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), '..', '..', 'cfgs'))


def _find(path: str, rel_to: Optional[str]) -> str:
    cands = []
    if os.path.isabs(path):
        cands = [path]
    else:
        if rel_to:
            cands.append(os.path.join(rel_to, path))
        cands.append(path)
        cands.append(os.path.join(_PKG_CFG_ROOT, path))
        # allow bases written as 'cfgs/...' from anywhere
        if path.startswith('cfgs/'):
            cands.append(os.path.join(os.path.dirname(_PKG_CFG_ROOT), path))
    for c in cands:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(f'config file not found: {path} (tried {cands})')


def load_yaml(path: str, rel_to: Optional[str] = None) -> Cfg:
    path = _find(path, rel_to)
    data = yaml_lite.load(path) or {}
    if not isinstance(data, dict):
        raise TypeError(f'top-level config must be a mapping: {path}')
    return containerize(data), path


def save_config(cfg: Cfg, path: str) -> None:
    yaml_lite.dump(to_plain(cfg), path)


def _load_config_rel(path: str, rel_to: Optional[str], remove_undefined: bool = True) -> Cfg:
    cfg, real = load_yaml(path, rel_to)
    bases = cfg.pop('_base_', None)
    if bases:
        if isinstance(bases, str):
            bases = [bases]
        merged: Cfg = Cfg()
        here = os.path.dirname(real)
        for b in bases:
            merged = merge(merged, _load_config_rel(str(b), here, remove_undefined=False))
        cfg = merge(merged, cfg)
    if remove_undefined:
        cfg = remove_deleted(cfg)
    return cfg


def load(path: str, cli_overrides: Optional[Iterable[str]] = None) -> Cfg:
    cfg = _load_config_rel(path, None)
    if cli_overrides:
        cfg = apply_dotlist(cfg, list(cli_overrides))
        cfg = remove_deleted(cfg)
    return resolve(cfg)
