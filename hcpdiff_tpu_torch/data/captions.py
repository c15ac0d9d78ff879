"""Caption loaders: JSON / YAML / per-image TXT with auto-detect (a copy of
``hcpdiff_tpu/data/captions.py`` that reads YAML with ``config/yaml_lite``)."""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

from ..config import yaml_lite


def _clean_keys(d: Dict[str, str]) -> Dict[str, str]:
    """Strip image extensions from keys so captions match stems."""
    out = {}
    for k, v in d.items():
        stem = os.path.splitext(k)[0]
        out[stem] = v
    return out


class BaseCaptionLoader:
    def __init__(self, path: str):
        self.path = path

    def load(self) -> Dict[str, str]:
        raise NotImplementedError

    def __call__(self) -> Dict[str, str]:
        return _clean_keys(self.load())


class JsonCaptionLoader(BaseCaptionLoader):
    def load(self):
        with open(self.path, encoding='utf-8') as f:
            return json.load(f)


class YamlCaptionLoader(BaseCaptionLoader):
    def load(self):
        return yaml_lite.load(self.path) or {}


class TXTCaptionLoader(BaseCaptionLoader):
    """Directory of per-image ``<stem>.txt`` caption files."""

    def load(self):
        out = {}
        for p in glob.glob(os.path.join(self.path, '*.txt')):
            with open(p, encoding='utf-8') as f:
                out[os.path.basename(p)] = f.read().strip()
        return out


def auto_caption_loader(path: str) -> Optional[BaseCaptionLoader]:
    """Detect caption format from a path (file ext or directory with txt)."""
    if path is None:
        return None
    if os.path.isdir(path):
        js = glob.glob(os.path.join(path, '*.json'))
        ym = glob.glob(os.path.join(path, '*.yaml')) + glob.glob(os.path.join(path, '*.yml'))
        tx = glob.glob(os.path.join(path, '*.txt'))
        if js:
            return JsonCaptionLoader(js[0])
        if ym:
            return YamlCaptionLoader(ym[0])
        if tx:
            return TXTCaptionLoader(path)
        return None
    ext = os.path.splitext(path)[1].lower()
    if ext == '.json':
        return JsonCaptionLoader(path)
    if ext in ('.yaml', '.yml'):
        return YamlCaptionLoader(path)
    if ext == '.txt' or os.path.isdir(path):
        return TXTCaptionLoader(os.path.dirname(path) or path)
    raise ValueError(f'unknown caption format: {path}')
