"""Caption/text augmentations (a copy of ``hcpdiff_tpu/data/transforms.py``).

All transforms are deterministic functions of an explicit ``rng``
(numpy Generator) so dataset iteration stays reproducible per epoch/seed, and both
packages draw the same augmentations from the same seeds.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Union

import numpy as np


class TagShuffle:
    def __call__(self, text: str, rng: np.random.Generator) -> str:
        if text is None:
            return text
        tags = [t.strip() for t in text.split(',')]
        rng.shuffle(tags)
        return ', '.join(tags)


class TagDropout:
    def __init__(self, p: float = 0.1):
        self.p = p

    def __call__(self, text: str, rng: np.random.Generator) -> str:
        if text is None:
            return text
        tags = [t.strip() for t in text.split(',')]
        kept = [t for t in tags if rng.random() >= self.p]
        if not kept and tags:
            kept = [tags[int(rng.integers(len(tags)))]]
        return ', '.join(kept)


class TagErase:
    """With probability p drop the whole caption (classifier-free style)."""

    def __init__(self, p: float = 0.05):
        self.p = p

    def __call__(self, text: str, rng: np.random.Generator) -> str:
        return '' if rng.random() < self.p else text


class TemplateFill:
    """Fill ``{caption}`` / ``{pt1}``-style slots in prompt templates.

    ``word_names``: slot -> replacement (e.g. {'pt1': 'my-embedding'}).
    DreamArtist mode: a slot value may be a (neg, pos) pair; fill then
    returns the [neg, pos] prompt pair (reference caption_tools.py:63-105).
    """

    def __init__(self, word_names: Optional[Dict[str, Union[str, tuple, list]]] = None):
        self.word_names = dict(word_names or {})
        self.da_mode = any(isinstance(v, (tuple, list))
                           for v in self.word_names.values())

    def _fill(self, template: str, caption: Optional[str], branch: int = -1) -> str:
        vals = {}
        for k, v in self.word_names.items():
            if isinstance(v, (tuple, list)):
                vals[k] = v[branch] if branch >= 0 else v[-1]
            else:
                vals[k] = v
        vals.setdefault('caption', caption or '')

        def sub(m):
            key = m.group(1)
            if key in vals:
                return str(vals[key])
            return m.group(0)

        out = re.sub(r'\{([a-zA-Z0-9_]+)\}', sub, template)
        if caption and '{caption}' not in template:
            out = f'{out}, {caption}' if out else caption
        return out.strip().strip(',').strip()

    def __call__(self, template: str, caption: Optional[str] = None,
                 rng: Optional[np.random.Generator] = None):
        if self.da_mode:
            return [self._fill(template, caption, 0),
                    self._fill(template, caption, 1)]
        return self._fill(template, caption)


class Compose:
    def __init__(self, transforms: List):
        self.transforms = list(transforms)

    def __call__(self, text, rng):
        for t in self.transforms:
            text = t(text, rng)
        return text
