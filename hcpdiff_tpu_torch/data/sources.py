"""Data sources (counterpart of ``hcpdiff_tpu/data/sources.py``).

A source yields (image_path, caption, per-item metadata); datasets combine
sources with buckets. Images load as uint8 RGB arrays through
``data/utils.py:load_rgb`` (PNG, JPEG, GIF and BMP, as Pillow opens them;
WebP other than the port's own, TIFF and ICO raise, naming the file),
transparent pixels over ``bg_color`` as the JAX package composites them.
``Text2ImageCondSource`` adds ControlNet's condition images from a folder
beside the images.
"""
from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .captions import auto_caption_loader
from .img_size import get_image_size, types_support
from .transforms import TemplateFill
from .utils import load_gray, load_rgb


def _list_images(root: str) -> List[str]:
    out = []
    for ext in types_support:
        out.extend(glob.glob(os.path.join(root, f'*.{ext}')))
        out.extend(glob.glob(os.path.join(root, f'*.{ext.upper()}')))
    return sorted(set(out))


class DataSource:
    """Base source (reference source/base.py:4): image root + repeat."""

    def __init__(self, img_root: str, repeat: int = 1,
                 bg_color=(255, 255, 255), **kw):
        self.img_root = img_root
        self.repeat = int(repeat)
        self.bg_color = tuple(bg_color) if bg_color is not None else (255, 255, 255)

    def get_image_list(self) -> List[Tuple[str, Dict[str, Any]]]:
        """-> [(path, meta)], repeated ``repeat`` times."""
        raise NotImplementedError

    def load_image(self, path: str) -> np.ndarray:
        return load_rgb(path, self.bg_color)

    def get_caption(self, path: str) -> Optional[str]:
        return None

    def size_of(self, path: str) -> Tuple[int, int]:
        return get_image_size(path)


class ComposeDataSource(DataSource):
    """Concatenate several sources (reference source/base.py:22)."""

    def __init__(self, source_dict: Dict[str, DataSource] | Sequence[DataSource], **kw):
        self.sources = (list(source_dict.values()) if isinstance(source_dict, dict)
                        else list(source_dict))

    def get_image_list(self):
        out = []
        for s in self.sources:
            for path, meta in s.get_image_list():
                meta = dict(meta)
                meta['source'] = s
                out.append((path, meta))
        return out


class Text2ImageSource(DataSource):
    """Images + captions + prompt template (reference source/text2img.py:18)."""

    def __init__(self, img_root: str, caption_file: Optional[str] = None,
                 prompt_template: Optional[str] = None, repeat: int = 1,
                 word_names: Optional[dict] = None, text_transforms=None,
                 bg_color=(255, 255, 255), **kw):
        super().__init__(img_root, repeat, bg_color=bg_color)
        loader = (caption_file if callable(caption_file)
                  else auto_caption_loader(caption_file) if caption_file else None)
        self.captions = loader() if loader else {}
        self.templates = self._load_templates(prompt_template)
        self.template_fill = TemplateFill(word_names)
        self.text_transforms = text_transforms

    @staticmethod
    def _load_templates(path: Optional[str]) -> List[str]:
        if not path:
            return ['{caption}']
        if os.path.isfile(path):
            with open(path, encoding='utf-8') as f:
                lines = [l.strip() for l in f if l.strip()]
            return lines or ['{caption}']
        return [path]

    def get_image_list(self):
        files = _list_images(self.img_root)
        out = []
        for p in files:
            meta = {'source': self}
            out.append((p, meta))
        return out * self.repeat

    def get_caption(self, path: str) -> Optional[str]:
        stem = os.path.splitext(os.path.basename(path))[0]
        return self.captions.get(stem)

    def make_prompt(self, path: str, rng: np.random.Generator):
        caption = self.get_caption(path)
        if self.text_transforms is not None and caption is not None:
            caption = self.text_transforms(caption, rng)
        template = self.templates[int(rng.integers(len(self.templates)))]
        return self.template_fill(template, caption)


class Text2ImageAttMapSource(Text2ImageSource):
    """Adds per-image attention-weight maps: grayscale masks where
    0-127 -> [0,1] down-weight, 128-255 -> [1,5] up-weight
    (reference source/text2img.py:66-91)."""

    def __init__(self, img_root: str, att_map_root: Optional[str] = None, **kw):
        super().__init__(img_root, **kw)
        self.att_map_root = att_map_root

    def get_att_map(self, path: str) -> Optional[np.ndarray]:
        if not self.att_map_root:
            return None
        stem = os.path.splitext(os.path.basename(path))[0]
        for ext in types_support:
            p = os.path.join(self.att_map_root, f'{stem}.{ext}')
            if os.path.exists(p):
                return load_gray(p)
        return None

    @staticmethod
    def att_map_to_weight(arr: np.ndarray) -> np.ndarray:
        arr = arr.astype(np.float32)
        lo = arr / 127.0
        hi = 1.0 + (arr - 128.0) / 127.0 * 4.0
        return np.where(arr < 128, lo, hi)


class T2IFolderClassSource(Text2ImageSource):
    """DreamBooth class folders: subfolder name carries (repeat, class word)
    like ``3_dog`` (reference source/folder_class.py:9)."""

    def get_image_list(self):
        out = []
        for sub in sorted(os.listdir(self.img_root)):
            d = os.path.join(self.img_root, sub)
            if not os.path.isdir(d):
                continue
            if '_' in sub and sub.split('_', 1)[0].isdigit():
                rep, cls_word = sub.split('_', 1)
                rep = int(rep)
            else:
                rep, cls_word = 1, sub
            files = _list_images(d)
            for p in files:
                out.append((p, {'source': self, 'class_word': cls_word.replace('_', ' ')}))
            out.extend([(p, {'source': self,
                             'class_word': cls_word.replace('_', ' ')})
                        for p in files] * (rep - 1))
        return out * self.repeat

    def make_prompt(self, path: str, rng: np.random.Generator,
                    class_word: Optional[str] = None):
        caption = self.get_caption(path) or class_word
        template = self.templates[int(rng.integers(len(self.templates)))]
        return self.template_fill(template, caption)


class Text2ImageCondSource(Text2ImageSource):
    """Adds ControlNet condition images from a parallel folder: the file of
    the image's stem under ``cond_root`` (reference
    source/text2img_cond.py:9)."""

    def __init__(self, img_root: str, cond_root: str, **kw):
        super().__init__(img_root, **kw)
        self.cond_root = cond_root

    def get_cond_image(self, path: str) -> np.ndarray:
        """uint8 RGB, the alpha dropped (Pillow's ``convert('RGB')``, as the
        JAX package reads it)."""
        stem = os.path.splitext(os.path.basename(path))[0]
        for ext in types_support:
            p = os.path.join(self.cond_root, f'{stem}.{ext}')
            if os.path.exists(p):
                return load_rgb(p, bg_color=None)
        raise FileNotFoundError(f'no cond image for {path}')
