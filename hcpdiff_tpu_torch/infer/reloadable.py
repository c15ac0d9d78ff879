"""``VisualizerReloadable``: a resident Visualizer whose config changes
between requests (counterpart of ``hcpdiff_tpu/infer/reloadable.py``).

``check_reload`` compares the new config with the one it runs:

- another ``pretrained_model`` rebuilds everything, after the old models
  are freed, so two UNets are never held at once;
- another ``merge`` block or ``emb_dir`` merges again from the kept fp32
  base (``Visualizer.base``): the same module objects, no directory read,
  DreamArtist's negative branch and the embedding rows rebuilt with it;
- ``infer_args``, ``interface`` and the text frontend's
  ``tokenizer_repeats``/``clip_skip``/``clip_final_norm`` change in place.
"""
from __future__ import annotations

from typing import Any

import torch

from ..config import Cfg, to_plain
from ..config.legacy import InferCFGConverter
from .visualizer import Visualizer, _unported

FRONTEND_KNOBS = {'tokenizer_repeats': 'n_repeats', 'clip_skip': 'clip_skip',
                  'clip_final_norm': 'clip_final_norm'}


class VisualizerReloadable(Visualizer):
    def __init__(self, cfgs: Cfg):
        super().__init__(cfgs)
        self._cfg_snapshot = to_plain(self.cfgs)

    def _free(self) -> None:
        """Drop the models (and the base), so a rebuild's peak holds one set."""
        self.world = self.base = self.pipe = self.frontend = None
        self.unet_params_neg = self.emb_ext = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def check_reload(self, new_cfgs: Cfg) -> bool:
        """Apply the parts of ``new_cfgs`` that differ; True if the models
        were rebuilt."""
        new_cfgs = InferCFGConverter().convert(new_cfgs)
        old, new = self._cfg_snapshot, to_plain(new_cfgs)
        if old.get('pretrained_model') != new.get('pretrained_model'):
            self._free()
            self.__init__(new_cfgs)
            return True
        if old.get('merge') != new.get('merge') or old.get('emb_dir') != new.get('emb_dir'):
            self.cfgs = new_cfgs
            self._build_merged()
        self.cfgs['infer_args'] = new_cfgs.get('infer_args')
        if old.get('interface') != new.get('interface'):
            self.cfgs['interface'] = new_cfgs.get('interface')
            self._build_interfaces()
        mold, mnew = old.get('model') or {}, new.get('model') or {}
        for key, attr in FRONTEND_KNOBS.items():
            if mold.get(key) != mnew.get(key):
                if self.sdxl:
                    raise _unported(f'changing model.{key} of the SDXL text frontend')
                setattr(self.frontend, attr, _knob(key, mnew.get(key)))
        self.cfgs['model'] = new_cfgs.get('model')
        self._cfg_snapshot = new
        return False


def _knob(key: str, value: Any):
    """A knob's value as the Visualizer reads it (its default when unset)."""
    if key == 'clip_final_norm':
        return True if value is None else bool(value)
    return int({'tokenizer_repeats': 1, 'clip_skip': 0}[key] if value is None else value)
