"""Checkpoint managers (counterpart of ``hcpdiff_tpu/ckpt/manager.py``).

Two interchange backends with the JAX package's ckpt layout ``{base,
base_ema, lora, lora_ema}``, whose files each package loads:

- ``CkptManagerSafe``: safetensors with ':'-folded keys;
- ``CkptManagerPKL``: a torch-pickled flat dict (``.ckpt``).

``base`` is a fine-tuned subset saved in the JAX tree's names and layouts
(``base:down_0_res_0:conv1:kernel``, HWIO), ``lora`` the ``.___.`` LoRA
state through the alias map; ``auto_manager`` picks the backend by the
file's extension. ``CkptManagerDiffusers.save_pipeline`` writes whole
modules as a diffusers-layout directory. In place of the JAX package's
``OrbaxCkptManager`` (the port reads and writes no orbax directory),
``StateManager`` keeps the trainer's full state for ``resume.auto``.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn as nn

from . import safetensors_io
from .bridge import params_from_state_dict, state_dict_from_params
from .diffusers_layout import write_module
from .formats import (fold_dict, lora_overlay_to_state, lora_state_to_overlay,
                      save_webui_embedding, unfold_dict)


def conv_shapes(module: nn.Module, overlay: Mapping[str, Any]) -> Dict[str, tuple]:
    """{path: conv weight shape} for the overlaid paths that are convs."""
    out = {}
    for path in overlay:
        shape = tuple(module.get_submodule(path).weight.shape)
        if len(shape) == 4:
            out[path] = shape
    return out


class CkptManagerBase:
    ext = '.safetensors'

    def __init__(self, ckpt_dir: Optional[str] = None, **kw):
        self.ckpt_dir = ckpt_dir

    def set_save_dir(self, d: str):
        self.ckpt_dir = d
        os.makedirs(d, exist_ok=True)

    def _write(self, flat: Dict[str, torch.Tensor], path: str):
        raise NotImplementedError

    def _read(self, path: str) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def save_model_with_lora(self, path: str, module: nn.Module,
                             base: Optional[Mapping[str, torch.Tensor]] = None,
                             lora_overlay: Optional[Mapping[str, Any]] = None,
                             base_ema: Optional[Mapping[str, torch.Tensor]] = None,
                             lora_ema: Optional[Mapping[str, Any]] = None,
                             aliases: Optional[Dict[str, str]] = None) -> None:
        """``base``/``base_ema``: {port name: tensor} subsets of ``module``'s
        weights; ``lora_overlay``/``lora_ema``: the port's overlays on it;
        ``aliases`` ({path: diffusers module path}) names the LoRA keys."""
        ckpt: Dict[str, Any] = {}
        for key, part in (('base', base), ('base_ema', base_ema)):
            if part:
                ckpt[key] = params_from_state_dict(part, module)
        for key, part in (('lora', lora_overlay), ('lora_ema', lora_ema)):
            if part:
                ckpt[key] = lora_overlay_to_state(part, aliases, conv_shapes(module, part))
        self._write({k: v.float() for k, v in unfold_dict(ckpt).items()}, path)

    def load_ckpt(self, path: str, aliases: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        """-> {'base'/'base_ema': {port name: tensor}, 'lora'/'lora_ema':
        the port's overlays}, from a file either package wrote."""
        nested = fold_dict(self._read(path))
        out: Dict[str, Any] = {}
        for k in ('base', 'base_ema'):
            if k in nested:
                out[k] = state_dict_from_params(nested[k])
        for k in ('lora', 'lora_ema'):
            if k in nested:
                flat = {kk.replace(':', '.'): v for kk, v in unfold_dict(nested[k]).items()}
                out[k] = lora_state_to_overlay(flat, aliases=aliases)
        return out

    def save_embedding(self, path: str, vectors, name: str, step: Optional[int] = None) -> None:
        save_webui_embedding(path, vectors, name, step)


class CkptManagerSafe(CkptManagerBase):
    ext = '.safetensors'

    def _write(self, flat, path):
        safetensors_io.save_file(flat, path)

    def _read(self, path):
        return safetensors_io.load_file(path)


class CkptManagerPKL(CkptManagerBase):
    """A torch-pickled flat {key: tensor} (``.ckpt``)."""
    ext = '.ckpt'

    def _write(self, flat, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save(dict(flat), path)

    def _read(self, path):
        return torch.load(path, map_location='cpu', weights_only=True)


class CkptManagerDiffusers(CkptManagerSafe):
    """A model as a diffusers-layout directory (``unet/``, ``vae/``,
    ``text_encoder/``[, ``text_encoder_2/``][, ``tokenizer/``]), which
    ``models/factory.py:build_models`` and the JAX package's load."""

    def save_pipeline(self, out_dir: str, unet: nn.Module, vae: Optional[nn.Module] = None,
                      te: Optional[nn.Module] = None, te2: Optional[nn.Module] = None,
                      tokenizer=None, states: Optional[Mapping[str, Mapping]] = None) -> None:
        """Each module's weights in the dtype they are held in; ``states``
        ({'unet'/'vae'/'te'/'te2': {name: tensor}}) replaces some of them,
        e.g. merged weights kept beside a module."""
        states = states or {}
        for sub, key, module in (('unet', 'unet', unet), ('vae', 'vae', vae),
                                 ('text_encoder', 'te', te), ('text_encoder_2', 'te2', te2)):
            if module is not None:
                write_module(module, os.path.join(out_dir, sub), state=states.get(key))
        if tokenizer is not None:
            tokenizer.save_pretrained(os.path.join(out_dir, 'tokenizer'))


def auto_manager(path_or_ext: str) -> CkptManagerBase:
    """The manager a file's extension names: safetensors, else the pickle."""
    ext = os.path.splitext(path_or_ext)[1] or path_or_ext
    return CkptManagerSafe() if 'safetensors' in ext else CkptManagerPKL()


class StateManager:
    """The trainer's full state (pack, optimizer, EMA, step, generator,
    data position) as ``state_<step>.pt`` under ``directory``: written to
    a temporary name and renamed, the newest ``max_to_keep`` kept."""

    _NAME = re.compile(r'^state_(\d+)\.pt$')

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def steps(self):
        return sorted(int(m.group(1)) for m in map(self._NAME.match, os.listdir(self.dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f'state_{step}.pt')

    def save(self, step: int, state: Dict[str, Any]) -> None:
        tmp = self._path(step) + '.tmp'
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = self.latest_step() if step is None else step
        return torch.load(self._path(step), map_location='cpu', weights_only=True)
