"""Weights bridge: the JAX package's param trees -> the port's state dicts.

The port names its modules after the JAX tree's paths, so a param tree
(nested dicts of numpy arrays, as ``jax.device_get(params)`` gives them)
becomes a state dict by joining the path with dots and converting each leaf:

- conv ``kernel`` HWIO -> ``weight`` OIHW;
- dense ``kernel`` [in, out] -> ``weight`` [out, in] (the GEGLU ``proj``
  keeps its [value | gate] halves, which become row halves);
- norm ``scale`` -> ``weight``; ``bias`` and embedding tables as they are.

One function serves the UNet, the VAE and CLIP; ``load_params`` loads the
result strictly, so a missing or unexpected name raises.
``lora_overlay_from_params`` turns a JAX LoRA overlay into the port's, and
``params_from_state_dict`` a (subset of a) state dict back into the JAX
tree's names and layouts, as the trainer saves a fine-tuned subset.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def _leaf(name: str, value: np.ndarray):
    if name == 'kernel':
        if value.ndim == 4:
            return 'weight', value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return 'weight', value.T
        raise ValueError(f'unexpected {value.ndim}-d kernel')
    if name == 'scale':
        return 'weight', value
    return name, value


def state_dict_from_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten and convert a JAX param tree into a torch state dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f'{prefix}{key}.')
            else:
                name, arr = _leaf(key, np.asarray(value, dtype=np.float32))
                out[prefix + name] = torch.from_numpy(np.array(arr, order='C'))

    walk(params, '')
    return out


def params_from_state_dict(state: Mapping[str, torch.Tensor], module: nn.Module) -> Dict:
    """{port name: tensor} -> the JAX param tree ({path part: ... {leaf:
    tensor}}): a Linear/Conv2d ``weight`` becomes ``kernel`` ([in, out],
    HWIO), a norm's ``weight`` ``scale``; other names are kept."""
    out: Dict = {}
    for name, value in state.items():
        path, leaf = name.rpartition('.')[::2]
        value = value.detach()
        if leaf == 'weight':
            owner = module.get_submodule(path)
            if isinstance(owner, (nn.Linear, nn.Conv2d)):
                leaf, value = 'kernel', (value.permute(2, 3, 1, 0) if value.dim() == 4
                                         else value.t())
            else:
                leaf = 'scale'
        node = out
        for part in path.split('.') if path else []:
            node = node.setdefault(part, {})
        node[leaf] = value.contiguous()
    return out


def lora_overlay_from_params(overlay: Mapping, module: nn.Module) -> Dict[str, Dict]:
    """A JAX LoRA overlay ``{path: {down [fan_in, r], up [r, out], alpha}}``
    (numpy) -> the port's ``{path: {down [r, fan_in], up [out, r], alpha}}``
    (fp32 tensors; see ``adapt/overlay.py``). ``module`` gives the target
    weights' shapes: a conv's fan_in is (kh, kw, cin) in the JAX kernel and
    (cin, kh, kw) in the port's."""
    out: Dict[str, Dict] = {}
    for path, entry in overlay.items():
        down = np.asarray(entry['down'], dtype=np.float32)
        up = np.asarray(entry['up'], dtype=np.float32)
        shape = module.get_submodule(path).weight.shape
        if len(shape) == 4:
            cout, cin, kh, kw = shape
            down = down.reshape(kh, kw, cin, -1).transpose(3, 2, 0, 1).reshape(-1, cin * kh * kw)
        else:
            down = down.T
        out[path] = {'down': torch.from_numpy(np.ascontiguousarray(down)),
                     'up': torch.from_numpy(np.ascontiguousarray(up.T)),
                     'alpha': torch.tensor(float(np.asarray(entry['alpha'])))}
    return out


def load_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX param tree into ``module`` (strict) and return it."""
    module.load_state_dict(state_dict_from_params(params), strict=True)
    return module
