"""Checkpoint dict formats (counterpart of ``hcpdiff_tpu/ckpt/formats.py``),
byte-compatible with the JAX package's files:

- nested <-> flat fold/unfold with ':'-joined keys for safetensors;
- the ``.___.`` LoRA key scheme: ``<host layer path>.___.layer.W_down``,
  ``.___.layer.W_up`` and ``.___.alpha``, the host path through the alias
  map ({JAX tree path: diffusers module path}), W_down [r, in] (conv
  [r, cin, kh, kw]) and W_up [out, r] (conv [out, r, 1, 1]);
- the webui embedding format ``{'string_to_param': {'*': tensor}, 'name'}``.

The port's overlay (``adapt/overlay.py``) already holds W_down and W_up
in these layouts, flattened: ``down`` [r, fan_in] in (cin, kh, kw) order
and ``up`` [out, r]. Safetensors files are read and written by
``ckpt/safetensors_io.py``. Not ported yet: the kohya/webui LoRA key
conversion (ROADMAP.md queue 1 item 5).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

SEP = ':'
PLACEHOLDER = '.___.'


def unfold_dict(nested: Mapping[str, Any], sep: str = SEP) -> Dict[str, torch.Tensor]:
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f'{prefix}{sep}{k}' if prefix else str(k))
        else:
            flat[prefix] = torch.as_tensor(node).detach().cpu().contiguous()

    walk(nested, '')
    return flat


def fold_dict(flat: Mapping[str, Any], sep: str = SEP) -> Dict[str, Any]:
    nested: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(sep)
        node = nested
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return nested


def lora_overlay_to_state(overlay: Mapping[str, Mapping[str, torch.Tensor]],
                          aliases: Optional[Dict[str, str]] = None,
                          conv_shapes: Optional[Dict[str, Tuple[int, ...]]] = None
                          ) -> Dict[str, torch.Tensor]:
    """The port's overlay {path: {down, up, alpha}} -> the ``.___.`` state
    dict. ``conv_shapes``: {path: conv weight shape [out, cin, kh, kw]} for
    the overlaid convs, whose factors are saved 4-D."""
    aliases = aliases or {}
    conv_shapes = conv_shapes or {}
    sd: Dict[str, torch.Tensor] = {}
    for path, entry in overlay.items():
        host = aliases.get(path, path)
        down = entry['down'].detach().float().cpu()
        up = entry['up'].detach().float().cpu()
        shape = conv_shapes.get(path)
        if shape is not None and len(shape) == 4:
            down = down.reshape(down.shape[0], *shape[1:])
            up = up[:, :, None, None]
        sd[f'{host}{PLACEHOLDER}layer.W_down'] = down.contiguous()
        sd[f'{host}{PLACEHOLDER}layer.W_up'] = up.contiguous()
        sd[f'{host}{PLACEHOLDER}alpha'] = entry['alpha'].detach().float().cpu().reshape(())
        if 'bias' in entry:
            sd[f'{host}{PLACEHOLDER}layer.bias'] = entry['bias'].detach().float().cpu()
    return sd


def lora_state_to_overlay(sd: Mapping[str, torch.Tensor],
                          aliases: Optional[Dict[str, str]] = None
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Inverse of ``lora_overlay_to_state``; ``aliases`` = {path: alias}
    (reversed here). Takes the current layout (``layer.W_down``/``W_up``/
    ``layer.bias``) and the pre-0.9 one (``layer.lora_down.weight``/
    ``lora_up.weight``/``lora_up.bias``), whose tensors are laid out alike."""
    rev = {v: k for k, v in (aliases or {}).items()}
    overlay: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, v in sd.items():
        if PLACEHOLDER not in key:
            continue
        host, param = key.split(PLACEHOLDER, 1)
        e = overlay.setdefault(rev.get(host, host), {})
        v = torch.as_tensor(v).float()
        if param.endswith('W_down') or param.endswith('lora_down.weight'):
            e['down'] = v.reshape(v.shape[0], -1)
        elif param.endswith('W_up') or param.endswith('lora_up.weight'):
            e['up'] = v.reshape(v.shape[0], v.shape[1])
        elif param.endswith('alpha'):
            e['alpha'] = v.reshape(())
        elif param.endswith('bias'):
            e['bias'] = v.reshape(-1)
    for e in overlay.values():
        e.setdefault('alpha', torch.tensor(1.0))
    return overlay


def save_webui_embedding(path: str, vectors, name: str, step: Optional[int] = None) -> None:
    obj = {'string_to_param': {'*': torch.as_tensor(np.asarray(vectors))}, 'name': name,
           'step': step}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(obj, path)


def load_webui_embedding(path: str) -> Tuple[str, np.ndarray]:
    """(name, vectors [n, D] fp32) of a webui ``.pt`` embedding, read with
    ``weights_only=True`` (tensors and plain containers only)."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    stem = os.path.splitext(os.path.basename(path))[0]
    if 'string_to_param' in obj:
        t, name = obj['string_to_param']['*'], obj.get('name') or stem
    elif 'emb_params' in obj:
        t, name = obj['emb_params'], stem
    else:
        t, name = obj, stem
    return name, t.detach().cpu().float().numpy()
