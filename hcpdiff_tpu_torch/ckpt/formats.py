"""Checkpoint dict formats (counterpart of ``hcpdiff_tpu/ckpt/formats.py``),
byte-compatible with the JAX package's files:

- nested <-> flat fold/unfold with ':'-joined keys for safetensors;
- the ``.___.`` LoRA key scheme: ``<host layer path>.___.layer.W_down``,
  ``.___.layer.W_up`` and ``.___.alpha``, the host path through the alias
  map ({JAX tree path: diffusers module path}), W_down [r, in] (conv
  [r, cin, kh, kw]) and W_up [out, r] (conv [out, r, 1, 1]);
- the webui embedding format ``{'string_to_param': {'*': tensor}, 'name'}``;
- the kohya/webui LoRA keys ``lora_unet_<diffusers path with '_'>
  .lora_down.weight``/``.lora_up.weight``/``.alpha`` (``lora_te``,
  ``lora_te1``, ``lora_te2`` for the text encoders).

The port's overlay (``adapt/overlay.py``) already holds W_down and W_up
in these layouts, flattened: ``down`` [r, fan_in] in (cin, kh, kw) order
and ``up`` [out, r]. So a linear layer converts with no transpose, and a
conv layer by a reshape to [r, cin, kh, kw] and [out, r, 1, 1]. Safetensors
files are read and written by ``ckpt/safetensors_io.py``.
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


def _kohya_module_name(layer_path: str, prefix: str) -> str:
    """A diffusers module path -> its kohya module name: dots to
    underscores after ``<prefix>_``."""
    return f'{prefix}_{layer_path.replace(".", "_")}'


_KOHYA_FIELDS = (('.lora_down.weight', 'down'), ('.lora_up.weight', 'up'), ('.alpha', 'alpha'))


def overlay_to_kohya(overlay: Mapping[str, Mapping[str, torch.Tensor]],
                     torch_paths: Mapping[str, str], prefix: str = 'lora_unet',
                     conv_shapes: Optional[Dict[str, Tuple[int, ...]]] = None
                     ) -> Dict[str, torch.Tensor]:
    """The port's overlay + {path: diffusers module path} -> a kohya state
    dict: ``lora_down.weight`` [r, in] (a conv's [r, cin, kh, kw]),
    ``lora_up.weight`` [out, r] ([out, r, 1, 1]) and ``alpha``.
    ``conv_shapes``: {path: conv weight shape [out, cin, kh, kw]} of the
    overlaid convs. The kohya layout has no slot for a LoRA's bias delta
    (pre-0.9 layers): an overlay with one raises rather than lose it."""
    biased = [p for p, e in overlay.items() if 'bias' in e]
    if biased:
        raise ValueError('overlay_to_kohya: the kohya format cannot hold LoRA bias deltas '
                         f'(pre-0.9 layers), present at {biased[:3]}; save the overlay in the '
                         '.___. format instead, or strip the biases first')
    conv_shapes = conv_shapes or {}
    sd: Dict[str, torch.Tensor] = {}
    for path, entry in overlay.items():
        base = _kohya_module_name(torch_paths.get(path, path), prefix)
        down = entry['down'].detach().float().cpu()
        up = entry['up'].detach().float().cpu()
        shape = conv_shapes.get(path)
        if shape is not None and len(shape) == 4:
            down = down.reshape(down.shape[0], *shape[1:])
            up = up[:, :, None, None]
        sd[f'{base}.lora_down.weight'] = down.contiguous()
        sd[f'{base}.lora_up.weight'] = up.contiguous()
        sd[f'{base}.alpha'] = entry['alpha'].detach().float().cpu().reshape(())
    return sd


def kohya_to_overlay(sd: Mapping[str, torch.Tensor], port_paths: Mapping[str, str],
                     prefix: str = 'lora_unet') -> Dict[str, Dict[str, torch.Tensor]]:
    """The inverse for the keys under ``<prefix>_``, by {diffusers module
    path: port path}: a conv's 4-D factors are flattened to the overlay's
    [r, cin * kh * kw] and [out, r]; ``alpha`` defaults to the rank. A key
    of the prefix that is not a known factor of a module the map names, or
    a module without both factors, raises a ``ValueError`` naming them."""
    by_name = {_kohya_module_name(tp, prefix): fp for tp, fp in port_paths.items()}
    start = prefix + '_'
    tmp: Dict[str, Dict[str, torch.Tensor]] = {}
    unknown = []
    for key, v in sd.items():
        if not key.startswith(start):
            continue
        for suffix, field in _KOHYA_FIELDS:
            if key.endswith(suffix) and key[:-len(suffix)] in by_name:
                tmp.setdefault(by_name[key[:-len(suffix)]], {})[field] = torch.as_tensor(v)
                break
        else:
            unknown.append(key)
    if unknown:
        raise ValueError(f'kohya_to_overlay: {len(unknown)} {prefix} keys name no LoRA factor of '
                         f'a module of this model: {sorted(unknown)[:8]}')
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, e in tmp.items():
        if 'down' not in e or 'up' not in e:
            raise ValueError(f'kohya_to_overlay: {path} lacks lora_down or lora_up')
        down, up = e['down'].float(), e['up'].float()
        if up.dim() == 4 and tuple(up.shape[2:]) != (1, 1):
            raise ValueError(f'kohya_to_overlay: {path} has a {tuple(up.shape[2:])} lora_up; '
                             'only 1x1 up factors are LoRA')
        down = down.reshape(down.shape[0], -1)
        up = up.reshape(up.shape[0], up.shape[1])
        alpha = e.get('alpha', torch.tensor(float(down.shape[0])))
        out[path] = {'down': down, 'up': up, 'alpha': alpha.float().reshape(())}
    return out
