"""LoRA as a parameter overlay (counterpart of ``hcpdiff_tpu/adapt/overlay.py``).

An overlay is a dict ``{module path: {'down', 'up', 'alpha'}}`` kept apart
from the frozen model. ``merge_overlays`` returns W + sum(delta W) for the
overlaid weights, and the model runs them through
``torch.func.functional_call``: one matmul per layer at run time, as the
JAX package merges them into its param tree.

Layouts follow ``nn.Linear``/``nn.Conv2d``: ``down`` is [r, fan_in] and
``up`` [out, r], so delta W = up @ down, reshaped to the weight's
[out, in] or [out, in, kh, kw]. (The JAX overlay's ``down`` [fan_in, r]
and ``up`` [r, out] are their transposes; ``ckpt/bridge.py`` converts.)
Module paths are the port's module names, which equal the JAX tree's
paths, so the same layer patterns select the same layers.
"""
from __future__ import annotations

import math
import re
import warnings
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

PathDict = Dict[str, Any]


def module_paths(module: nn.Module) -> List[str]:
    """Paths of every Linear/Conv2d submodule (the JAX package's modules
    with a 'kernel' leaf), sorted."""
    return sorted(name for name, m in module.named_modules()
                  if isinstance(m, (nn.Linear, nn.Conv2d)))


def _ancestors(path: str) -> List[str]:
    parts = path.split('.')
    return ['.'.join(parts[:i]) for i in range(1, len(parts) + 1)]


def get_match_layers(patterns: Iterable[str], candidates: Sequence[str],
                     aliases: Optional[Dict[str, str]] = None) -> List[str]:
    """Resolve config layer patterns to ordered unique module paths, with
    the JAX package's selector semantics: ``re:<regex>`` searches module
    paths and their ancestors (a hit on a parent expands to every
    candidate below it); a plain string matches a path exactly, or as a
    prefix; ``aliases`` ({path: other name}) let patterns match through a
    second name."""
    if isinstance(patterns, str):
        patterns = [patterns]
    aliases = aliases or {}
    name_to_kernels: Dict[str, List[str]] = {}
    for c in candidates:
        names = set(_ancestors(c))
        alias = aliases.get(c)
        if alias:
            names.update(_ancestors(alias))
        for n in names:
            name_to_kernels.setdefault(n, []).append(c)
    all_names = sorted(name_to_kernels)

    out: List[str] = []
    for pat in patterns:
        if pat.startswith('pre_hook:'):
            pat = pat[len('pre_hook:'):]
        if pat.startswith('re:'):
            rx = re.compile(pat[3:])
            hit_names = [n for n in all_names if rx.search(n)]
        else:
            hit_names = [n for n in all_names if n == pat]
            if not hit_names:
                hit_names = [n for n in all_names if n.startswith(pat + '.')]
        for n in hit_names:
            for k in name_to_kernels[n]:
                if k not in out:
                    out.append(k)
    return out


def init_lora_layer(generator: torch.Generator, weight_shape: Tuple[int, ...], rank: int,
                    alpha: float = 1.0) -> Dict[str, torch.Tensor]:
    """LoRA factors for a Linear [out, in] or Conv2d [out, in, kh, kw]
    weight: down [r, fan_in] uniform in +-sqrt(6 / fan_in) (kaiming, as
    the JAX package draws it), up [out, r] zeros, so delta W starts at 0.
    Made on ``generator``'s device, fp32."""
    if len(weight_shape) not in (2, 4):
        raise ValueError(f'unsupported weight shape {weight_shape}')
    fan_out, fan_in = weight_shape[0], math.prod(weight_shape[1:])
    bound = math.sqrt(3.0) * math.sqrt(2.0) / math.sqrt(fan_in)
    dev = generator.device
    down = torch.rand(rank, fan_in, generator=generator, device=dev) * (2 * bound) - bound
    return {'down': down, 'up': torch.zeros(fan_out, rank, device=dev),
            'alpha': torch.tensor(float(alpha), device=dev)}


def resolve_rank(rank, fan_out: int) -> int:
    """A float rank below 1 is a fraction of out_features; an int is used
    as it is."""
    if isinstance(rank, float) and rank < 1.0:
        return max(1, round(fan_out * rank))
    return int(rank)


def make_lora_overlay(generator: torch.Generator, module: nn.Module, layer_specs: Sequence[dict],
                      candidates: Optional[Sequence[str]] = None,
                      aliases: Optional[Dict[str, str]] = None
                      ) -> Tuple[PathDict, Dict[str, float]]:
    """Build a LoRA overlay from config specs, each
    ``{layers: [...], rank: int|float, alpha: float, scale: float}``.
    Returns (overlay {path: {down, up, alpha}}, {path: scale})."""
    candidates = candidates or module_paths(module)
    overlay: PathDict = {}
    scales: Dict[str, float] = {}
    for spec in layer_specs:
        layers = get_match_layers(spec.get('layers', []), candidates, aliases)
        rank = spec.get('rank', 8)
        alpha = float(spec.get('alpha', 1.0))
        scale = float(spec.get('scale', 1.0))
        for path in layers:
            shape = tuple(module.get_submodule(path).weight.shape)
            overlay[path] = init_lora_layer(generator, shape, resolve_rank(rank, shape[0]),
                                            alpha)
            scales[path] = scale
    return overlay, scales


def lora_delta(entry: Mapping[str, torch.Tensor], weight_shape: Tuple[int, ...],
               scale: float = 1.0) -> torch.Tensor:
    """delta W = scale * (alpha / rank) * up @ down, in the weight's layout."""
    down, up, alpha = entry['down'], entry['up'], entry['alpha']
    rank = down.shape[0]
    return ((up @ down) * (alpha / rank) * scale).reshape(weight_shape)


def merge_overlays(params: Mapping[str, torch.Tensor], overlays: Sequence[PathDict],
                   scales: Optional[Sequence[Mapping[str, float]]] = None
                   ) -> Dict[str, torch.Tensor]:
    """W_eff = W + sum_i delta W_i. ``params`` maps state-dict names
    (``'<path>.weight'``) to base weights; returns a new dict with every
    overlaid weight replaced by its merged value (in the base weight's
    dtype). Overlays stacked on one layer sum. An entry's ``bias`` (the
    pre-0.9 reference LoRA layers' up-projection bias) adds
    ``bias * alpha / rank * scale`` to the host's ``'<path>.bias'``; a
    host without one raises (``attach_host_biases`` gives it one, as the
    Visualizer does after rebuilding the UNet with ``qkv_bias``)."""
    merged = dict(params)
    scales = scales or [{}] * len(overlays)
    for ov, sc in zip(overlays, scales):
        for path, entry in ov.items():
            name = f'{path}.weight'
            w = merged[name]
            s = sc.get(path, 1.0)
            merged[name] = w + lora_delta(entry, tuple(w.shape), s).to(w.dtype)
            if 'bias' in entry:
                b = merged.get(f'{path}.bias')
                if b is None:
                    raise ValueError(
                        f'LoRA at {path!r} has a bias but the host layer is bias-free; '
                        'attach_host_biases() gives it one (after rebuilding the UNet with '
                        'UNetConfig(qkv_bias=True)), strip_overlay_bias() drops it')
                db = entry['bias'] * (entry['alpha'] / entry['down'].shape[0]) * s
                merged[f'{path}.bias'] = b + db.to(b)
    return merged


def collapse_overlay(params: Mapping[str, torch.Tensor], overlay: PathDict,
                     scales: Optional[Mapping[str, float]] = None) -> Dict[str, torch.Tensor]:
    """Fold one overlay's deltas into the base weights for good."""
    return merge_overlays(params, [overlay], [scales or {}])


def overlay_bias_paths(overlays: Sequence[PathDict], params: Mapping[str, torch.Tensor]
                       ) -> List[str]:
    """Paths where an overlay carries a bias delta but ``params`` has a
    weight and no bias (pre-0.9 biased LoRAs on SD's bias-free attention
    projections)."""
    out: List[str] = []
    for ov in overlays:
        for path, entry in ov.items():
            if ('bias' in entry and f'{path}.weight' in params
                    and f'{path}.bias' not in params and path not in out):
                out.append(path)
    return out


def attach_host_biases(params: Mapping[str, torch.Tensor], paths: Iterable[str]
                       ) -> Dict[str, torch.Tensor]:
    """A copy of ``params`` with a zero ``'<path>.bias'`` (the weight's
    out-features, dtype and device) at each path that has none: the
    reference creates the host bias when it folds a biased LoRA into a
    bias-free layer."""
    out = dict(params)
    for path in paths:
        w = out[f'{path}.weight']
        out.setdefault(f'{path}.bias', torch.zeros(w.shape[0], dtype=w.dtype, device=w.device))
    return out


def strip_overlay_bias(overlay: PathDict) -> PathDict:
    """The overlay without its bias deltas (the weight deltas kept), for
    bias-free hosts; warns with the paths it stripped."""
    out, dropped = {}, []
    for path, entry in overlay.items():
        if 'bias' in entry:
            entry = {k: v for k, v in entry.items() if k != 'bias'}
            dropped.append(path)
        out[path] = entry
    if dropped:
        warnings.warn(f'stripped LoRA bias deltas at {len(dropped)} layers ({dropped[:3]}...): '
                      'bias-free hosts cannot hold them', stacklevel=2)
    return out


def trainable_mask(module: nn.Module, train_patterns: Sequence[str],
                   aliases: Optional[Dict[str, str]] = None) -> List[str]:
    """The parameter names a layer-wise fine-tune trains (the config's
    ``unet:``/``text_encoder:`` ``layers``): every parameter of the
    Linear/Conv2d modules the patterns select, as the JAX package's
    ``trainable_mask`` selects them; the pattern ``''`` selects every
    parameter of the model, as the configs document it (the JAX
    ``trainable_mask`` selects nothing for it)."""
    if isinstance(train_patterns, str):
        train_patterns = [train_patterns]
    names = [n for n, _ in module.named_parameters()]
    if '' in train_patterns:
        return names
    selected = set(get_match_layers(train_patterns, module_paths(module), aliases))
    return [n for n in names if n.rsplit('.', 1)[0] in selected]
