"""Effective model weights from (frozen base, trainable pack) (counterpart of
``hcpdiff_tpu/trainer/assemble.py``).

The pack is a dict of adaptation trees; this slice trains ``lora_unet``
(``{path: {down, up, alpha}}``, see ``adapt/overlay.py``). The frozen UNet
is split in two: a module whose weights are in the compute dtype (bf16 on
the card), and fp32 copies of the weights that LoRA merges into. LoRA
merges in fp32 and each merged weight is cast to the compute dtype at
use, which gives the JAX package's numbers (fp32 frozen params, bf16
compute): a bf16 copy of a weight that carries no LoRA equals casting it
at each use.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from ..adapt.overlay import merge_overlays

PORTED_PACK_KEYS = ('lora_unet',)


def lora_base_weights(unet: nn.Module, overlay: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """fp32 copies of the weights ``overlay`` merges into, by state-dict
    name. Take them before the module is cast to the compute dtype."""
    return {f'{path}.weight': unet.get_submodule(path).weight.detach().float().clone()
            for path in overlay}


def assemble(frozen_unet: Mapping[str, torch.Tensor], pack: Mapping[str, Any],
             lora_scales: Optional[Mapping[str, Mapping[str, float]]] = None
             ) -> Dict[str, torch.Tensor]:
    """-> {state-dict name: merged fp32 weight} for the UNet: the frozen
    base (no gradient) plus the ``lora_unet`` delta. Gradients flow only
    into the pack."""
    unported = set(pack) - set(PORTED_PACK_KEYS)
    if unported:
        raise NotImplementedError(f'pack keys {sorted(unported)} are not ported yet')
    base = {k: v.detach() for k, v in frozen_unet.items()}
    lora = pack.get('lora_unet')
    if not lora:
        return {}
    scales = (lora_scales or {}).get('lora_unet', {})
    merged = merge_overlays(base, [lora], [scales])
    return {f'{path}.weight': merged[f'{path}.weight'] for path in lora}


def make_unet_apply(unet: nn.Module) -> Callable:
    """``unet_apply(params, x, t, ctx)``: run ``unet`` with ``params``
    (state-dict name -> tensor) in place of its own, each cast to the dtype
    of the parameter it replaces."""
    dtypes = {name: p.dtype for name, p in unet.named_parameters()}

    def apply(params: Mapping[str, torch.Tensor], x, t, ctx):
        return functional_call(unet, {k: v.to(dtypes[k]) for k, v in params.items()},
                               (x, t, ctx))
    return apply
