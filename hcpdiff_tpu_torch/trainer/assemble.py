"""Effective model weights from (frozen base, trainable pack) (counterpart of
``hcpdiff_tpu/trainer/assemble.py``).

The pack is a dict of adaptation trees:

    'unet_ft' / 'te_ft' / 'te2_ft'      {state-dict name: weight} (layer-wise
                                        fine-tune; te2: SDXL's second encoder)
    'lora_unet' / 'lora_te' / 'lora_te2' LoRA overlays {path: {down, up, alpha}}
                                        (``adapt/overlay.py``)
    '..._neg'                           DreamArtist's negative-branch overlays
    'emb'                               prompt-tuning rows [n, D] (SDXL: a dict
                                        of the two encoders' tables), shared by
                                        both branches
    'controlnet'                        a ControlNet's fp32 weights {state-dict
                                        name: tensor} (``make_controlnet_apply``);
                                        no model's weights take it

``assemble`` (UNet), ``assemble_te`` and ``assemble_te2`` give the weights
that differ from the model's own: the frozen base (no gradient), overlaid
by the ft subset, plus each LoRA delta of the branch times its scale
(``branch='neg'`` takes the ``_neg`` overlays; the ft subsets and the
``emb`` rows are shared).
Gradients flow only into the pack.
The JAX package's nested-tree ``merge_subset``/``extract_subset`` are
dict operations on these flat names (``base_weights`` takes a subset).
A frozen model is split in two: its module, whose weights are in the
compute dtype (bf16 on the card), and fp32 copies of the weights that
LoRA merges into (``base_weights``). LoRA merges in fp32 and each merged
weight is cast to the compute dtype at use, which gives the JAX package's
numbers (fp32 frozen params, bf16 compute): a bf16 copy of a weight that
carries no LoRA equals casting it at each use.

Under ``fsdp: N`` (the JAX ``fsdp_shardings``) the frozen base is
sharded over the fsdp axis by :class:`FrozenShards`: each member stores
1/N of every frozen leaf between steps (the fp32 copies above and the
frozen modules' own weights), and the step's weights are built inside
``FrozenShards.gathered()``, which gathers every leaf in a few flat
all-gathers and releases them after the step. The peak is therefore one
whole copy of the frozen base during the step, against the JAX layout's,
where XLA gathers each weight into its own matmul: the same 1/N between
steps, a higher peak within one.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn
from torch.func import functional_call

from ..adapt.overlay import merge_overlays
from ..parallel import mesh as pm

PORTED_PACK_KEYS = ('lora_unet', 'unet_ft', 'lora_te', 'te_ft', 'lora_te2', 'te2_ft',
                    'lora_unet_neg', 'lora_te_neg', 'lora_te2_neg', 'emb', 'controlnet')


def base_weights(module: nn.Module, names: Iterable[str]) -> Dict[str, torch.Tensor]:
    """fp32 copies of ``module``'s parameters by name. Take them before the
    module is cast to the compute dtype."""
    params = dict(module.named_parameters())
    return {n: params[n].detach().float().clone() for n in names}


def lora_base_weights(unet: nn.Module, overlay: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """fp32 copies of the weights ``overlay`` merges into, by state-dict
    name."""
    return base_weights(unet, [f'{path}.weight' for path in overlay])


def _assemble(frozen: Mapping[str, torch.Tensor], pack: Mapping[str, Any], lora_key: str,
              ft_key: str, lora_scales, branch: str) -> Dict[str, torch.Tensor]:
    unported = set(pack) - set(PORTED_PACK_KEYS)
    if unported:
        raise NotImplementedError(f'pack keys {sorted(unported)} are not ported yet')
    lora_key += '' if branch == 'pos' else '_neg'
    ft = dict(pack.get(ft_key) or {})
    lora = pack.get(lora_key) or {}
    base = {f'{p}.weight': frozen[f'{p}.weight'].detach() for p in lora
            if f'{p}.weight' not in ft}
    return merge_overlays({**ft, **base}, [lora], [(lora_scales or {}).get(lora_key, {})])


def assemble(frozen_unet: Mapping[str, torch.Tensor], pack: Mapping[str, Any],
             lora_scales: Optional[Mapping[str, Mapping[str, float]]] = None,
             branch: str = 'pos') -> Dict[str, torch.Tensor]:
    """-> {state-dict name: weight} for the UNet: ``unet_ft`` over the
    frozen base, plus the ``lora_unet`` (``lora_unet_neg``) delta."""
    return _assemble(frozen_unet, pack, 'lora_unet', 'unet_ft', lora_scales, branch)


def assemble_te(frozen_te: Mapping[str, torch.Tensor], pack: Mapping[str, Any],
                lora_scales: Optional[Mapping[str, Mapping[str, float]]] = None,
                branch: str = 'pos') -> Dict[str, torch.Tensor]:
    """The same for the text encoder: ``te_ft`` and ``lora_te``."""
    return _assemble(frozen_te, pack, 'lora_te', 'te_ft', lora_scales, branch)


def assemble_te2(frozen_te2: Mapping[str, torch.Tensor], pack: Mapping[str, Any],
                 lora_scales: Optional[Mapping[str, Mapping[str, float]]] = None,
                 branch: str = 'pos') -> Dict[str, torch.Tensor]:
    """The same for SDXL's second text encoder: ``te2_ft`` and ``lora_te2``."""
    return _assemble(frozen_te2, pack, 'lora_te2', 'te2_ft', lora_scales, branch)


def _casting(module: nn.Module) -> Callable:
    dtypes = {name: p.dtype for name, p in module.named_parameters()}
    return lambda params: {k: v.to(dtypes[k]) for k, v in params.items()}


def make_unet_apply(unet: nn.Module) -> Callable:
    """``unet_apply(params, x, t, ctx, **extra)``: run ``unet`` with
    ``params`` (state-dict name -> tensor) in place of its own, each cast
    to the dtype of the parameter it replaces; ``extra`` are the UNet's
    keyword inputs (SDXL's ``pooled_text_emb`` and ``time_ids``)."""
    cast = _casting(unet)

    def apply(params: Mapping[str, torch.Tensor], x, t, ctx, **extra):
        return functional_call(unet, cast(params), (x, t, ctx), extra)
    return apply


def make_controlnet_apply(net: nn.Module) -> Callable:
    """``controlnet_apply(params, x, t, ctx, cond) -> (down residuals, mid
    residual)``: ``net`` (a ControlNet) with ``params`` in place of its own,
    each cast to the dtype of the parameter it replaces."""
    cast = _casting(net)

    def apply(params: Mapping[str, torch.Tensor], x, t, ctx, cond):
        return functional_call(net, cast(params), (x, t, ctx, cond))
    return apply


def make_te_apply(frontend) -> Callable:
    """``te_apply(params, input_ids, token_mult, emb_ext=None) -> (ctx,
    pooled)``: the text frontend's encode (windows, ``clip_skip``, final
    norm) with ``params`` in place of its CLIP model's own, gradients
    flowing into them and ``emb_ext``. SDXL's frontend (``fe1``/``fe2``)
    takes ``params`` as {'te': {...}, 'te2': {...}}."""
    if hasattr(frontend, 'fe2'):
        casts = {'te': _casting(frontend.fe1.model), 'te2': _casting(frontend.fe2.model)}

        def apply_dual(params, input_ids, token_mult=None, emb_ext=None):
            return frontend.encode_ids(input_ids, token_mult, emb_ext=emb_ext,
                                       params={k: casts[k](v) for k, v in params.items()})
        return apply_dual
    cast = _casting(frontend.model)

    def apply(params: Mapping[str, torch.Tensor], input_ids, token_mult=None, emb_ext=None):
        return frontend.encode_ids(input_ids, token_mult, params=cast(params), emb_ext=emb_ext)
    return apply


class FrozenShards:
    """The frozen base sharded over the ``fsdp`` axis of a mesh: member k
    of n keeps chunk k of each tensor (flattened, padded to a multiple of
    n), and the tensors themselves hold no storage between steps.
    ``gathered()`` makes them whole (their ``.data``) for its body."""

    def __init__(self, tensors: Sequence[torch.Tensor], group, n: int, index: int):
        self.tensors = list(tensors)
        self.group, self.n = group, n
        self.meta = [(tuple(t.shape), t.numel(), -(-t.numel() // n)) for t in self.tensors]
        self.runs = pm.buckets([t.detach() for t in self.tensors])
        self.shards: List[torch.Tensor] = []
        for run in self.runs:
            parts = []
            for i in run:
                t, (_, numel, chunk) = self.tensors[i].detach().reshape(-1), self.meta[i]
                part = t[index * chunk:(index + 1) * chunk]
                parts.append(torch.cat([part, part.new_zeros(chunk - part.numel())]))
            self.shards.append(torch.cat(parts))
        self.release()

    def release(self) -> None:
        for t in self.tensors:
            t.data = torch.empty(0, dtype=t.dtype, device=t.device)

    def gather(self) -> None:
        for run, shard in zip(self.runs, self.shards):
            full = pm.all_gather_flat(shard, self.group).view(self.n, -1)
            off = 0
            for i in run:
                shape, numel, chunk = self.meta[i]
                t = self.tensors[i]
                t.data = full[:, off:off + chunk].reshape(-1)[:numel].view(shape).clone()
                off += chunk

    @contextlib.contextmanager
    def gathered(self):
        self.gather()
        try:
            yield
        finally:
            self.release()

    def held_bytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self.shards)

    def full_bytes(self) -> int:
        return sum(numel * t.element_size() for (_, numel, _), t in zip(self.meta, self.tensors))
