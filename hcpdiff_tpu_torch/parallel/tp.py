"""Tensor-parallel (and data-parallel) UNet inference (counterpart of
``hcpdiff_tpu/parallel/tp.py``).

A ('data', 'model') grid of ranks, one card each, scales the denoise step:

- 'data' splits the batch (the CFG-doubled batch divides over it): each
  rank runs its block and the blocks are all-gathered at the end, so every
  rank returns the whole batch and ``DenoiseLoop`` runs unchanged;
- 'model' is Megatron-style tensor parallelism inside every transformer
  sublayer (``models/unet.py``, ``CrossAttention._tp_call`` and
  ``GEGLUFeedForward._tp_call``): q/k/v and the GEGLU projection are
  column-parallel (each member computes heads/tp heads, kernel A on them,
  and inner/tp GEGLU columns, kernel B on the value and gate rows of those
  columns), to_out and ff.out are row-parallel, with one all-reduce a
  sublayer over the axis.

Every member holds the full weights and slices its share at call time, so
checkpoints, LoRA merges and the weight bridge stay as they are. Under
``HCP_INT8=1`` (read when the UNet is built) each Transformer2D's proj_in
and proj_out run the int8 kernels K and L, as the JAX model routes them;
the tensor-parallel sublayers take no int8. Convs,
norms and the time embedding are replicated compute.

Typical use (``torchrun --nproc_per_node 4``)::

    mesh = make_tp_mesh(tp=2, data=2)
    unet = UNet2DCondition(tp_unet_config(cfg, 2))      # the usual weights
    pipe = DiffusionPipeline(tp_unet_apply(unet, mesh), vae, te)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from . import mesh as pm

__all__ = ['make_tp_mesh', 'tp_unet_apply', 'tp_unet_config']


def make_tp_mesh(tp: int, data: int = -1) -> pm.Mesh:
    """('data', 'model') grid over the world's ranks; data=-1 fills it."""
    n = pm.process_count()
    if data == -1:
        data = n // tp
    if data * tp != n:
        raise ValueError(f'mesh {data}x{tp} != {n} devices')
    return pm.grid((('data', data), ('model', tp)))


def tp_unet_config(cfg, tp: int):
    """UNetConfig with tensor parallelism degree ``tp``; each level's head
    count must divide by it (SD1.5: 8 heads everywhere, tp in {2, 4, 8})."""
    bad = [h for h in cfg.num_heads if h % tp]
    if bad:
        raise ValueError(
            f'tp={tp} does not divide num_heads={cfg.num_heads}; '
            f'choose tp from the common divisors of {set(cfg.num_heads)}')
    return dataclasses.replace(cfg, tp=tp)


class TPUNet(nn.Module):
    """``unet`` over a ('data', 'model') mesh, called like the UNet:
    ``(sample, timesteps, encoder_hidden_states, **extras)``. Every
    batch-leading argument is split over ``data_axis``; the result is the
    whole batch on every rank."""

    def __init__(self, unet: nn.Module, mesh: pm.Mesh, data_axis: str = 'data'):
        super().__init__()
        self.unet, self.mesh, self.data_axis = unet, mesh, data_axis
        self.cfg = unet.cfg

    def _gather(self, out):
        if isinstance(out, tuple):
            return tuple(self._gather(o) for o in out)
        n = self.mesh.size(self.data_axis)
        if n == 1 or not torch.is_tensor(out):
            return out
        full = pm.all_gather_flat(out.contiguous().reshape(-1), self.mesh.group(self.data_axis))
        return full.view((n * out.shape[0],) + tuple(out.shape[1:]))

    def forward(self, sample: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                **extras):
        n = self.mesh.size(self.data_axis)
        B = sample.shape[0]
        if B % n:
            raise ValueError(f'a batch of {B} does not split over the {n} ranks of the '
                             f'{self.data_axis!r} axis')
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(B)
        start, size = pm.local_slice(B, self.mesh, self.data_axis)

        def block(v):
            if torch.is_tensor(v) and v.dim() and v.shape[0] == B:
                return v[start:start + size]
            if isinstance(v, (list, tuple)):
                return type(v)(block(x) for x in v)
            return v
        out = self.unet(block(sample), block(timesteps), block(encoder_hidden_states),
                        **{k: block(v) for k, v in extras.items()})
        return self._gather(out)


def tp_unet_apply(unet: nn.Module, mesh: pm.Mesh, data_axis: str = 'data',
                  tp_axis: str = 'model') -> TPUNet:
    """Bind ``unet``'s tensor-parallel sublayers to the mesh's ``tp_axis``
    and return it wrapped to split the batch over ``data_axis``."""
    if unet.cfg.tp != mesh.size(tp_axis):
        raise ValueError(f'model cfg.tp={unet.cfg.tp} != mesh {tp_axis} axis size '
                         f'{mesh.size(tp_axis)}')
    if unet.cfg.tp_axis != tp_axis:
        raise ValueError(f'cfg.tp_axis={unet.cfg.tp_axis} != {tp_axis!r}')
    for m in unet.modules():
        if getattr(m, 'tp', 1) > 1:
            m.tp_bind = (mesh.group(tp_axis), mesh.index(tp_axis))
    return TPUNet(unet, mesh, data_axis)


def tp_all_reduce(x: torch.Tensor, bind: Optional[tuple]) -> torch.Tensor:
    """The row-parallel sum of a sublayer's partial output over its axis."""
    if bind is None:
        raise RuntimeError('a tp > 1 UNet runs only through tp_unet_apply (its sublayers '
                           'are bound to no mesh axis)')
    group, _ = bind
    if group is not None:
        dist.all_reduce(x, group=group)
    return x
