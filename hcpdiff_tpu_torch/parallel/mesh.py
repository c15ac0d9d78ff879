"""Process group, rank grids and collective helpers (counterpart of
``hcpdiff_tpu/parallel/mesh.py``, as ``torch.distributed``).

One process drives one card. A run launched by ``torchrun`` (or
``python -m torch.distributed.run``) finds ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in its environment;
:func:`init_distributed` joins the process group from them, with the
``nccl`` backend on ``cuda:LOCAL_RANK`` and ``gloo`` where the caller asked
for the CPU. A process without that environment is world size 1 with no
group, and every helper here is then a local no-op. The same environment
spread over several nodes is ``multi_host: true`` (the JAX package's
``jax.distributed.initialize()``). A CUDA run whose NCCL group fails to
form raises: nothing carries on in one process or on ``gloo``.

:class:`Mesh` is a grid of ranks with named axes, row-major over the
ranks: ``make_mesh(data, fsdp)`` is the trainer's ('data', 'fsdp') grid
(the JAX ``Mesh`` of the same shape over one device a process), and
``parallel/tp.py`` makes the ('data', 'model') one. Each axis has the
subgroup of the ranks that differ only along it.

The collective helpers keep the JAX semantics: :func:`barrier`,
:func:`broadcast_string` (rank 0's string), :func:`gather_to_host`
(every rank enters; every rank gets each rank's object on the host),
:func:`pad_to_multiple` and :func:`local_slice`. The flat-buffer helpers
(:func:`all_reduce_flat`, :func:`broadcast_flat`, :func:`reduce_flat`)
move a list of tensors in a few buckets of at most ``BUCKET_BYTES``
each, never one call a tensor.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

BUCKET_BYTES = 256 << 20


def launched() -> bool:
    """Does this process's environment describe a ``torchrun`` world?"""
    return all(k in os.environ for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'))


def init_distributed(device) -> torch.device:
    """Join the process group the ``torchrun`` environment describes and
    return this rank's device: ``cuda:LOCAL_RANK`` (``nccl``) for a CUDA
    ``device``, the CPU (``gloo``) otherwise. Without that environment the
    process is world size 1 with no group and ``device`` is returned as
    given. A group that is already up is joined as it is; its backend must
    be the one the device needs."""
    device = torch.device(device)
    if not launched() and not dist.is_initialized():
        return device
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if device.type == 'cuda':
        device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method='env://',
                                rank=int(os.environ['RANK']),
                                world_size=int(os.environ['WORLD_SIZE']))
    got = dist.get_backend()
    if got != backend:
        raise RuntimeError(f'the process group runs {got!r}; a {device.type} run needs '
                           f'{backend!r}')
    return device


def distributed() -> bool:
    """Is there a process group (of any size, 1 included)?"""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def is_main_process() -> bool:
    return process_index() == 0


def comm_device() -> torch.device:
    """Where the group's collectives take their tensors: this rank's card
    under ``nccl``, the CPU under ``gloo`` or with no group."""
    if distributed() and dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


@dataclasses.dataclass
class Mesh:
    """A row-major grid of the world's ranks with named axes.
    ``groups[axis]`` holds the ranks that differ from this one only along
    ``axis`` (None without a process group)."""
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[str, Any]
    axis_ranks: Dict[str, List[int]]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    def size(self, axis: str) -> int:
        return self.sizes[self.axes.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axes.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]

    def global_rank(self, axis: str, index: int) -> int:
        """The world rank of member ``index`` of this rank's ``axis`` group."""
        return self.axis_ranks[axis][index]


def grid(axes: Sequence[Tuple[str, int]]) -> Mesh:
    """The mesh of ``axes`` ((name, size), ...) over the whole world, whose
    sizes must multiply to the world size. Every rank makes every subgroup,
    in the same order, as ``torch.distributed.new_group`` requires."""
    names = tuple(a for a, _ in axes)
    sizes = tuple(int(s) for _, s in axes)
    n, rank = process_count(), process_index()
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    coords = tuple((rank // st) % sz for st, sz in zip(strides, sizes))
    groups: Dict[str, Any] = {}
    axis_ranks: Dict[str, List[int]] = {}
    for i, name in enumerate(names):
        # the groups along axis i: one for each setting of the other axes
        others = [r for r in range(n) if (r // strides[i]) % sizes[i] == 0]
        for base in others:
            members = [base + k * strides[i] for k in range(sizes[i])]
            group = dist.new_group(members) if distributed() else None
            if rank in members:
                groups[name], axis_ranks[name] = group, members
    return Mesh(names, sizes, coords, groups, axis_ranks)


def make_mesh(data: int = -1, fsdp: int = 1) -> Mesh:
    """The ('data', 'fsdp') grid over the world; ``data=-1`` fills it."""
    n = process_count()
    if data == -1:
        data = n // fsdp
    if data * fsdp != n:
        raise ValueError(f'mesh {data}x{fsdp} != {n} processes')
    return grid((('data', data), ('fsdp', fsdp)))


# ------------------------------------------------------------ helpers ----
def barrier(name: str = 'barrier') -> None:
    """Every rank waits here for every other (the reference's
    ``accelerator.wait_for_everyone``). No-op without a group."""
    if distributed():
        dist.barrier()


def broadcast_string(s: str, max_len: int = 256) -> str:
    """Rank 0's string on every rank (utf-8, fixed-width uint8)."""
    if not distributed():
        return s
    buf = torch.zeros(max_len, dtype=torch.uint8)
    raw = s.encode('utf-8')[:max_len]
    buf[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    buf = buf.to(comm_device())
    dist.broadcast(buf, src=0)
    out = buf.cpu()
    return bytes(out[out != 0].tolist()).decode('utf-8')


def _to_host(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def gather_to_host(obj: Any, group=None) -> List[Any]:
    """Each rank's ``obj`` (tensors moved to the CPU), in rank order, on
    every rank. A collective: every rank of ``group`` must call it
    together. Without a group, ``[obj]``."""
    obj = _to_host(obj)
    if not distributed():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def pad_to_multiple(n_items: int, multiple: int) -> int:
    """Round ``n_items`` up to a multiple of ``multiple`` (the bucket's
    padding, reference data/bucket.py:181-188)."""
    return ((n_items + multiple - 1) // multiple) * multiple


def local_slice(global_batch: int, mesh: Mesh, axis: str = 'data') -> Tuple[int, int]:
    """(start, size) of this rank's block of a global batch along ``axis``."""
    n = mesh.size(axis)
    if global_batch % n:
        raise ValueError(f'a global batch of {global_batch} does not split over the {n} '
                         f'ranks of the {axis!r} axis')
    per = global_batch // n
    return mesh.index(axis) * per, per


# ------------------------------------------------- flat-buffer moves ----
def buckets(tensors: Sequence[torch.Tensor], cap: int = BUCKET_BYTES) -> List[List[int]]:
    """Indices of ``tensors`` in runs of one dtype and at most ``cap``
    bytes (a tensor larger than ``cap`` is a run of its own)."""
    out: List[List[int]] = []
    size, dtype = 0, None
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if out and t.dtype == dtype and size + nbytes <= cap:
            out[-1].append(i)
            size += nbytes
        else:
            out.append([i])
            size, dtype = nbytes, t.dtype
    return out


@torch.no_grad()
def _flat_apply(tensors: Sequence[torch.Tensor], run: Callable[[torch.Tensor], None],
                write_back: bool = True) -> None:
    dev = comm_device()
    for idx in buckets(tensors):
        flat = torch.cat([tensors[i].detach().reshape(-1).to(dev) for i in idx])
        run(flat)
        if write_back:
            off = 0
            for i in idx:
                t = tensors[i]
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def all_reduce_flat(tensors: Sequence[torch.Tensor], group=None, mean: bool = False) -> None:
    """Sum (or mean) each tensor over ``group`` in place, bucketed."""
    if not distributed() or not tensors:
        return
    n = dist.get_world_size(group)

    def run(flat):
        dist.all_reduce(flat, group=group)
        if mean:
            flat.div_(n)
    _flat_apply(tensors, run)


def reduce_flat(tensors: Sequence[torch.Tensor], dst: int, group=None, mean: bool = False
                ) -> None:
    """Sum (or mean) each tensor over ``group`` into world rank ``dst``'s
    copy, bucketed; the others' copies are left as they were."""
    if not distributed() or not tensors:
        return
    n = dist.get_world_size(group)
    me = dist.get_rank()

    def run(flat):
        dist.reduce(flat, dst=dst, group=group)
        if mean and me == dst:
            flat.div_(n)
    _flat_apply(tensors, run, write_back=me == dst)


def broadcast_flat(tensors: Sequence[torch.Tensor], src: int, group=None) -> None:
    """World rank ``src``'s values of each tensor into every rank's, in
    place, bucketed; every rank's tensors must have ``src``'s shapes."""
    if not distributed() or not tensors:
        return
    _flat_apply(tensors, lambda flat: dist.broadcast(flat, src=src, group=group),
                write_back=dist.get_rank() != src)


def all_gather_flat(shard: torch.Tensor, group=None) -> torch.Tensor:
    """The members' equal-length 1-d ``shard`` tensors, concatenated in
    their order within ``group``."""
    n = dist.get_world_size(group)
    out = torch.empty(n * shard.numel(), dtype=shard.dtype, device=shard.device)
    gather = getattr(dist, 'all_gather_single', None) or dist.all_gather_into_tensor
    gather(out, shard.contiguous(), group=group)
    return out
