"""Data parallelism and ZeRO-1/2/3 for the port's train step (the JAX
trainer's batch sharding over 'data', ``zero_level`` and
``_apply_state_shardings``, ``hcpdiff_tpu/trainer/trainer.py:696-780``).

The step takes its gradients explicitly (``trainer/step.py``), so data
parallelism is a collective on them after the ``grad_accum`` loop, not a
DDP wrapper. Rank i of the data axis holds block i of each global batch
(the JAX global array's layout) and keeps block i of the noise and
timesteps drawn for the whole batch from the shared generator, so a
W-rank step is one step on the global batch.

ZeRO gives each rank of the data axis whole pack leaves, balanced by
bytes (``owners``: the largest first, each to the least loaded rank, so
a rank holds at most 1/W of the bytes plus its largest leaf), as
``torch.distributed.optim.ZeroRedundancyOptimizer`` does; whole leaves
keep Adafactor's factored statistics on one rank. At levels 1 and 2 the
balance is of the optimizer state's bytes (where an optimizer's state is
not proportional to its leaf's: Adafactor's factored leaves), at level 3
of the pack's.

- level 0: the gradients (and the loss, in the same buffers) are
  all-reduced to their mean; every rank steps every leaf;
- level 1: the optimizers bind only the rank's leaves, so their state
  lives on their owner; the owners broadcast the updated leaves;
- level 2: the gradients are reduced to their owner (``reduce`` in
  place of ``all_reduce``, the JAX ``grad_constraint``) and dropped
  elsewhere; the global norm is the all-reduced sum of the owners'
  squared partials;
- level 3: between steps a rank keeps only its own leaves of the pack and
  of its EMA (the others' storage released); the owners broadcast them
  before the forward.

D-Adaptation and Prodigy sum over a parameter group: under ZeRO their
group sums go through ``sum_over_data`` (``bind_optimizer``), so every
rank updates with the same ``d``. The full state is saved in the layout
one process has (``canonical_state``) and split again on restore
(``local_state``), so a resume re-applies the sharding, at any world
size. Every collective moves flat buckets (``parallel/mesh.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from . import mesh as pm


def zero_level(tcfg) -> int:
    """``train.zero: N`` (``train.zero1: true`` is level 1)."""
    level = int(tcfg.get('zero', 0) or 0)
    if bool(tcfg.get('zero1', False)):
        level = max(level, 1)
    if level not in (0, 1, 2, 3):
        raise ValueError(f'train.zero={level}: expected 0, 1, 2 or 3')
    return level


def owners(nbytes: Sequence[int], n: int) -> List[int]:
    """The owning rank of each leaf: the largest first (then leaf order),
    each to the least loaded rank (then the lowest)."""
    load = [0] * n
    out = [0] * len(nbytes)
    for i in sorted(range(len(nbytes)), key=lambda i: (-nbytes[i], i)):
        r = min(range(n), key=lambda r: (load[r], r))
        out[i] = r
        load[r] += nbytes[i]
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DataParallel:
    """The data axis of ``mesh`` for one pack: ``leaves`` are
    ``pack_leaves(pack)`` as the step sees them; ``weights`` (one a leaf)
    are what the ownership balances, the leaves' bytes by default."""

    def __init__(self, mesh: pm.Mesh, level: int, leaves: Sequence[torch.Tensor],
                 weights: Optional[Sequence[int]] = None):
        self.mesh, self.level = mesh, level
        self.group = mesh.group('data')
        self.n, self.index = mesh.size('data'), mesh.index('data')
        self.shapes = [(tuple(t.shape), t.dtype) for t in leaves]
        if weights is None:
            weights = [_nbytes(t) for t in leaves]
        self.owner = (owners(list(weights), self.n) if level >= 1
                      else [self.index] * len(leaves))
        self.ranks = [mesh.global_rank('data', k) for k in range(self.n)]

    # ------------------------------------------------------- the batch ----
    def owns(self, i: int) -> bool:
        return self.owner[i] == self.index

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global batch's leading axis."""
        if self.n == 1:
            return x
        if x.shape[0] % self.n:
            raise ValueError(f'a global batch of {x.shape[0]} does not split over the {self.n} '
                             'ranks of the data axis')
        b = x.shape[0] // self.n
        return x[self.index * b:(self.index + 1) * b]

    # --------------------------------------------------- the gradients ----
    def reduce_grads(self, grads: List[torch.Tensor], loss: torch.Tensor):
        """Level < 2: the mean of every gradient and of the loss on every
        rank. Level >= 2: each gradient's mean on its owner and None
        elsewhere; the loss is left for ``global_sums``."""
        if self.level < 2:
            box = loss.detach().float().reshape(1).clone()
            pm.all_reduce_flat(grads + [box], self.group, mean=True)
            return grads, box[0]
        for k in range(self.n):
            mine = [g for i, g in enumerate(grads) if self.owner[i] == k]
            pm.reduce_flat(mine, self.ranks[k], self.group, mean=True)
        return [g if self.owns(i) else None for i, g in enumerate(grads)], loss

    def global_sums(self, sq: torch.Tensor, loss: torch.Tensor):
        """Level >= 2: the squared-norm partials summed and the loss
        averaged over the data axis (one all-reduce); else as given."""
        if self.level < 2 or not pm.distributed():
            return sq, loss
        box = torch.cat([sq.float().reshape(-1), loss.detach().float().reshape(1) / self.n])
        dist.all_reduce(box, group=self.group)
        return box[:-1], box[-1]

    def sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        if pm.distributed():
            t = t.clone()
            dist.all_reduce(t, group=self.group)
        return t

    def bind_optimizer(self, opt: Optional[torch.optim.Optimizer]) -> None:
        """Route a distance-adaptive optimizer's group sums over the data
        axis (ZeRO only: without it every rank sums every leaf)."""
        if opt is not None and self.level >= 1 and hasattr(opt, 'group_sum'):
            opt.group_sum = self.sum_over_data
            opt.sum_device = pm.comm_device()

    # --------------------------------------------------------- the pack ----
    def _exchange(self, leaves: Sequence[torch.Tensor]) -> None:
        """Every owner broadcasts its leaves into the others' (allocated
        here where released)."""
        for i, t in enumerate(leaves):
            shape, dtype = self.shapes[i]
            if tuple(t.shape) != shape:
                t.data = torch.empty(shape, dtype=dtype, device=t.device)
        for k in range(self.n):
            pm.broadcast_flat([t for i, t in enumerate(leaves) if self.owner[i] == k],
                              self.ranks[k], self.group)

    def after_update(self, leaves: Sequence[torch.Tensor]) -> None:
        """Levels 1 and 2: the owners' updated leaves to every rank."""
        if self.level in (1, 2) and self.n > 1:
            self._exchange(leaves)

    def gather(self, *trees: Sequence[torch.Tensor]) -> None:
        """Level 3: the released leaves of each leaf list whole again."""
        if self.level == 3 and self.n > 1:
            for leaves in trees:
                self._exchange(leaves)

    def release(self, *trees: Sequence[torch.Tensor]) -> None:
        """Level 3: drop the storage of the leaves this rank does not own."""
        if self.level == 3 and self.n > 1:
            for leaves in trees:
                for i, t in enumerate(leaves):
                    if not self.owns(i):
                        t.data = torch.empty(0, dtype=t.dtype, device=t.device)

    # ---------------------------------------------- the optimizer state ----
    def canonical_state(self, opt: torch.optim.Optimizer, full: Sequence[Sequence[int]]
                        ) -> Optional[Dict[str, Any]]:
        """A collective: the state dict one process's optimizer would have,
        on the main process (None elsewhere). ``full`` holds, per param
        group, the pack-leaf indices of the group's parameters."""
        local = opt.state_dict()
        mine, pos = {}, 0
        for g, members in enumerate(full):
            for li in members:
                if self.owns(li):
                    if pos in local['state']:
                        mine[li] = local['state'][pos]
                    pos += 1
        if self.level == 0 or self.n == 1:
            merged = mine
        else:
            merged = {}
            for part in pm.gather_to_host(mine, self.group):
                merged.update(part)
        if not pm.is_main_process():
            return None
        head = getattr(opt, 'GROUP_KEYS', ())
        state, groups, c = {}, [], 0
        for g, members in enumerate(full):
            index = {li: c + j for j, li in enumerate(members)}
            c += len(members)
            if head:
                # the group's estimate lives with its first parameter, as in one process
                got = next((merged[li] for li in members if li in merged
                            and head[-1] in merged[li]), None)
                for li in members:
                    if li in merged:
                        merged[li] = {k: v for k, v in merged[li].items() if k not in head}
                if got is not None:
                    merged.setdefault(members[0], {})
                    merged[members[0]] = {**{k: got[k] for k in head},
                                          **merged[members[0]]}
            for li in members:
                if li in merged:
                    state[index[li]] = merged[li]
            groups.append({**{k: v for k, v in local['param_groups'][g].items()
                              if k != 'params'}, 'params': list(index.values())})
        return {'state': dict(sorted(state.items())), 'param_groups': groups}

    def local_state(self, opt: torch.optim.Optimizer, full: Sequence[Sequence[int]],
                    canonical: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's share of a canonical state dict, for
        ``opt.load_state_dict``."""
        head = getattr(opt, 'GROUP_KEYS', ())
        state, groups, pos, c = {}, [], 0, 0
        for g, members in enumerate(full):
            own, first = [], True
            group_head = canonical['state'].get(c, {}) if members else {}
            for j, li in enumerate(members):
                if self.owns(li):
                    st = dict(canonical['state'].get(c + j, {}))
                    if head:
                        st = {k: v for k, v in st.items() if k not in head}
                        if first:
                            st = {**{k: group_head[k] for k in head if k in group_head}, **st}
                    if st:
                        state[pos] = st
                    own.append(pos)
                    pos += 1
                    first = False
            c += len(members)
            groups.append({**{k: v for k, v in canonical['param_groups'][g].items()
                              if k != 'params'}, 'params': own})
        return {'state': state, 'param_groups': groups}
