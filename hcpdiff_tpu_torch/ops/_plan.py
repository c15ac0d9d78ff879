"""What the launch plans of kernel J (``conv.py:conv_plan``) and kernels B
and C (``matmul.py:gemm_plan``) share: a grid of BM-row output tiles with K
split over blocks, what counts as a wave on the H100, and the fp32
workspace a split writes. Plain Python, so the CPU tests check the plans.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

BM = 128                        # output rows a block: two warpgroups of 64
SMS = 132                       # the H100's streaming multiprocessors
WAVE_FILL = 0.9                 # a grid of >= 90% of SMS blocks counts as a full wave


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A grid of (n_tiles, m_tiles, splits) blocks of BM x bn outputs of
    out[m, n], block z summing the K steps ``k_range(z)``. With splits > 1
    the blocks write fp32 partial sums to a workspace (``split_workspace``)
    and a second kernel adds them in split order and applies the epilogue."""
    bn: int
    splits: int
    m: int
    n: int
    ksteps: int

    @property
    def m_tiles(self) -> int:
        return -(-self.m // BM)

    @property
    def n_tiles(self) -> int:
        return -(-self.n // self.bn)

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    def k_range(self, z: int):
        """The K steps [start, stop) of split z, as the kernels compute them."""
        return z * self.ksteps // self.splits, (z + 1) * self.ksteps // self.splits

    @property
    def waste(self) -> int:
        """Columns of the last tile past n, whose tensor-core work is thrown away."""
        return self.n_tiles * self.bn - self.n

    @property
    def partial_columns(self) -> int:
        """Columns of a row of one split's partial sums."""
        return self.n


def split_workspace(plan: TilePlan, device) -> Optional[torch.Tensor]:
    """The fp32 [splits, m, partial_columns] partial sums a split plan
    writes (None for one split)."""
    if plan.splits == 1:
        return None
    return torch.empty(plan.splits * plan.m * plan.partial_columns, dtype=torch.float32,
                       device=device)
