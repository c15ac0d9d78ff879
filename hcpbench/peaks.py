"""Published peaks of the cards the benchmark runs on: NVIDIA's data sheet
for the H100 SXM part, dense rates without sparsity, at its full power
limit of 700 W. A card not in the table gives no share of a peak."""
from __future__ import annotations

from typing import Optional

import torch

H100_SXM = {
    'flops': {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12},
    'bytes_per_s': 3.35e12,
}
PEAKS = {'NVIDIA H100 80GB HBM3': H100_SXM}


def peak(kind: str) -> Optional[dict]:
    return PEAKS.get(kind)


def bound_s(kind: str, flops: float, nbytes: float, dtype: torch.dtype) -> Optional[float]:
    """The least time the card could take: the larger of the operations
    over the dtype's peak and the bytes over the memory's."""
    p = peak(kind)
    if p is None or dtype not in p['flops']:
        return None
    return max(flops / p['flops'][dtype], nbytes / p['bytes_per_s'])
