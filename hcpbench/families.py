"""Kernel families by name, frozen from the program's
``utils/profiling.py:FAMILIES`` (PR 22's table), so that a rename in the
program does not move the benchmark's summary of where device time goes.
The first key found in a kernel's name, as CUPTI reports it, names its
family."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Tuple

FAMILIES = (
    ('flash_fwd_kernel', 'A flash_attention'),
    ('LnCfg<true', 'H ln_geglu'),
    ('LnCfg<false', 'G ln_qkv / I ln_dense'),
    ('Tile<true', 'B geglu_dense'),
    ('ffn_splitk_reduce<true', 'B geglu_dense'),
    ('Tile<false', 'C fused_dense'),
    ('ffn_splitk_reduce<false', 'C fused_dense'),
    ('conv3x3_', 'J conv3x3'),
    ('::gn_', 'D group_norm_silu'),
    ('layer_norm', 'LayerNorm'),
    ('conv', 'cuDNN convolutions'),
    ('fprop', 'cuDNN convolutions'),
    ('implicit_gemm', 'cuDNN convolutions'),
    ('nvjet', 'cuBLAS GEMMs'),
    ('gemm', 'cuBLAS GEMMs'),
    ('softmax', 'softmax'),
    ('elementwise', 'elementwise'),
    ('copy', 'copies'),
    ('cat', 'copies'),
)


def family(name: str) -> str:
    low = name.lower()
    return next((fam for key, fam in FAMILIES if key.lower() in low), 'other')


def by_family(ops: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """{family: seconds} of (kernel name, seconds) pairs, largest first."""
    out: Dict[str, float] = defaultdict(float)
    for name, secs in ops:
        out[family(name)] += secs
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
