"""Profiling hooks (counterpart of ``hcpdiff_tpu/utils/profiling.py``):
``trace`` records a ``torch.profiler`` trace, ``StepTimer`` times steps
on the host, ``family`` names the kernel family of a device event.

    with trace('runs/trace'):
        ...                       # the work to trace
    # python -m hcpdiff_tpu_torch.tools.analyze_trace runs/trace

``trace`` records the CPU activity and, where a card is present, the CUDA
activity (kernels, copies and memsets on their streams, through CUPTI),
and writes one Chrome trace, ``<host>_<pid>.<ns>.pt.trace.json.gz``, into
``log_dir`` when the block ends (Perfetto and TensorBoard's profiler
plugin read it). The CPU activity slows the host's side of the traced
work (~3x for a txt2img request); take times from untraced runs.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch

# kernel name (as CUPTI reports it) -> family; the first match wins
FAMILIES = (
    ('flash_fwd_kernel', 'A flash_attention'),
    ('LnCfg<true', 'H ln_geglu'),       # ln_proj_kernel<LnCfg<GEGLU, ..>, ..>
    ('LnCfg<false', 'G ln_qkv / I ln_dense'),
    ('Tile<true', 'B geglu_dense'),     # ffn_gemm_kernel<Tile<GEGLU, ..>, ..>
    ('ffn_splitk_reduce<true', 'B geglu_dense'),
    ('Tile<false', 'C fused_dense'),
    ('ffn_splitk_reduce<false', 'C fused_dense'),
    ('conv3x3_', 'J conv3x3'),          # the wgmma kernel and its split-K sum
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
    """The family of a device event's name (``'other'`` if none)."""
    low = name.lower()
    for key, fam in FAMILIES:
        if key.lower() in low:
            return fam
    return 'other'


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[object]:
    """Profile the block; yields the ``torch.profiler.profile`` object.
    ``log_dir`` defaults to ``hcp_torch_trace`` under the temporary
    directory."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), 'hcp_torch_trace')
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir, use_gzip=True)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


class StepTimer:
    """EMA-smoothed step timing on the host's clock (no device sync)."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self.ema_ms: Optional[float] = None
        self._t0 = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = (now - self._t0) * 1000.0
        self._t0 = now
        self.ema_ms = dt if self.ema_ms is None else (
            self.smoothing * self.ema_ms + (1 - self.smoothing) * dt)
        return dt

    @property
    def steps_per_sec(self) -> float:
        return 1000.0 / self.ema_ms if self.ema_ms else 0.0
