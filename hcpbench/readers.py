"""Arithmetic the per-layer readers (``hcpbench/metrics/<name>.py``) share.
Each returns None where it finds nothing to read, and the harness then
leaves the metric out of the result line."""
from __future__ import annotations

import statistics
from typing import Optional

import torch

from hcpbench.peaks import bound_s, peak


def roofline_share(obs, entry: str) -> Optional[float]:
    """The summed roofline bound of the entry's calls in the profiled
    requests over the device seconds of the kernels launched inside its
    range, in percent; None where the entry was not called, no kernel ran
    in its range, or the card or a call's dtype has no peak in the table."""
    calls = obs.calls.get(entry)
    if not calls or obs.trace is None:
        return None
    device_s = obs.trace['ranges'].get('hcpbench.' + entry, {}).get('device_s', 0.0)
    bounds = [bound_s(obs.kind, f, b, dt) for f, b, dt in calls]
    if device_s <= 0 or any(b is None for b in bounds):
        return None
    return 100.0 * sum(bounds) / device_s


def idle_pct(obs) -> Optional[float]:
    """1 - the device's busy seconds a unit of work over the host's seconds
    a unit, percent: the busy seconds (the union of kernel, copy and memset
    intervals) from the profiled units, the host's seconds from the observed
    units that follow them, which run without the profiler. The profiler
    slows the host's side of the units it traces, so the traced window's own
    idle share (``device.busy_s`` over ``device.window_s``) reads higher."""
    if obs.trace is None or not obs.traced_units or not obs.observed_units:
        return None
    busy = obs.trace['busy_s'] / obs.traced_units
    return 100.0 * (1.0 - busy / (obs.observed_s / obs.observed_units))


def mfu(obs, dtype: torch.dtype = torch.bfloat16) -> Optional[float]:
    """Model operations of the observed part's completed work over its
    seconds times the card's peak in ``dtype``, percent."""
    p = peak(obs.kind)
    if p is None or obs.observed_s <= 0 or not obs.observed_units:
        return None
    return 100.0 * obs.unit_flops * obs.observed_units / obs.observed_s / p['flops'][dtype]


def mean(obs, key: str) -> Optional[float]:
    values = obs.spans.get(key)
    return statistics.fmean(values) if values else None
