"""The traced part of a run: ``torch.profiler`` over CPU and CUDA, the
benchmark's own host ranges, and the reduction of the Chrome trace to what
the per-layer metrics and ``breakdown`` read.

Ranges are ``torch.profiler.record_function`` spans named ``hcpbench.*``,
opened by the benchmark's wrappers around the calls into each layer
(``Ranges``). From the trace:

- device activity is every kernel, copy and memset; ``busy_s`` is the
  union of their intervals inside the window range, ``window_s`` its
  length;
- a range's device seconds are those of the kernels whose launch (the
  runtime call that carries the kernel's correlation id) lies inside one
  of that range's spans on the same host thread;
- an idle gap is a stretch of the window with no device activity, named
  by the innermost ``hcpbench.*`` span open on the host when it began.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from hcpbench.families import by_family

WINDOW = 'hcpbench.window'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')


class Ranges:
    """Host ranges opened and closed by hooks (a forward pre-hook and its
    post-hook), kept on a stack per name."""

    def __init__(self):
        self._open: Dict[str, list] = defaultdict(list)

    def enter(self, name: str) -> None:
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        self._open[name].append(rf)

    def exit(self, name: str) -> None:
        self._open[name].pop().__exit__(None, None, None)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Spans:
    """The spans of one range name on one thread, for point lookups."""

    def __init__(self, spans: List[Tuple[float, float]]):
        self.spans = sorted(spans)
        self.starts = [a for a, _ in self.spans]

    def covers(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.spans[i][1] >= t


def reduce_trace(trace: dict, range_names: List[str], top: int = 10) -> Optional[dict]:
    """What the metrics read from one Chrome trace: window and busy seconds,
    each range's device seconds and span count, the device operations that
    took most time, and the longest idle gaps with their host range. None
    when the trace has no window or no device activity in it."""
    events = [e for e in trace.get('traceEvents', []) if e.get('ph') == 'X']
    windows = [e for e in events if e.get('cat') == 'user_annotation' and e['name'] == WINDOW]
    if not windows:
        return None
    w0 = float(windows[0]['ts'])
    w1 = w0 + float(windows[0]['dur'])
    device = [e for e in events if e.get('cat') in DEVICE_CATS
              and w0 <= float(e['ts']) <= w1]
    if not device:
        return None
    busy = union([(float(e['ts']), min(float(e['ts']) + float(e['dur']), w1)) for e in device])
    busy_us = sum(b - a for a, b in busy)

    # host spans of the benchmark's ranges, by (name, thread)
    notes = [e for e in events if e.get('cat') == 'user_annotation'
             and e['name'].startswith('hcpbench.')]
    spans: Dict[Tuple[str, object], List[Tuple[float, float]]] = defaultdict(list)
    for e in notes:
        spans[(e['name'], e.get('tid'))].append((float(e['ts']), float(e['ts']) + float(e['dur'])))
    launch = {}
    for e in events:
        if e.get('cat') in LAUNCH_CATS and 'correlation' in e.get('args', {}):
            launch[e['args']['correlation']] = (float(e['ts']), e.get('tid'))
    lookup = {key: Spans(v) for key, v in spans.items()}
    ranges = {}
    for name in range_names:
        secs, n = 0.0, sum(len(v) for (nm, _), v in spans.items() if nm == name)
        for e in device:
            src = launch.get(e.get('args', {}).get('correlation'))
            spans_here = lookup.get((name, src[1])) if src is not None else None
            if spans_here is not None and spans_here.covers(src[0]):
                secs += float(e['dur']) / 1e6
        ranges[name] = {'device_s': secs, 'spans': n}

    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e['name']] += float(e['dur']) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    device_ops = [(k[:160], v) for k, v in ranked[:top]]

    main_tid = windows[0].get('tid')
    main = sorted(((float(e['ts']), float(e['ts']) + float(e['dur']), e['name']) for e in notes
                   if e.get('tid') == main_tid), key=lambda s: (s[0], -s[1]))
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    def label(t: float) -> str:
        inner = WINDOW
        for a, b, name in main:
            if a > t:
                break
            if b >= t:
                inner = name      # later starts are nested deeper
        return inner
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle_gaps = [[label(a), (b - a) / 1e6] for a, b in longest]
    return {'window_s': (w1 - w0) / 1e6, 'busy_s': busy_us / 1e6, 'ranges': ranges,
            'device_ops': [[k, v] for k, v in device_ops], 'idle_gaps': idle_gaps,
            'families': by_family(ranked)}


class Profiled:
    """``with Profiled(range_names) as p:`` profiles the block (CPU, and CUDA
    where a card is present) inside the window range; ``p.result`` is
    ``reduce_trace`` of it. The trace file goes under the temporary
    directory and is deleted once read."""

    def __init__(self, range_names: List[str]):
        self.range_names = range_names
        self.result: Optional[dict] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.window = torch.profiler.record_function(WINDOW)
        self.window.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window.__exit__(None, None, None)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix='.json', prefix='hcpbench_trace_')
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.result = reduce_trace(json.load(f), self.range_names)
        finally:
            os.remove(path)
        return False
