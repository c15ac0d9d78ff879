"""One run of one cell: set-up, warm-up, the measured window, the per-layer
readings of a traced run, and the check against the plain reference.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration file, its traffic mix in
``hcpbench/traffic/<traffic>.json``, the driver of that mix's kind in
``hcpbench/kinds/<kind>.py``, the limits of its check in
``hcpbench/limits/<cell>.json`` and each per-layer metric's reader in
``hcpbench/metrics/<metric>.py``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

from hcpbench import nojax
from hcpbench.entries import patched
from hcpbench.trace import Profiled

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Refused(Exception):
    """A run that must print no result; the message says why."""


def load_module(path: Path) -> ModuleType:
    if not path.is_file():
        raise LookupError(f'{path} does not exist')
    name = f'hcpbench_{path.parent.name}_' + path.stem.replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise LookupError(f'{path} does not exist')
    return json.loads(path.read_text())


def applies(metric: dict, workload: str) -> bool:
    return workload in metric.get('workloads', [workload])


class Cell:
    """A cell of ``bench`` and the files it names: the configuration's path
    relative to ``root``, the traffic mix and the limits under ``data``."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT, data: Path = HERE):
        cells = {w['name']: w for w in bench['workloads']}
        if workload not in cells:
            raise LookupError(f'unknown workload {workload!r} (known: {sorted(cells)})')
        self.spec = cells[workload]
        self.name = workload
        configs = {c['name']: c for c in bench['configs']}
        self.config = load_json(root / configs[self.spec['config']]['file'])
        self.traffic = load_json(data / 'traffic' / f"{self.spec['traffic']}.json")
        self.limits = load_json(data / 'limits' / f'{workload}.json')
        self.kind = load_module(HERE / 'kinds' / f"{self.traffic['kind']}.py")
        self.end_to_end = [m for m in bench['end_to_end'] if applies(m, workload)]
        self.per_layer = [m for m in bench['per_layer'] if applies(m, workload)]

    def readers(self) -> Dict[str, ModuleType]:
        return {m['name']: load_module(HERE / 'metrics' / f"{m['name']}.py")
                for m in self.per_layer}


class Observations:
    """What the per-layer readers read: the reduced trace of the profiled
    requests, the entry calls counted in them, and the host timings and
    completed work of the observed part that follows."""

    def __init__(self, kind: str, unit_flops: int):
        self.kind = kind
        self.unit_flops = unit_flops
        self.trace: Optional[dict] = None
        self.calls: Dict[str, list] = defaultdict(list)
        self.spans: Dict[str, list] = {}
        self.traced_units = 0
        self.observed_units = 0
        self.observed_s = 0.0


def timed(fn, index: int) -> dict:
    start = time.perf_counter()
    try:
        units, ok = fn(index), True
    except Exception as exc:  # a failed request or step counts as failed, the run goes on
        print(f'hcpbench: unit {index} failed: {exc!r}', file=sys.stderr)
        units, ok = 0, False
    return {'start': start, 'end': time.perf_counter(), 'units': units, 'ok': ok}


def device_line() -> str:
    try:
        return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,power.draw,clocks.sm,'
                               'temperature.gpu', '--format=csv,noheader'],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f'nvidia-smi: {exc!r}'


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t0: float, session_kw: Optional[dict] = None) -> dict:
    """The run; returns the result line's object (keys in the printed
    order, ``checks`` last)."""
    phases: Dict[str, float] = {'import_torch_s': time.perf_counter() - t0}
    readers = cell.readers() if trace else {}
    session = cell.kind.Session(cell.config, cell.traffic, seed, device, phases,
                                **(session_kw or {}))
    t = time.perf_counter()
    session.warm()
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
    phases['warmup_s'] = time.perf_counter() - t
    if nojax.loaded():
        raise Refused(f'modules of JAX or the JAX package loaded: {nojax.loaded()}')
    kind = torch.cuda.get_device_name(device) if cuda else 'cpu'
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    print('hcpbench: set-up phases ' + json.dumps({**phases, 'setup_s': setup_s}),
          file=sys.stderr)

    obs = Observations(kind, session.unit_flops())
    records: List[dict] = []
    start = time.perf_counter()
    deadline = start + seconds
    if trace:
        entries = [t for r in readers.values() for t in getattr(r, 'TARGETS', [])]
        names = sorted({'hcpbench.' + t[2] for t in entries})
        with Profiled(names) as prof, patched(entries, obs.calls), session.ranges():
            for _ in range(cell.traffic.get('trace_units', 1)):
                records.append(timed(session.unit, len(records)))
        obs.trace = prof.result
        obs.traced_units = sum(r['units'] for r in records)
        if obs.trace is not None:
            print('hcpbench: device seconds by kernel family over the profiled units '
                  + json.dumps(obs.trace['families']), file=sys.stderr)
        with session.observe(obs.spans):
            t = time.perf_counter()
            while time.perf_counter() < deadline or obs.observed_units == 0:
                rec = timed(session.unit, len(records))
                records.append(rec)
                obs.observed_units += rec['units']
            if cuda:
                torch.cuda.synchronize()
            obs.observed_s = time.perf_counter() - t
    else:
        while time.perf_counter() < deadline:
            records.append(timed(session.unit, len(records)))
    if cuda:            # the window ends when the last unit's work has
        torch.cuda.synchronize()
        records[-1]['end'] = time.perf_counter()
    window_s = records[-1]['end'] - start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    print(f'hcpbench: window {window_s:.4f} s, {len(records)} units, '
          f'{sum(r["units"] for r in records)} done; peak {peak / 2 ** 30:.3f} GiB; '
          f'{device_line() if cuda else "cpu"}', file=sys.stderr)

    if trace:
        values = {name: r.read(obs) for name, r in readers.items()}
        metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
                   for m in cell.per_layer if values.get(m['name']) is not None}
    else:
        values = dict(cell.kind.end_to_end(records, window_s), setup_s=setup_s)
        metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
                   for m in cell.end_to_end}
    kept = session.finish()
    del session
    checks = cell.kind.check(kept, cell.config, cell.traffic, seed, device, cell.limits)
    failed = sum(not r['ok'] for r in records)
    correct = failed == 0 and all(
        lim is not None and not math.isnan(v) and v <= lim for _, v, lim in checks)
    dev = {'platform': 'gpu' if cuda else 'cpu', 'kind': kind, 'count': 1,
           'memory_peak_bytes': peak}
    out = {'correct': correct, 'attempted': len(records), 'failed': failed, 'metrics': metrics,
           'device': dev}
    if trace and obs.trace is not None:
        dev.update(busy_s=obs.trace['busy_s'], window_s=obs.trace['window_s'])
        out['breakdown'] = {'device_ops': obs.trace['device_ops'],
                            'idle_gaps': obs.trace['idle_gaps']}
    out['checks'] = {name: {'value': v, 'limit': lim} for name, v, lim in checks}
    return out


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog='hcpbench/run.py', description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    try:
        cell = Cell(load_json(ROOT / 'BENCHMARK.json'), args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.spec['chips']:
            raise Refused(f'needs {cell.spec["chips"]} CUDA card(s), found '
                          f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device('cuda', 0), t0)
    except (Refused, LookupError) as exc:
        print(f'hcpbench: {exc}', file=sys.stderr)
        return 2
    bad = nojax.loaded()
    if bad:
        print(f'hcpbench: modules of JAX or the JAX package loaded: {bad}', file=sys.stderr)
        return 3
    for name, c in out['checks'].items():
        print(f'hcpbench check {name}: {c["value"]!r} (limit {c["limit"]!r})', file=sys.stderr)
    print(json.dumps(out))
    return 0
