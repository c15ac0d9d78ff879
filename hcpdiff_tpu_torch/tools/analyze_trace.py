"""Where a traced run's time went, from a ``torch.profiler`` Chrome trace
(counterpart of ``hcpdiff_tpu/tools/analyze_trace.py``, which reads
jax.profiler traces):

    python -m hcpdiff_tpu_torch.tools.analyze_trace DIR [top_n]

Reads the newest ``*.pt.trace.json.gz`` or ``*.pt.trace.json`` under DIR
(what ``utils/profiling.py:trace`` writes), sums the durations of its
complete events (``ph == 'X'``) by lane and name, and prints the top N:
milliseconds, events, lane, kernel family and name. A lane is a process's
label and a thread's name: ``GPU 0 / stream 7`` for the kernels, copies
and memsets on a stream, ``CPU / thread N (python)`` for the host's ops.
Kernel names are kept whole (up to 120 characters) and given their family
by ``utils/profiling.py:family``, so the port's kernels show as A-J.
``by_family`` sums device rows by family (``profile_txt2img`` reads it).
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
from typing import Dict, List, Optional

from ..utils.profiling import family

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


def newest_trace(trace_dir: str) -> str:
    files = [f for pat in ('*.pt.trace.json', '*.pt.trace.json.gz')
             for f in glob.glob(os.path.join(trace_dir, '**', pat), recursive=True)]
    if not files:
        raise FileNotFoundError(f'no *.pt.trace.json[.gz] under {trace_dir}')
    return max(files, key=os.path.getmtime)


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
        return json.load(f)


def _lanes(events) -> Dict[tuple, str]:
    """{(pid, tid): 'process label / thread name'} from the metadata events."""
    procs, threads = {}, {}
    for e in events:
        if e.get('ph') != 'M':
            continue
        args = e.get('args', {})
        if e.get('name') == 'process_labels':
            procs[e['pid']] = args.get('labels')
        elif e.get('name') == 'process_name':
            procs.setdefault(e['pid'], args.get('name'))
        elif e.get('name') == 'thread_name':
            threads[(e['pid'], e['tid'])] = str(args.get('name', '')).strip()
    out = {}
    for (pid, tid), name in threads.items():
        out[(pid, tid)] = f'{procs.get(pid, pid)} / {name}'
    return out


def analyze(trace_dir: str, top_n: Optional[int] = 30) -> List[dict]:
    """The top ``top_n`` rows (None: all) {ms, events, lane, device (a
    kernel, copy or memset), family, name}, by time."""
    path = newest_trace(trace_dir)
    events = _load(path).get('traceEvents', [])
    lanes = _lanes(events)
    ms: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    device = set()
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        where = lanes.get((e.get('pid'), e.get('tid')), f'{e.get("pid")} / {e.get("tid")}')
        key = (where, str(e.get('name', '?'))[:120])
        ms[key] += float(e['dur']) / 1000.0
        count[key] += 1
        if e.get('cat') in DEVICE_CATEGORIES:
            device.add(key)
    return [{'ms': t, 'events': count[key], 'lane': key[0], 'device': key in device,
             'family': family(key[1]) if key in device else '', 'name': key[1]}
            for key, t in ms.most_common(top_n)]


def by_family(rows: List[dict]) -> Dict[str, dict]:
    """{family: {'ms', 'launches'}} of the device rows of ``analyze``,
    the most time first."""
    fams: Dict[str, dict] = {}
    for r in rows:
        if r['device']:
            fam = fams.setdefault(r['family'], {'ms': 0.0, 'launches': 0})
            fam['ms'] += r['ms']
            fam['launches'] += r['events']
    return dict(sorted(fams.items(), key=lambda kv: -kv[1]['ms']))


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('trace_dir')
    p.add_argument('top_n', nargs='?', type=int, default=30)
    a = p.parse_args(argv)
    rows = analyze(a.trace_dir, a.top_n)
    print(f'{"ms":>10} {"events":>7}  {"lane":<28} {"family":<22} name')
    for r in rows:
        print(f'{r["ms"]:10.3f} {r["events"]:7d}  {r["lane"][:28]:<28} {r["family"]:<22} '
              f'{r["name"]}')
    return rows


if __name__ == '__main__':
    main()
