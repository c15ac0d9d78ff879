"""Readings that the limits of a cell's check are set from, on the card:

    python3 hcpbench/controls.py --workload <cell> --seeds N [--first-seed S]
        [--requests R] [--variants program,int8] [--out FILE.jsonl]

For each seed, each variant builds the cell's program from the seed, warms
it up, runs ``--requests`` requests of the run's traffic (a short window at
the cell's own load) and hands what they produced to the cell's own check,
which reruns the plain fp32 reference. ``program`` is the program as the
configuration states it (the lower readings); ``int8`` is the program with
its own lower-precision path switched on (``UNet2DCondition(int8=True)``:
w8a8 products in the transformers), the control that the limits have to
fail (the upper readings). ``lowp`` is the control of a kind whose program
has no such path that runs (``train``: the int8 route raises under remat):
the kind's ``control``, the plain reference one precision below the
configuration's, put in the program's place. The faults of ``hcpbench/faults.py`` are
variants too (``--variants state_unchanged,...``). One JSON line a (seed,
variant), with the numbers compared, or the error of a variant that
crashed. The benchmark's own runs never run
this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def variant_kept(cell, name: str, seed: int, device, requests: int, session_kw: dict):
    """What the variant's run keeps for the check: the program's (planted
    with a fault, or with ``session_kw``) after ``requests`` units, or the
    kind's lower-precision control."""
    import contextlib
    import torch
    from hcpbench.faults import FAULTS, planted
    if name == 'lowp':
        return cell.kind.control(cell.config, cell.traffic, seed, device)
    kind = cell.traffic['kind']
    with planted(kind, name) if name in FAULTS[kind] else contextlib.nullcontext():
        session = cell.kind.Session(cell.config, cell.traffic, seed, device, {}, **session_kw)
        session.warm()
        for i in range(requests):
            session.unit(i)
        torch.cuda.synchronize()
        return session.finish()


def main(argv=None) -> int:
    import gc
    import torch
    from hcpbench.harness import Cell, load_json
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, default=3)
    ap.add_argument('--first-seed', type=int, default=1_000_003)
    ap.add_argument('--requests', type=int, default=1)
    ap.add_argument('--variants', default='program,int8')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('controls: needs a CUDA card', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    cell = Cell(load_json(ROOT / 'BENCHMARK.json'), args.workload)
    variants = {'program': {}, 'int8': {'int8': True}}
    out = open(args.out, 'a') if args.out else None
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        for name in args.variants.split(','):
            t = time.perf_counter()
            rec = {'workload': args.workload, 'seed': seed, 'variant': name}
            try:
                kept = variant_kept(cell, name, seed, device, args.requests,
                                    variants.get(name, {}))
                rec['program_s'] = time.perf_counter() - t
            except Exception as exc:  # a variant that crashes has failed and gives no number
                rec['error'] = repr(exc)[:500]
                kept = None
                gc.collect()
                torch.cuda.empty_cache()
            if 'error' not in rec:
                t = time.perf_counter()
                checks = cell.kind.check(kept, cell.config, cell.traffic, seed, device,
                                         cell.limits)
                rec.update(checks={n: v for n, v, _ in checks},
                           reference_s=time.perf_counter() - t)
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + '\n')
                out.flush()
    print(f'controls: {time.perf_counter() - T0:.1f} s', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.path[0] = str(ROOT)
    os.environ['USE_FLAX'] = '0'
    sys.exit(main())
