"""Run some of chip_smoke.py's training-data phases alone, for one checkout,
to compare two versions of a phase on one card in the same conditions.

    python hcpdiff_tpu_torch/tools/smoke_phases.py [--tree DIR] PHASE [PHASE ...]

Imports ``chip_smoke`` and ``hcpdiff_tpu_torch`` from the checkout rooted at
``--tree`` (by default this one), so an older checkout unpacked beside it
runs its own phases; run one process per checkout, in turns (old, new, new,
old). Runs that checkout's ``build`` phase, writes its SD1.5 directory
(phase ``model dir``), then each named phase, ``<name>_phase(device,
model_dir, tmp)`` of its chip_smoke.py (``images``; ``jpeg`` in older
checkouts), with chip_smoke.py's own checks. Prints one JSON object: the
card's name and power limit and each phase's seconds. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--tree', default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument('phases', nargs='+')
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location('chip_smoke', tree / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print('smoke_phases: no CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    build = getattr(cs, 'build_all', None)
    if build is None:
        from hcpdiff_tpu_torch.ops import _build
        build = _build.library
    cs.phase('build', build)
    tmp = tempfile.mkdtemp(prefix='hcp_phases_')
    try:
        model_dir = cs.phase('model dir', cs.write_model_dir, device, tmp)
        for name in args.phases:
            cs.phase(name, getattr(cs, f'{name}_phase'), device, model_dir, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({'tree': str(tree), 'card': cs.gpu_name_and_power_limit(),
                      'seconds': {k: round(v, 3) for k, v in cs.PHASE_SECONDS.items()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
