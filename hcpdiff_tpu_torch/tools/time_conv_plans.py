"""Time kernel J under every launch plan it could take at the SD1.5 UNet's
conv shapes, beside the plan ``ops/conv.py:conv_plan`` picks and one
``F.conv2d`` call, to check and tune the plan on one card.

    python -m hcpdiff_tpu_torch.tools.time_conv_plans > result.json

For each resblock conv shape at UNet batch 8 (a batch-4 request under
CFG) and each column tile BN that divides Cout, with every split count
that could fill the grid (1 only where the unsplit grid has a wave), J is
checked against its plain version (ATOL 1e-2 + RTOL 1.6e-2) and timed
device-only: ITERS calls captured in a CUDA graph and replayed
(``time_kernels.py``'s method). Prints one JSON object with the card's
name and power limit and, per shape, the chosen plan's ms, every plan's
ms and F.conv2d's ms. Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import conv as cv
from .time_kernels import _graph_ms

# (size, Cin, Cout) of the UNet's resblock convs, one or two per level
SHAPES = ((64, 320, 320), (64, 960, 320), (32, 640, 640), (32, 1920, 640), (16, 640, 1280),
          (16, 1280, 1280), (16, 2560, 1280), (8, 1280, 1280), (8, 2560, 1280))
BATCH = 8
SPLITS = (1, 2, 3, 4, 6, 8)


def main() -> int:
    if not torch.cuda.is_available():
        print('time_conv_plans: no CUDA device', file=sys.stderr)
        return 2
    _build.library()
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device='cuda').manual_seed(0)
    cl = torch.channels_last
    results = {}
    with torch.inference_mode():
        for size, Cin, Cout in SHAPES:
            x = torch.randn(BATCH, Cin, size, size, device='cuda', generator=gen)
            x = x.to(torch.bfloat16).to(memory_format=cl)
            w = torch.randn(Cout, Cin, 3, 3, device='cuda', generator=gen) * (9 * Cin) ** -0.5
            w = w.to(torch.bfloat16).to(memory_format=cl)
            b = torch.randn(Cout, device='cuda', generator=gen).to(torch.bfloat16)
            ref = cv.conv3x3_plain(x, w, b).float()
            chosen = cv.conv_plan(BATCH, size, size, Cin, Cout)
            plans = {}
            for bn in cv.BN_CHOICES:
                if Cout % bn:
                    continue
                unsplit = cv.ConvPlan(bn, 1, chosen.m, chosen.n, chosen.ksteps)
                full = unsplit.blocks >= cv.WAVE_FILL * cv.SMS
                for splits in (1,) if full else SPLITS:
                    plan = cv.ConvPlan(bn, splits, chosen.m, chosen.n, chosen.ksteps)
                    err = (cv._launch(x, w, b, None, None, plan).float() - ref).abs()
                    if not bool((err <= 1e-2 + 1.6e-2 * ref.abs()).all()):
                        raise SystemExit(f'time_conv_plans: {plan} disagrees with the plain '
                                         f'version by {float(err.max())}')
                    plans[f'{bn}x{splits}'] = _graph_ms(
                        lambda plan=plan: cv._launch(x, w, b, None, None, plan))
            label = f'[{BATCH}, {Cin}, {size}, {size}] -> {Cout}'
            results[label] = {
                'plan': f'{chosen.bn}x{chosen.splits}',
                'plan_ms': plans[f'{chosen.bn}x{chosen.splits}'],
                'best': min(plans, key=plans.get), 'plans_ms': plans,
                'conv2d_ms': _graph_ms(lambda: torch.nn.functional.conv2d(x, w, b, padding=1))}
            print(f'{label}: {results[label]}', file=sys.stderr)
    print(json.dumps({'card': gpu, 'torch': torch.__version__, 'shapes': results}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
