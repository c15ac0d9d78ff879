"""Time kernel J (the 3x3 conv), kernels B and C (the feed-forward GEMMs)
and kernel D (GroupNorm) under the launch plans they could take at the
SD1.5 paths' shapes, beside the plan their planner picks
(``ops/conv.py:conv_plan``, ``ops/matmul.py:gemm_plan``,
``ops/groupnorm.py:gn_plan``) and one PyTorch call on the same inputs
(F.conv2d; F.linear, the product alone; F.group_norm without SiLU), to
check and tune the plans on one card.

    python -m hcpdiff_tpu_torch.tools.time_plans [--only conv|gemm|gn] > result.json

Shapes: J at every resblock conv of UNet batch 8 (a batch-4 request under
CFG); B, and C with the block residual, at every transformer level of a
batch-4 request, the batch-1 shapes whose grids are short of a wave, and C
without a residual at proj_in's [32768, 320] x [320, 320] and at the mid
block's proj [512, 1280] x [1280, 1280]; D at every GroupNorm shape of a
batch-4 request (``time_kernels.GN_SHAPES``), under chunks of about 16,
32 and 64 KB, at the planned blocks a sample and half of them. Plans
(``candidates``) of J, B and C: every
built tile whose BN divides the output columns, unsplit and, where the
unsplit grid is short of a wave, at every split the kernel takes (J: the
counts in CONV_SPLITS); B and C also at split 2 where the grid is full.
Each plan is checked against the plain version (ATOL 1e-2 + RTOL 1.6e-2)
and timed device-only: ITERS calls captured in a CUDA graph and replayed
(``time_kernels.py``'s method). Prints one JSON object with the card's
name and power limit and, per shape, the chosen plan's ms, every plan's
ms and the library call's ms. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..ops import _build, _plan
from ..ops import conv as cv
from ..ops import groupnorm as gn
from ..ops import matmul as mm
from .time_kernels import GN_SHAPES, _graph_ms

# (size, Cin, Cout) of the UNet's resblock convs, one or two per level
CONV_SHAPES = ((64, 320, 320), (64, 960, 320), (32, 640, 640), (32, 1920, 640),
               (16, 640, 1280), (16, 1280, 1280), (16, 2560, 1280), (8, 1280, 1280),
               (8, 2560, 1280))
CONV_BATCH = 8
CONV_SPLITS = (1, 2, 3, 4, 6, 8)
# (kind, M, K, weight rows): B is x [M, C] w [8C, C]; C is x [M, 4C] w [C, 4C]
# with the residual; 'C proj' is x [M, C] w [C, C] without one
GEMM_SHAPES = (('B', 32768, 320, 2560), ('B', 8192, 640, 5120), ('B', 2048, 1280, 10240),
               ('B', 512, 1280, 10240), ('B', 128, 1280, 10240),
               ('C', 32768, 1280, 320), ('C', 8192, 2560, 640), ('C', 2048, 5120, 1280),
               ('C', 512, 5120, 1280), ('C', 128, 5120, 1280),
               ('C proj', 32768, 320, 320), ('C proj', 512, 1280, 1280))


def _short(plan) -> bool:
    return plan.blocks < _plan.WAVE_FILL * _plan.SMS


# kernel D's plans beside the chosen one: chunks of about these bytes, and
# half the blocks a sample
GN_CHUNK_BYTES = (16384, 32768, 65536)


def plan_name(plan) -> str:
    """J: BN x splits, e.g. '160x2'; B, C: BN/blocks an SM x splits,
    '160/2x1'; D: blocks a sample, chunk rows and slots, '16b/52r/5s'."""
    if isinstance(plan, mm.GemmPlan):
        return f'{plan.bn}/{plan.per_sm}x{plan.splits}'
    if isinstance(plan, gn.GnPlan):
        return f'{plan.blocks}b/{plan.chunk_rows}r/{plan.slots}s'
    return f'{plan.bn}x{plan.splits}'


def conv_chosen(size, Cin, Cout):
    return cv.conv_plan(CONV_BATCH, size, size, Cin, Cout)


def gemm_chosen(kind, M, K, rows):
    geglu = kind == 'B'
    return mm.gemm_plan(geglu, M, rows // 2 if geglu else rows, K)


def candidates(chosen) -> list:
    """The plans timed beside ``chosen`` (a ConvPlan, a GemmPlan or a
    GnPlan), the chosen one among them."""
    if isinstance(chosen, gn.GnPlan):
        p = chosen
        plans = {gn.gn_plan(p.B, p.S, p.C, p.itemsize, p.groups, chunk_bytes=cb, blocks=nb)
                 for cb in GN_CHUNK_BYTES for nb in (p.blocks, max(1, p.blocks // 2))}
        return sorted(plans | {chosen}, key=plan_name)
    gemm = isinstance(chosen, mm.GemmPlan)
    if gemm:
        tiles = [(bn, per_sm) for g, bn, per_sm in mm.GEMM_TILES if g == chosen.geglu]
        splits = range(1, min(mm.MAX_SPLITS, chosen.ksteps) + 1)
    else:
        tiles, splits = [(bn, None) for bn in cv.BN_CHOICES], CONV_SPLITS

    def make(bn, per_sm, s):
        if gemm:
            return mm.GemmPlan(bn, s, chosen.m, chosen.n, chosen.ksteps, chosen.geglu, per_sm)
        return cv.ConvPlan(bn, s, chosen.m, chosen.n, chosen.ksteps)

    plans = []
    for bn, per_sm in tiles:
        if chosen.n % bn:
            continue
        short = _short(make(bn, per_sm, 1))
        tried = splits if short else ((1, 2) if gemm else (1,))
        plans += [make(bn, per_sm, s) for s in tried if s <= chosen.ksteps]
    if chosen not in plans:
        plans.append(chosen)
    return plans


def _time(chosen, launch, ref, library):
    """Check every candidate plan of ``chosen`` against ``ref``, time it,
    and time the library call."""
    plans = {}
    for plan in candidates(chosen):
        err = (launch(plan).float() - ref).abs()
        if not bool((err <= 1e-2 + 1.6e-2 * ref.abs()).all()):
            raise SystemExit(f'time_plans: {plan} disagrees with the plain version by '
                             f'{float(err.max())}')
        plans[plan_name(plan)] = _graph_ms(lambda plan=plan: launch(plan))
    return {'plan': plan_name(chosen), 'plan_ms': plans[plan_name(chosen)],
            'best': min(plans, key=plans.get), 'plans_ms': plans,
            'library_ms': None if library is None else _graph_ms(library)}


def _conv_results(gen):
    cl = torch.channels_last
    for size, Cin, Cout in CONV_SHAPES:
        x = torch.randn(CONV_BATCH, Cin, size, size, device='cuda', generator=gen)
        x = x.to(torch.bfloat16).to(memory_format=cl)
        w = torch.randn(Cout, Cin, 3, 3, device='cuda', generator=gen) * (9 * Cin) ** -0.5
        w = w.to(torch.bfloat16).to(memory_format=cl)
        b = torch.randn(Cout, device='cuda', generator=gen).to(torch.bfloat16)
        result = _time(conv_chosen(size, Cin, Cout),
                       lambda plan: cv._launch(x, w, b, None, None, plan),
                       cv.conv3x3_plain(x, w, b).float(),
                       lambda: torch.nn.functional.conv2d(x, w, b, padding=1))
        yield f'J [{CONV_BATCH}, {Cin}, {size}, {size}] -> {Cout}', 'F.conv2d', result


def _gemm_results(gen):
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, device='cuda', generator=gen) * scale).to(torch.bfloat16)

    for kind, M, K, rows in GEMM_SHAPES:
        geglu = kind == 'B'
        n_out = rows // 2 if geglu else rows
        x, w, b = rn(M, K), rn(rows, K, scale=K ** -0.5), rn(rows)
        res = rn(M, n_out) if kind == 'C' else None
        mode = mm._GEGLU if geglu else mm._DENSE if res is None else mm._DENSE_RES
        ref = (mm.geglu_dense_plain(x, w, b) if geglu
               else mm.fused_dense_plain(x, w, b, res)).float()
        result = _time(gemm_chosen(kind, M, K, rows),
                       lambda plan: mm._launch(kind, mode, x, w, b, res, n_out, plan),
                       ref, lambda: torch.nn.functional.linear(x, w, b))
        yield f'{kind} x [{M}, {K}] w [{rows}, {K}]', 'F.linear', result


def _gn_results(gen):
    for B, S, C, silu in GN_SHAPES:
        x = (torch.randn(B, S, C, device='cuda', generator=gen) * 3.0 + 1.0).to(torch.bfloat16)
        sc = (torch.randn(C, device='cuda', generator=gen) * 0.2 + 1.0).to(torch.bfloat16)
        bi = torch.randn(C, device='cuda', generator=gen).to(torch.bfloat16)
        library = None if silu else (
            lambda: torch.nn.functional.group_norm(x.transpose(1, 2), 32, sc, bi, 1e-5))
        result = _time(gn.gn_plan(B, S, C, 2),
                       lambda plan: gn._launch(x, sc, bi, 32, 1e-5, silu, plan),
                       gn.group_norm_silu_plain(x, sc, bi, 32, 1e-5, silu).float(), library)
        yield (f'D [{B}, {S}, {C}]{"" if silu else " no silu"}',
               None if silu else 'F.group_norm', result)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--only', choices=('conv', 'gemm', 'gn'),
                    help='time only J, only B and C, or only D')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('time_plans: no CUDA device', file=sys.stderr)
        return 2
    _build.library()
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device='cuda').manual_seed(0)
    families = [f for key, f in (('conv', _conv_results), ('gemm', _gemm_results),
                                 ('gn', _gn_results)) if args.only in (None, key)]
    results = {}
    with torch.inference_mode():
        for family in families:
            for label, library, result in family(gen):
                results[label] = {**result, 'library': library}
                print(f'{label}: {results[label]}', file=sys.stderr)
    print(json.dumps({'card': gpu, 'torch': torch.__version__, 'shapes': results}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
