"""Where kernel D's time goes inside one launch: a copy of the package whose
``csrc/groupnorm.cu`` has thread 0 of every block record ``%globaltimer``
and ``clock64`` at the kernel's phase boundaries, run at the main path's
shapes.

    python -m hcpdiff_tpu_torch.tools.gn_phases [--copy DIR] > phases.json

Copies ``hcpdiff_tpu_torch`` to ``--copy`` (default ``_tree_check/
gn_phases`` at the repository root, which .gitignore lists), inserts the
stamps, builds that copy's kernels, and for each shape checks D against its
plain version, times it device-only (CUDA-graph replay, as
``time_kernels.py``) and then reads the stamps of one more launch. Prints
one JSON object: per shape, the graph ms and, per phase, the median and the
largest over the blocks of the SM cycles it took:

    pass1     mbarrier set-up, the bulk copies, the per-channel sums
    write     the threads' sums into the scratch, and the block's wait
    groups    the block's group sums, written out
    arrive    the barrier's arrival (a releasing add)
    wait      the barrier's wait for the sample's other blocks
    partials  the sample's partial sums read and added
    stats     mean and rstd, and the block's wait
    affine    each thread's scale and shift
    pass2     the normalisation and the stores (not their completion)

The stamps cost a few global stores a block. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
# (B, S, C, silu): each regime and the smallest shape
SHAPES = ((8, 64, 1280, True), (8, 1024, 640, True), (8, 4096, 320, True),
          (8, 4096, 320, False), (8, 4096, 640, True), (4, 262144, 128, True))
PHASES = ('pass1', 'write', 'groups', 'arrive', 'wait', 'partials', 'stats', 'affine', 'pass2')
# stamp k goes before the source line starting with anchor (stamp 4 after
# the arrival); the phases run from stamp ORDER[i] to ORDER[i + 1]
ANCHORS = ((0, '    if (tid == 0) {\n        for (int s = 0; s < K; ++s) mbar_init'),
           (1, "    // The block's group sums, in a fixed order"),
           (2, '    float* out = partial'),
           (3, '    // The barrier: this block'),
           (5, '    // Every block of the sample reduces the same nb partials'),
           (6, '        if (g < G && p == 0) {\n            const double n'),
           (7, '    int g = g_first, left = g_left;'),
           (8, '    // Pass 2: position t'))
ARRIVED = '        red_add_release(bar_count, 1u);\n'
ORDER = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9)
SLOTS = 32                      # stamp words a block


def instrument(src: str) -> str:
    """groupnorm.cu with the stamps and an entry point that copies them out."""
    stamp = ('#define STAMP(k) if (tid == 0) { g_stamps[blockIdx.x * %d + 2 * (k)] = gtime(); '
             'g_stamps[blockIdx.x * %d + 2 * (k) + 1] = clock64(); }\n' % (SLOTS, SLOTS))
    head = ('__device__ unsigned long long g_stamps[1024 * %d];\n'
            '__device__ __forceinline__ unsigned long long gtime() {\n'
            '    unsigned long long t;\n'
            '    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));\n'
            '    return t;\n}\n' % SLOTS) + stamp
    anchor = 'constexpr int MAX_TX_BYTES'
    src = src.replace(anchor, head + anchor, 1)
    for k, line in ANCHORS:
        if line not in src:
            raise SystemExit(f'gn_phases: the kernel has no line {line!r}; update ANCHORS')
        src = src.replace(line, f'    STAMP({k})\n' + line, 1)
    if ARRIVED not in src:
        raise SystemExit(f'gn_phases: the kernel has no line {ARRIVED!r}')
    src = src.replace(ARRIVED, ARRIVED + '        STAMP(4)\n', 1)
    end = src.index('template <typename T, typename P>\nint launch(')
    close = src.rindex('}', 0, end)
    src = src[:close] + '    STAMP(9)\n' + src[close:]
    return src + ('\nextern "C" int hcp_gn_stamps(void* out, int n) {\n'
                  '    return (int)cudaMemcpyFromSymbol(out, hcp::g_stamps, n * 8);\n}\n')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--copy', default=str(PKG.parent / '_tree_check' / 'gn_phases'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('gn_phases: no CUDA device', file=sys.stderr)
        return 2
    root = Path(args.copy).resolve()
    shutil.rmtree(root / PKG.name, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name, ignore=shutil.ignore_patterns('_build', '__pycache__'))
    cu = root / PKG.name / 'csrc' / 'groupnorm.cu'
    cu.write_text(instrument(cu.read_text()))
    for name in [m for m in sys.modules if m.split('.')[0] == PKG.name]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    build = importlib.import_module(f'{PKG.name}.ops._build')
    gn = importlib.import_module(f'{PKG.name}.ops.groupnorm')
    graph_ms = importlib.import_module(f'{PKG.name}.tools.time_kernels')._graph_ms
    lib = build.library()
    lib.hcp_gn_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device='cuda').manual_seed(0)
    out = {}
    with torch.inference_mode():
        for B, S, C, silu in SHAPES:
            x = (torch.randn(B, S, C, device='cuda', generator=gen) * 3 + 1).bfloat16()
            sc = (torch.randn(C, device='cuda', generator=gen) * 0.2 + 1).bfloat16()
            bi = torch.randn(C, device='cuda', generator=gen).bfloat16()

            def call():
                return gn.group_norm_silu(x, sc, bi, 32, 1e-5, silu)
            ref = gn.group_norm_silu_plain(x, sc, bi, 32, 1e-5, silu).float()
            err = float((call().float() - ref).abs().max())
            ms = graph_ms(call)
            call()
            torch.cuda.synchronize()
            plan = gn.gn_plan(B, S, C, 2)
            words = (ctypes.c_ulonglong * (plan.grid * SLOTS))()
            if lib.hcp_gn_stamps(ctypes.addressof(words), plan.grid * SLOTS) != 0:
                raise SystemExit('gn_phases: reading the stamps failed')
            clocks = [[words[k * SLOTS + 2 * s + 1] for s in ORDER] for k in range(plan.grid)]
            cycles = {name: [c[i + 1] - c[i] for c in clocks] for i, name in enumerate(PHASES)}
            out[f'[{B}, {S}, {C}]{"" if silu else " no silu"}'] = {
                'plan': str(plan), 'max_abs_err': err, 'graph_ms': ms,
                'cycles_median': {k: statistics.median(v) for k, v in cycles.items()},
                'cycles_max': {k: max(v) for k, v in cycles.items()}}
    print(json.dumps({'card': gpu, 'torch': torch.__version__, 'shapes': out}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
