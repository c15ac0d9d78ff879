"""Where a launch of kernels G, H and I spends its time: a copy of the
package whose ``csrc/ln_gemm_wgmma.cu`` has the first thread of each
warpgroup count ``clock64`` cycles by phase, run at the fused UNet's
shapes of a batch-4 request.

    python -m hcpdiff_tpu_torch.tools.ln_phases [--copy DIR] > phases.json

Copies ``hcpdiff_tpu_torch`` to ``--copy`` (default ``_tree_check/
ln_phases`` at the repository root, which .gitignore lists), inserts the
counters, builds that copy's kernels, and for each shape checks the kernel
against its plain version, times it device-only (CUDA-graph replay, as
``time_kernels.py``) and reads the counters of one more launch. Prints one
JSON object: per shape, the plan, the graph ms and, per phase, the median
and the largest over the warpgroups of the SM cycles it took:

    load      the block's rows of x landed in shared memory
    norm      their statistics and the normalized rows written
    loop      the main loop, all its column tiles (the rest are parts of it)
    wait      the steps' waits for their weight stage and the barrier
    mma       the steps' waits for their products (wgmma.wait_group)
    epilogue  the column tiles' epilogues, stores issued
    steps     K steps the block ran (a count, not cycles)

What the loop spends beyond wait, mma and epilogue is issuing the
products and the refills. The counters cost a few instructions a step.
Needs one CUDA card.
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
# (kernel, M, C): every transformer level of a batch-4 request
SHAPES = tuple((kind, 8 * S, C) for S, C in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
               for kind in 'GHI')
PHASES = ('load', 'norm', 'loop', 'wait', 'mma', 'epilogue', 'steps')
WORDS = 8                       # counter words a warpgroup
# (anchor line, code put before it, code put after it)
ANCHORS = (
    ('    extern __shared__ unsigned char smem_raw[];\n', '',
     '    long long ph_t0 = clock64(), ph_load = 0, ph_norm = 0, ph_mark = 0, ph_wait = 0,'
     ' ph_mma = 0, ph_epi = 0;\n'),
    ('    __syncthreads();                          // everyone\'s have\n', '',
     '    ph_load = clock64();\n'),
    ('    fence_proxy_async();                      // the rows, written by threads, to the '
     'tensor cores\n    __syncthreads();\n', '', '    ph_norm = clock64();\n'),
    ('        cp_async_wait<AHEAD - 1>();          // this thread\'s copies of stage i have '
     'landed\n', '        ph_mark = clock64();\n', ''),
    ('        __syncthreads();                     // everyone\'s have; every wgmma of step i - 1'
     ' is done\n', '', '        ph_wait += clock64() - ph_mark;\n'),
    ('        wgmma_wait<0>();                     // this warpgroup\'s products are done\n',
     '        ph_mark = clock64();\n', '        ph_mma += clock64() - ph_mark;\n'),
    ('            epilogue<T, OutT>(p, acc, stg, m0, tile_of(t));\n',
     '            ph_mark = clock64();\n', '            ph_epi += clock64() - ph_mark;\n'),
    ('    cp_async_wait<0>();\n}\n',
     '    if ((threadIdx.x & 127) == 0) {\n'
     '        unsigned long long* o = g_ln_phases + ((blockIdx.y * gridDim.x + blockIdx.x) * 2'
     ' + (threadIdx.x >> 7)) * %d;\n'
     '        o[0] = ph_load - ph_t0; o[1] = ph_norm - ph_load; o[2] = clock64() - ph_norm;\n'
     '        o[3] = ph_wait; o[4] = ph_mma; o[5] = ph_epi; o[6] = steps;\n'
     '    }\n' % WORDS, ''),
)
MAX_BLOCKS = 2048


def instrument(src: str) -> str:
    """ln_gemm_wgmma.cu with the counters and an entry point that copies them out."""
    anchor = 'struct LnParams {'
    src = src.replace(anchor, f'__device__ unsigned long long g_ln_phases[{MAX_BLOCKS} * 2 * '
                              f'{WORDS}];\n\n' + anchor, 1)
    for line, before, after in ANCHORS:
        if src.count(line) != 1:
            raise SystemExit(f'ln_phases: the kernel has no single line {line!r}; update ANCHORS')
        src = src.replace(line, before + line + after, 1)
    return src + ('\nextern "C" int hcp_ln_phases(void* out, int n) {\n'
                  '    return (int)cudaMemcpyFromSymbol(out, hcp::g_ln_phases, n * 8);\n}\n')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--copy', default=str(PKG.parent / '_tree_check' / 'ln_phases'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('ln_phases: no CUDA device', file=sys.stderr)
        return 2
    root = Path(args.copy).resolve()
    shutil.rmtree(root / PKG.name, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name, ignore=shutil.ignore_patterns('_build', '__pycache__'))
    cu = root / PKG.name / 'csrc' / 'ln_gemm_wgmma.cu'
    cu.write_text(instrument(cu.read_text()))
    for name in [m for m in sys.modules if m.split('.')[0] == PKG.name]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    build = importlib.import_module(f'{PKG.name}.ops._build')
    mm = importlib.import_module(f'{PKG.name}.ops.matmul')
    graph_ms = importlib.import_module(f'{PKG.name}.tools.time_kernels')._graph_ms
    lib = build.library()
    lib.hcp_ln_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device='cuda').manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, device='cuda', generator=gen) * scale).to(torch.bfloat16)

    out = {}
    with torch.inference_mode():
        for kind, M, C in SHAPES:
            x, g, b = rn(M, C), 1.0 + rn(C, scale=0.1), rn(C, scale=0.1)
            geglu = kind == 'H'
            ws = [rn(8 * C if geglu else C, C, scale=C ** -0.5)
                  for _ in range(3 if kind == 'G' else 1)]
            bias = rn(8 * C) if geglu else None
            n_out = 4 * C if geglu else C
            mode = mm._GEGLU if geglu else mm._DENSE

            def call():
                return mm._ln_launch(kind, mode, x, g, b, ws, bias, n_out, 1e-6)
            ref = (mm.ln_geglu_plain(x, g, b, ws[0], bias, 1e-6) if geglu
                   else torch.cat(mm.ln_qkv_plain(x, g, b, *ws, 1e-6), -1) if kind == 'G'
                   else mm.ln_dense_plain(x, g, b, ws[0], 1e-6)).float()
            err = float((torch.cat(call(), -1).float() - ref).abs().max())
            ms = graph_ms(call)
            call()
            torch.cuda.synchronize()
            plan = mm.ln_gemm_plan(geglu, len(ws), M, n_out, C)
            n = plan.blocks * 2 * WORDS
            words = (ctypes.c_ulonglong * n)()
            if lib.hcp_ln_phases(ctypes.addressof(words), n) != 0:
                raise SystemExit('ln_phases: reading the counters failed')
            recs = [[words[k * WORDS + i] for i in range(len(PHASES))]
                    for k in range(plan.blocks * 2)]
            cycles = {name: [r[i] for r in recs] for i, name in enumerate(PHASES)}
            out[f'{kind} x [{M}, {C}]'] = {
                'plan': str(plan), 'max_abs_err': err, 'graph_ms': ms,
                'cycles_median': {k: statistics.median(v) for k, v in cycles.items()},
                'cycles_max': {k: max(v) for k, v in cycles.items()}}
            print(f'{kind} x [{M}, {C}]: {out[f"{kind} x [{M}, {C}]"]}', file=sys.stderr)
    print(json.dumps({'card': gpu, 'torch': torch.__version__, 'shapes': out}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
