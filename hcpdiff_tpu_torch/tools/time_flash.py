"""Time the attention kernels A, A with lse, E and F of one checkout of the
port, to compare two versions on one card.

    python hcpdiff_tpu_torch/tools/time_flash.py [--tree DIR] > result.json

Imports ``hcpdiff_tpu_torch`` from the checkout rooted at ``--tree`` (by
default this one), so an older checkout unpacked beside it can be timed
with the same script; run one process per checkout, in turns (old, new,
new, old). Builds that checkout's kernels, then times each kernel with CUDA
events (ITERS launches after one warm-up) on seeded bf16 inputs at the
main paths' shapes (txt2img and LoRA training, D=40/80) and at the classic
route's (D=64/128/160), causal and not. Prints one JSON object with the
card's name and power limit, the checkout's ptxas register and spill
counts of the flash kernels, and the times in ms. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ITERS = 20
# (B, H, S, D) and whether the case has a forward record (the D=160 heads
# take A already; their backward is what the classic shapes add)
SHAPES = [((4, 8, 4096, 40), True), ((4, 8, 1024, 80), True), ((8, 8, 4096, 40), True),
          ((8, 8, 1024, 80), True), ((2, 10, 4096, 64), True), ((2, 8, 4096, 128), True),
          ((8, 8, 1024, 160), False)]


def _time_ms(fn):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _ptxas_counts(build_log: Path):
    """{'kernel<template arguments>': (registers, spill store bytes)} of the
    flash kernels, from the build's ptxas output."""
    counts, entry, spill = {}, None, None
    for line in build_log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if 'flash' in m.group(1) else None
            continue
        if entry is None:
            continue
        m = re.search(r'(\d+) bytes spill stores', line)
        if m:
            spill = int(m.group(1))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            name = re.search(r'\d+(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(.*?)EEv', entry)
            targs = ', '.join(re.findall(r'L[ib](\d+)E', name.group(2)))
            counts[f'{name.group(1)}<{targs}>'] = (int(m.group(1)), spill)
            entry = None
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('time_flash: no CUDA device', file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from hcpdiff_tpu_torch.ops import _build
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    if not Path(fa.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f'time_flash: imported {fa.__file__}, not the checkout at {tree}')
    _build.library()
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device='cuda').manual_seed(0)
    times = {}
    for shape, fwd in SHAPES:
        q, k, v, do = (torch.randn(*shape, device='cuda', generator=gen).to(torch.bfloat16)
                       for _ in range(4))
        scale = shape[-1] ** -0.5
        for causal in (False, True):
            o, lse = fa.flash_attention_lse(q, k, v, scale, causal)
            bwd = (q, k, v, lse, do, fa.attention_delta(o, do), scale, causal)
            cases = {'E': lambda: fa.flash_attention_bwd_dq(*bwd),
                     'F': lambda: fa.flash_attention_bwd_dkv(*bwd)}
            if fwd:
                cases = {'A': lambda: fa.flash_attention(q, k, v, scale, causal),
                         'A+lse': lambda: fa.flash_attention_lse(q, k, v, scale, causal),
                         **cases}
            label = f'{list(shape)}' + (' causal' if causal else '')
            times[label] = {name: _time_ms(fn) for name, fn in cases.items()}
    print(json.dumps({'tree': args.tree, 'card': gpu, 'torch': torch.__version__,
                      'ptxas': _ptxas_counts(_build.BUILD_DIR / 'build.log'), 'ms': times}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
