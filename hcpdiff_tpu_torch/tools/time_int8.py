"""Kernel L's time under each tile it is built with, at every int8 product
of an SD1.5 512 px request.

    python -m hcpdiff_tpu_torch.tools.time_int8 [--batch 4] [--out FILE]

For each (M, K, N, epilogue) of ``int8_shapes(batch)`` it quantizes seeded
bf16 operands with kernel K, then times kernel L alone on those codes
under each tile of ``csrc/int8_gemm.cu``'s HCP_INT8_TILES (``INT8_TILES``:
one block an SM with a 4-stage ring, two with 3 stages), in turns (a, b, b,
a; 20 launches each between CUDA events, after a warm-up), and checks that
every tile's output equals the first's bitwise. It prints one JSON line:
the card's name and power limit and, per shape, the mean ms under each
tile and the tile the wrapper picks (``l_blocks_per_sm``). Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..ops import int8 as i8

# (S, C) of the SD1.5 UNet's transformer levels at 512 px: 64x64, 32x32,
# 16x16 and the 8x8 mid block
LEVELS = ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
CONTEXT_ROWS, CONTEXT_DIM = 77, 768


def int8_shapes(batch: int = 4):
    """(M, K, N, epilogue) of every int8 product of an SD1.5 512 px request
    at ``batch`` (a UNet batch of 2 * batch under CFG), levels 0-2 and the
    mid block: (M, C, C) proj_in, q/k/v, to_out and proj_out (with to_out's
    bias and residual), the cross-attention's k and v on the context rows,
    ff.proj (bias) and ff.out (bias and residual)."""
    b2 = 2 * batch
    out = []
    for S, C in LEVELS:
        for shape in ((b2 * S, C, C, 'bias+res'), (b2 * CONTEXT_ROWS, CONTEXT_DIM, C, 'none'),
                      (b2 * S, C, 8 * C, 'bias'), (b2 * S, 4 * C, C, 'bias+res')):
            if shape not in out:
                out.append(shape)
    return out


def _time(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@torch.inference_mode()
def time_tiles(batch: int = 4, seed: int = 0):
    """{label: {minb: ms, 'picked': minb}} for every shape of
    ``int8_shapes(batch)``."""
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, device='cuda', generator=gen) * scale).to(torch.bfloat16)

    tiles = sorted(i8.INT8_TILES)
    out = {}
    for M, K, N, epi in int8_shapes(batch):
        x, w = rn(M, K, scale=2.0), rn(N, K, scale=K ** -0.5)
        b = rn(N) if epi != 'none' else None
        res = rn(M, N) if epi == 'bias+res' else None
        xq, sx = i8.quantize_rows(x)
        wq, sw = i8.quantize_rows(w)
        outs = {t: i8.gemm_launch(xq, wq, sx, sw, b, res,
                                  torch.empty(M, N, dtype=torch.bfloat16, device='cuda'), t)
                for t in tiles}
        torch.cuda.synchronize()
        for t in tiles[1:]:
            if not torch.equal(outs[t], outs[tiles[0]]):
                raise RuntimeError(f'L at [{M}, {K}, {N}]: tile {t} differs from tile {tiles[0]}')
        y = outs[tiles[0]]
        times = {t: [] for t in tiles}
        for t in tiles + tiles[::-1]:
            times[t].append(_time(lambda t=t: i8.gemm_launch(xq, wq, sx, sw, b, res, y, t)))
        out[f'x [{M}, {K}], w [{N}, {K}], {epi}'] = {
            **{t: sum(v) / len(v) for t, v in times.items()}, 'picked': i8.l_blocks_per_sm(M, N)}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--batch', type=int, default=4)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('time_int8 needs a CUDA card')
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    res = {'gpu': gpu, 'tiles': {str(k): v for k, v in i8.INT8_TILES.items()},
           'ms': time_tiles(args.batch)}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == '__main__':
    main()
