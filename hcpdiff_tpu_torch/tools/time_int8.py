"""Kernel L's time at every int8 product of an SD1.5 512 px request, the
GEGLU L's at every ff.proj, beside their yardsticks.

    python -m hcpdiff_tpu_torch.tools.time_int8 [--batch 4] [--out FILE]

For each (M, K, N, epilogue) of ``int8_shapes(batch)`` it quantizes seeded
bf16 operands with kernel K, checks kernel L's output bitwise against
``int8_gemm_plain`` and times L alone on those codes, torch._int_mm (the
int32 product alone) and F.linear in bf16 on the same operands. At the
ff.proj shapes (bias, N = 8C) it also checks the GEGLU L against
``int8_geglu_gemm_plain`` (elements not bitwise equal, all within one bf16
ulp) and times it beside the route it replaces: L over [Wv; Wg], then
F.gelu of the gate half and the product, three launches. Each time is the
mean of 20 launches between CUDA events, after a warm-up, replayed from a
CUDA graph (``graph``: the device's time) and issued from Python
(``eager``: what a caller sees, host-bound under ~0.02 ms). It prints one
JSON line: the card's name and power limit and, per shape, those times in
ms. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

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
    ff.proj (bias; through the GEGLU L on the port's route) and ff.out
    (bias and residual)."""
    b2 = 2 * batch
    out = []
    for S, C in LEVELS:
        for shape in ((b2 * S, C, C, 'bias+res'), (b2 * CONTEXT_ROWS, CONTEXT_DIM, C, 'none'),
                      (b2 * S, C, 8 * C, 'bias'), (b2 * S, 4 * C, C, 'bias+res')):
            if shape not in out:
                out.append(shape)
    return out


def time_ms(fn, iters: int = 20):
    """{'graph': ms, 'eager': ms} of one call of fn, the mean of ``iters``."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return {'graph': start.elapsed_time(end) / iters, 'eager': eager}


def ulp_diff(out, ref):
    """(every element of ``out`` within one ulp of ``ref``'s dtype, bf16 or
    fp32; max |out - ref|; the elements not bitwise equal)."""
    bits = 7 if ref.dtype == torch.bfloat16 else 23
    o, r = out.double(), ref.double()
    _, e = torch.frexp(r.abs().clamp_min(2.0 ** -126))
    diff = (o - r).abs()
    ok = bool((diff <= torch.exp2((e - 1 - bits).double())).all())
    return ok, float(diff.max()), int((out != ref).sum())


@torch.inference_mode()
def time_shapes(batch: int = 4, seed: int = 0):
    """{label: {name: times}} for every shape of ``int8_shapes(batch)``;
    raises where a kernel disagrees with its plain version."""
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, device='cuda', generator=gen) * scale).to(torch.bfloat16)

    out = {}
    for M, K, N, epi in int8_shapes(batch):
        x, w = rn(M, K, scale=2.0), rn(N, K, scale=K ** -0.5)
        b = rn(N) if epi != 'none' else None
        res = rn(M, N) if epi == 'bias+res' else None
        xq, sx = i8.quantize_rows(x)
        wq, sw = i8.quantize_rows(w)
        y = torch.empty(M, N, dtype=torch.bfloat16, device='cuda')
        i8.gemm_launch(xq, wq, sx, sw, b, res, y)
        if not torch.equal(y, i8.int8_gemm_plain(xq, wq, sx, sw, torch.bfloat16, b, res)):
            raise RuntimeError(f'L at [{M}, {K}, {N}] differs from int8_gemm_plain')
        rec = {'L': time_ms(lambda: i8.gemm_launch(xq, wq, sx, sw, b, res, y)),
               'int_mm': time_ms(lambda: torch._int_mm(xq, wq.t())),
               'linear': time_ms(lambda: F.linear(x, w, b))}
        if epi == 'bias':
            yg = torch.empty(M, N // 2, dtype=torch.bfloat16, device='cuda')
            i8.gemm_launch(xq, wq, sx, sw, b, None, yg, geglu=True)
            ok, _, unequal = ulp_diff(yg, i8.int8_geglu_gemm_plain(xq, wq, sx, sw,
                                                                  torch.bfloat16, b))
            if not ok:
                raise RuntimeError(f'the GEGLU L at [{M}, {K}, {N}] differs from its plain '
                                   'version by more than one bf16 ulp')

            def three_step():
                h, gate = i8.gemm_launch(xq, wq, sx, sw, b, None, y).chunk(2, dim=-1)
                return h * F.gelu(gate)
            rec.update(geglu=time_ms(lambda: i8.gemm_launch(xq, wq, sx, sw, b, None, yg,
                                                            geglu=True)),
                       geglu_unequal=unequal, three_step=time_ms(three_step))
        out[f'x [{M}, {K}], w [{N}, {K}], {epi}'] = rec
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
    res = {'gpu': gpu, 'tile': [i8.L_BM, i8.L_BN, i8.L_BK, i8.L_STAGES],
           'ms': time_shapes(args.batch)}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == '__main__':
    main()
