"""Time every kernel of the port (A-J) at the main paths' shapes, and A,
E and F also at the classic route's head dims, causal and not, in bf16,
for one checkout, to compare two versions on one card. B, C, G, H and I
are timed at every transformer level of a batch-4 request, beside
F.linear on the same products (labels "F.linear ..."), and D at every
GroupNorm shape of a batch-4 request (GN_SHAPES), of a batch-4 SDXL
request that the 512 px one lacks (SDXL_GN_SHAPES, labelled sdxl) and of
the VAE encode of an img2img request (ENC_GN_SHAPES, labelled enc, with A
at its mid-block's [1, 1, 4096, 512]), with
bf16 scale and bias as the model holds them, beside F.group_norm where
there is no SiLU.

    python hcpdiff_tpu_torch/tools/time_kernels.py [--tree DIR] > result.json

Imports ``hcpdiff_tpu_torch`` from the checkout rooted at ``--tree`` (by
default this one), so an older checkout unpacked beside it can be timed
with the same script; run one process per checkout, in turns (old, new,
new, old). Builds that checkout's kernels and, for each kernel and shape
(chip_smoke.py's), times the wrapper two ways with CUDA events over ITERS
calls after a warm-up: ``eager``, as chip_smoke.py times it (the host
issues every call, so a call shorter than the wrapper's host work measures
the host), and ``graph``, the same calls captured once in a CUDA graph and
replayed (the device's time alone). Prints one JSON object with the card's
name and power limit, the nvcc seconds of each source, each kernel
instance's ptxas registers and spill-store bytes, and the times in ms.
Needs one CUDA card.
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
# A, E and F at the classic route's head dims (B, H, S, D), causal and not;
# the D=160 heads take A at the main paths' shapes already, so only E, F
CLASSIC_SHAPES = [((2, 10, 4096, 64), True), ((2, 8, 4096, 128), True),
                  ((8, 8, 1024, 160), False), ((2, 1, 4096, 512), True)]
# (S, C) of the UNet's transformer levels: 64x64, 32x32, 16x16 and the 8x8 mid block
FFN_LEVELS = ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
# (B, S, C, silu) of every GroupNorm of a batch-4 512 px request: the UNet
# at batch 8 (CFG), with SiLU (resblocks, conv_norm_out) at every shape and
# without (the transformer blocks' norms) at its 4 levels; the VAE decoder
# at batch 4, with SiLU, and without at its mid-block attention
GN_UNET = ((4096, 320), (4096, 640), (4096, 960), (1024, 320), (1024, 640), (1024, 960),
           (1024, 1280), (1024, 1920), (256, 640), (256, 1280), (256, 1920), (256, 2560),
           (64, 1280), (64, 2560))
GN_VAE = ((4096, 512), (16384, 512), (65536, 512), (65536, 256), (262144, 256),
          (262144, 128))
GN_SHAPES = ([(8, S, C, True) for S, C in GN_UNET] + [(4, S, C, True) for S, C in GN_VAE]
             + [(8, S, C, False) for S, C in FFN_LEVELS] + [(4, 4096, 512, False)])
# the same for a batch-4 SDXL request at 1024 px, where no 512 px request
# has the shape: the UNet's resblocks at 128x128, 64x64 and 32x32 (with
# the skip concatenations) and its transformer norms at 64x64 and 32x32;
# the VAE decoder's resblocks up to 1024x1024 and its mid-block attention
SDXL_GN_SHAPES = ((8, 16384, 320, True), (8, 16384, 640, True), (8, 16384, 960, True),
                  (8, 4096, 1280, True), (8, 4096, 1920, True), (8, 1024, 2560, True),
                  (8, 4096, 640, False), (8, 1024, 1280, False),
                  (4, 1024 * 1024, 128, True), (4, 1024 * 1024, 256, True),
                  (4, 512 * 512, 512, True), (4, 16384, 512, False))
# the VAE encoder's GroupNorms on one 512 px image (img2img and inpaint),
# labelled enc: its resblocks at 512, 256, 128 and 64 px (with SiLU) and
# its mid-block attention (without)
ENC_GN_SHAPES = ((1, 512 * 512, 128, True), (1, 256 * 256, 128, True),
                 (1, 256 * 256, 256, True), (1, 128 * 128, 256, True),
                 (1, 128 * 128, 512, True), (1, 4096, 512, True), (1, 4096, 512, False))


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


def _graph_ms(fn):
    """ITERS calls captured in one CUDA graph, replayed and timed."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                        # warm-up outside the capture (plans, allocator)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _ptxas_counts(build_log: Path):
    """{kernel instance (mangled name): (registers, spill store bytes)} from
    the build's ptxas output."""
    counts, entry, spill = {}, None, None
    for line in build_log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r'(\d+) bytes spill stores', line)
        if m:
            spill = int(m.group(1))
        m = re.search(r'Used (\d+) registers', line)
        if m and entry is not None:
            counts[entry] = (int(m.group(1)), spill)
            entry = None
    return counts


def _cases(gen):
    """{label: call} at chip_smoke.py's main-path shapes, bf16."""
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    from hcpdiff_tpu_torch.ops import matmul as mm
    from hcpdiff_tpu_torch.ops.conv import conv3x3
    from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, device='cuda', generator=gen) * scale).to(torch.bfloat16)

    cases = {}
    for shape, enc in (((4, 8, 4096, 40), ''), ((4, 8, 1024, 80), ''), ((2, 1, 4096, 512), ''),
                       ((1, 1, 4096, 512), 'enc ')):
        q, k, v = rn(*shape), rn(*shape), rn(*shape)
        cases[f'{enc}A {list(shape)}'] = lambda q=q, k=k, v=v: fa.flash_attention(q, k, v)
    for shape in ((8, 8, 4096, 40), (8, 8, 1024, 80)):
        q, k, v, do = (rn(*shape) for _ in range(4))
        sc = shape[-1] ** -0.5
        o, lse = fa.flash_attention_lse(q, k, v, sc)
        bwd = (q, k, v, lse, do, fa.attention_delta(o, do), sc)
        cases[f'A+lse {list(shape)}'] = lambda q=q, k=k, v=v, sc=sc: fa.flash_attention_lse(
            q, k, v, sc)
        cases[f'E {list(shape)}'] = lambda bwd=bwd: fa.flash_attention_bwd_dq(*bwd)
        cases[f'F {list(shape)}'] = lambda bwd=bwd: fa.flash_attention_bwd_dkv(*bwd)
    for shape, fwd in CLASSIC_SHAPES:
        q, k, v, do = (rn(*shape) for _ in range(4))
        sc = shape[-1] ** -0.5
        for causal in (False, True):
            label = f'{list(shape)}' + (' causal' if causal else '')
            # an lse from the plain version: a checkout whose kernels refuse
            # this shape still times the others
            o, lse = fa.attention_plain(q, k, v, sc, causal), fa.attention_lse_plain(q, k, sc, causal)
            bwd = (q, k, v, lse, do, fa.attention_delta(o, do), sc, causal)
            if fwd and (shape[-1] != 512 or causal):    # A at [2,1,4096,512] is a main-path shape
                cases[f'A {label}'] = lambda q=q, k=k, v=v, sc=sc, c=causal: fa.flash_attention(
                    q, k, v, sc, c)
            if fwd:
                cases[f'A+lse {label}'] = (lambda q=q, k=k, v=v, sc=sc, c=causal:
                                           fa.flash_attention_lse(q, k, v, sc, c))
            cases[f'E {label}'] = lambda bwd=bwd: fa.flash_attention_bwd_dq(*bwd)
            cases[f'F {label}'] = lambda bwd=bwd: fa.flash_attention_bwd_dkv(*bwd)
    # B and C (+ the block residual) at every transformer level of a batch-4
    # request (x [8S, C] w [8C, C]; x [8S, 4C] w [C, 4C]), C without one at
    # proj_in's [32768, 320] x [320, 320]; F.linear on each product beside them
    linear = torch.nn.functional.linear
    for S, C in FFN_LEVELS:
        M = 8 * S
        x, w, b = rn(M, C), rn(8 * C, C, scale=C ** -0.5), rn(8 * C)
        cases[f'B x [{M}, {C}]'] = lambda a=(x, w, b): mm.geglu_dense(*a)
        cases[f'F.linear B x [{M}, {C}]'] = lambda a=(x, w, b): linear(*a)
        x, w, b = rn(M, 4 * C), rn(C, 4 * C, scale=(4 * C) ** -0.5), rn(C)
        cases[f'C x [{M}, {4 * C}] +res'] = lambda a=(x, w, b, rn(M, C)): mm.fused_dense(*a)
        cases[f'F.linear C x [{M}, {4 * C}]'] = lambda a=(x, w, b): linear(*a)
    args = (rn(32768, 320), rn(320, 320, scale=320 ** -0.5), rn(320))
    cases['C x [32768, 320]'] = lambda args=args: mm.fused_dense(*args)
    cases['F.linear C x [32768, 320]'] = lambda args=args: linear(*args)
    for (B, S, C, silu), sdxl in ([(s, '') for s in GN_SHAPES]
                                  + [(s, 'sdxl ') for s in SDXL_GN_SHAPES]
                                  + [(s, 'enc ') for s in ENC_GN_SHAPES]):
        x = rn(B, S, C, scale=3.0) + 1.0
        sc, bi = rn(C, scale=0.2) + 1.0, rn(C)
        cases[f'{sdxl}D [{B}, {S}, {C}]{"" if silu else " no silu"}'] = (
            lambda args=(x, sc, bi, 32, 1e-5, silu): group_norm_silu(*args))
        if not silu:
            cases[f'{sdxl}F.group_norm [{B}, {S}, {C}]'] = (
                lambda x=x, sc=sc, bi=bi: torch.nn.functional.group_norm(
                    x.transpose(1, 2), 32, sc, bi, 1e-5))
    # G, H and I at every transformer level of a batch-4 request (x [8S, C];
    # G: wq/wk/wv [C, C], H: w [8C, C], I: w [C, C]), F.linear beside each on
    # the same product (G's three weights as one [3C, C])
    for S, C in FFN_LEVELS:
        M = 8 * S
        x, g, b = rn(M, C), 1.0 + rn(C, scale=0.1), rn(C, scale=0.1)
        ws = [rn(C, C, scale=C ** -0.5) for _ in range(3)]
        w2, b2 = rn(8 * C, C, scale=C ** -0.5), rn(8 * C)
        wqkv = torch.cat(ws)
        cases[f'G x [{M}, {C}]'] = lambda x=x, g=g, b=b, ws=ws: mm.ln_qkv(x, g, b, *ws, 1e-6)
        cases[f'F.linear G x [{M}, {C}]'] = lambda a=(x, wqkv): linear(*a)
        cases[f'H x [{M}, {C}]'] = lambda x=x, g=g, b=b, w=w2, bb=b2: mm.ln_geglu(
            x, g, b, w, bb, 1e-6)
        cases[f'F.linear H x [{M}, {C}]'] = lambda a=(x, w2, b2): linear(*a)
        cases[f'I x [{M}, {C}]'] = lambda x=x, g=g, b=b, w=ws[0]: mm.ln_dense(x, g, b, w, 1e-6)
        cases[f'F.linear I x [{M}, {C}]'] = lambda a=(x, ws[0]): linear(*a)
    cl = torch.channels_last
    for B, Cin, H, Cout in ((8, 320, 64, 320), (8, 960, 64, 320), (8, 640, 32, 640),
                            (8, 1280, 16, 1280), (8, 2560, 16, 1280), (8, 1280, 8, 1280),
                            (8, 2560, 8, 1280)):
        args = (rn(B, Cin, H, H).to(memory_format=cl),
                rn(Cout, Cin, 3, 3, scale=(9 * Cin) ** -0.5).to(memory_format=cl), rn(Cout))
        cases[f'J [{B}, {Cin}, {H}, {H}] -> {Cout}'] = lambda args=args: conv3x3(*args)
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument('--only', default='',
                    help='comma-separated label prefixes to time (e.g. "A ,A+lse"); all if empty')
    args = ap.parse_args()
    only = tuple(p for p in args.only.split(',') if p)
    if not torch.cuda.is_available():
        print('time_kernels: no CUDA device', file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from hcpdiff_tpu_torch.ops import _build
    if not Path(_build.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f'time_kernels: imported {_build.__file__}, not the checkout at {tree}')
    _build.library()
    nvcc = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'== (\S+) \(rc \d+, ([0-9.]+) s\)', (_build.BUILD_DIR / 'build.log').read_text())}
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    times = {}
    with torch.inference_mode():
        for label, fn in _cases(torch.Generator(device='cuda').manual_seed(0)).items():
            if only and not label.startswith(only):
                continue
            try:
                times[label] = {'eager': _time_ms(fn)}
            except (RuntimeError, ValueError) as e:   # a shape this checkout's kernels refuse
                times[label] = {'eager': None, 'graph': None, 'error': str(e)[:200]}
                continue
            try:
                times[label]['graph'] = _graph_ms(fn)
            except RuntimeError as e:           # a wrapper this checkout cannot capture
                times[label]['graph'] = None
                times[label]['graph_error'] = str(e)[:200]
    print(json.dumps({'tree': args.tree, 'card': gpu, 'torch': torch.__version__,
                      'nvcc_seconds': nvcc,
                      'ptxas': _ptxas_counts(_build.BUILD_DIR / 'build.log'), 'ms': times}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
