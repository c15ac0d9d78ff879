"""Where a txt2img request's time goes on the card, for the default and the
fused-sublayer UNet.

    python -m hcpdiff_tpu_torch.tools.profile_txt2img [--model sd15|sdxl] [--batch 1 4]
        [--out FILE]

Builds SD1.5 (512x512, the default and the fused-sublayer UNet) or SDXL
(1024x1024, the default UNet only) at full width in bf16 from a seed (as
chip_smoke.py does), warms the pipelines up, then for each batch size
times unprofiled 20-step DPM++ 2M requests in turns (default, fused,
fused, default) and traces one request of each (``utils/profiling.py:trace``,
summed by ``analyze_trace``). It
prints, per configuration, the request seconds, the kernel time by family
(ms and launches per request), the calls of kernel D's wrapper in the
profiled request, and the device's idle share (1 - kernel time / the
unprofiled request time), and writes them as JSON to --out.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import tempfile
import time

import torch

from ..infer.pipeline import DiffusionPipeline
from ..ops.groupnorm import group_norm_silu
from ..utils.profiling import trace
from .analyze_trace import analyze, by_family
from .random_sd15 import build_sd15, fused_copy
from .random_sdxl import build_sdxl

PROMPT = 'a photo of a cat sitting on a wooden table, highly detailed'
NEGATIVE = 'blurry, low quality'
# --model: its image size
MODELS = {'sd15': 512, 'sdxl': 1024}


def build(model: str, device, seed: int):
    if model == 'sdxl':
        unet, vae, te = build_sdxl(device, seed)
        return {'default': DiffusionPipeline(unet, vae, te)}
    unet, vae, te = build_sd15(device, seed)
    return {'default': DiffusionPipeline(unet, vae, te),
            'fused': DiffusionPipeline(fused_copy(unet, device), vae, te)}


def request(pipe, batch: int, size: int, steps: int = 20):
    t0 = time.perf_counter()
    pipe.txt2img(PROMPT, NEGATIVE, width=size, height=size, num_steps=steps,
                 guidance_scale=7.5, sampler='dpm++_2m', seed=0, batch_size=batch)
    return time.perf_counter() - t0


def kernel_breakdown(pipe, batch: int, size: int):
    """Kernel time (ms) and launches by family over one request traced by
    ``utils/profiling.py:trace`` and read by ``analyze_trace``, the top
    kernels, and the calls of kernel D's wrapper in that request."""
    log_dir = tempfile.mkdtemp(prefix='hcp_profile_txt2img_')
    before = group_norm_silu.launches
    with trace(log_dir):
        request(pipe, batch, size)
    d_calls = group_norm_silu.launches - before
    rows = [r for r in analyze(log_dir, None) if r['device']]
    shutil.rmtree(log_dir, ignore_errors=True)
    top = [(r['ms'], r['events'], r['name'][:110], r['family']) for r in rows[:20]]
    return by_family(rows), top, d_calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', choices=sorted(MODELS), default='sd15')
    ap.add_argument('--batch', type=int, nargs='+', default=[1, 4])
    ap.add_argument('--repeats', type=int, default=3)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_txt2img: needs a CUDA card')
    device = torch.device('cuda', 0)
    size = MODELS[args.model]
    pipes = build(args.model, device, args.seed)
    for pipe in pipes.values():
        for batch in args.batch:
            request(pipe, batch, size, steps=2)
    result = {'card': torch.cuda.get_device_name(0), 'model': args.model, 'size': size,
              'configs': {}}
    for batch in args.batch:
        secs = {name: [] for name in pipes}
        for _ in range(args.repeats):
            for name in list(pipes) + list(pipes)[::-1]:
                secs[name].append(request(pipes[name], batch, size))
        for name, pipe in pipes.items():
            fams, top, d_calls = kernel_breakdown(pipe, batch, size)
            median = statistics.median(secs[name])
            kernel_ms = sum(f['ms'] for f in fams.values())
            rec = {'request_s': secs[name], 'median_s': median, 'kernel_ms': kernel_ms,
                   'idle_share': 1.0 - kernel_ms / 1e3 / median,
                   'launches': sum(f['launches'] for f in fams.values()),
                   'group_norm_silu_calls': d_calls,
                   'families': fams,
                   'top_kernels': top}
            result['configs'][f'{name} batch {batch}'] = rec
            print(f'== {args.model} {name} batch {batch}: requests {[round(s, 4) for s in secs[name]]} s, '
                  f'median {median:.4f} s; kernel time {kernel_ms:.1f} ms, '
                  f'{rec["launches"]} launches ({d_calls} group_norm_silu calls), '
                  f'idle {rec["idle_share"]:.1%}')
            for fam, f in rec['families'].items():
                print(f'   {fam:24s} {f["ms"]:9.2f} ms {f["launches"]:6d} launches '
                      f'{f["ms"] / kernel_ms:6.1%}')
            for ms, n, key, fam in top[:8]:
                print(f'     {ms:8.2f} ms {n:5d}x [{fam}] {key}')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
