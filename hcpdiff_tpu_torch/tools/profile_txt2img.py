"""Where a txt2img request's time goes on the card, for the default and the
fused-sublayer UNet.

    python -m hcpdiff_tpu_torch.tools.profile_txt2img [--batch 1 4] [--out FILE]

Builds SD1.5 at full width in bf16 from a seed (as chip_smoke.py does),
warms both pipelines up, then for each batch size times unprofiled
512x512, 20-step DPM++ 2M requests in turns (default, fused, fused,
default) and profiles one request of each with ``torch.profiler``. It
prints, per configuration, the request seconds, the kernel time by family
(ms and launches per request), the calls of kernel D's wrapper in the
profiled request, and the device's idle share (1 - kernel time / the
unprofiled request time), and writes them as JSON to --out.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..infer.pipeline import DiffusionPipeline
from ..ops.groupnorm import group_norm_silu
from .random_sd15 import build_sd15, fused_copy

PROMPT = 'a photo of a cat sitting on a wooden table, highly detailed'
NEGATIVE = 'blurry, low quality'
# kernel name (as CUPTI reports it) -> family; the first match wins
FAMILIES = (
    ('flash_fwd_kernel', 'A flash_attention'),
    ('Tile<true', 'B geglu_dense'),     # ffn_gemm_kernel<Tile<GEGLU, ..>, ..>
    ('ffn_splitk_reduce<true', 'B geglu_dense'),
    ('Tile<false', 'C fused_dense'),
    ('ffn_splitk_reduce<false', 'C fused_dense'),
    ('gemm_kernel<0', 'G ln_qkv / I ln_dense'),
    ('gemm_kernel<2', 'H ln_geglu'),
    ('conv3x3_', 'J conv3x3'),          # the wgmma kernel and its split-K sum
    ('::gn_', 'D group_norm_silu'),
    ('layer_norm', 'LayerNorm'),
    ('conv', 'cuDNN convolutions'),
    ('fprop', 'cuDNN convolutions'),
    ('implicit_gemm', 'cuDNN convolutions'),
    ('nvjet', 'cuBLAS GEMMs'),
    ('gemm', 'cuBLAS GEMMs'),
    ('softmax', 'softmax'),
    ('elementwise', 'elementwise'),
    ('copy', 'copies'),
    ('cat', 'copies'),
)


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key.lower() in low:
            return fam
    return 'other'


def build(device, seed: int):
    unet, vae, te = build_sd15(device, seed)
    return {'default': DiffusionPipeline(unet, vae, te),
            'fused': DiffusionPipeline(fused_copy(unet, device), vae, te)}


def request(pipe, batch: int, steps: int = 20):
    t0 = time.perf_counter()
    pipe.txt2img(PROMPT, NEGATIVE, width=512, height=512, num_steps=steps, guidance_scale=7.5,
                 sampler='dpm++_2m', seed=0, batch_size=batch)
    return time.perf_counter() - t0


def kernel_breakdown(pipe, batch: int):
    """Kernel time (ms) and launches by family over one profiled request,
    the top kernels, and the calls of kernel D's wrapper in that request."""
    from torch.profiler import ProfilerActivity, profile
    before = group_norm_silu.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        request(pipe, batch)
        torch.cuda.synchronize()
    d_calls = group_norm_silu.launches - before
    fams, names = {}, []
    for ev in prof.key_averages():
        us = getattr(ev, 'self_device_time_total', None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = fams.setdefault(family(ev.key), {'ms': 0.0, 'launches': 0})
        fam['ms'] += us / 1e3
        fam['launches'] += ev.count
        names.append((us / 1e3, ev.count, ev.key[:110], family(ev.key)))
    names.sort(reverse=True)
    return fams, names[:20], d_calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, nargs='+', default=[1, 4])
    ap.add_argument('--repeats', type=int, default=3)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_txt2img: needs a CUDA card')
    device = torch.device('cuda', 0)
    pipes = build(device, args.seed)
    for pipe in pipes.values():
        for batch in args.batch:
            request(pipe, batch, steps=2)
    result = {'card': torch.cuda.get_device_name(0), 'configs': {}}
    for batch in args.batch:
        secs = {name: [] for name in pipes}
        for _ in range(args.repeats):
            for name in ('default', 'fused', 'fused', 'default'):
                secs[name].append(request(pipes[name], batch))
        for name, pipe in pipes.items():
            fams, top, d_calls = kernel_breakdown(pipe, batch)
            median = statistics.median(secs[name])
            kernel_ms = sum(f['ms'] for f in fams.values())
            rec = {'request_s': secs[name], 'median_s': median, 'kernel_ms': kernel_ms,
                   'idle_share': 1.0 - kernel_ms / 1e3 / median,
                   'launches': sum(f['launches'] for f in fams.values()),
                   'group_norm_silu_calls': d_calls,
                   'families': dict(sorted(fams.items(), key=lambda kv: -kv[1]['ms'])),
                   'top_kernels': top}
            result['configs'][f'{name} batch {batch}'] = rec
            print(f'== {name} batch {batch}: requests {[round(s, 4) for s in secs[name]]} s, '
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
