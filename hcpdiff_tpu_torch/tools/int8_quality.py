"""Seconds a request and image quality of the w8a8 int8 route against bf16.

    python -m hcpdiff_tpu_torch.tools.int8_quality [--batch 4] [--size 512] [--steps 20]
        [--pairs 3] [--seed 0] [--out FILE]

The port's counterpart of ``tools_dev/int8_quality.py``. Builds SD1.5 at
full width in bf16 from a seed (as chip_smoke.py does) and a copy of its
UNet with ``int8=True`` (``HCP_INT8=1``'s route: kernels K and L in the
transformers) holding the same weights, then answers the same 20-step
DPM++ 2M request (the same prompt, seed, so the same latents and context)
through both, in turns (bf16, int8, int8, bf16, ...), ``--pairs`` times
each after a warm-up. It prints one JSON line a mode, with the card's name
and power limit: the request seconds (each, and the median), seconds an
image and, for int8, PSNR and SSIM of its images against the bf16 images
(``psnr``/``ssim``: ``tools_dev/deepcache_quality.py``'s, on [0, 1] images,
data range 1). The weights are random, so this measures the numerical
divergence the quantization introduces through the full-size UNet and the
real loop, not a trained model's perceptual quality. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..infer.pipeline import DiffusionPipeline
from .random_sd15 import build_sd15, unet_copy

PROMPT = 'a photo of a cat sitting on a wooden table, highly detailed'
NEGATIVE = 'blurry, low quality'


def psnr(a, b, data_range=2.0):
    import numpy as np
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float('inf')
    return 10.0 * np.log10(data_range ** 2 / mse)


def ssim(a, b, data_range=2.0):
    """Global mean SSIM, 7x7 uniform window per channel (standard
    constants K1=0.01, K2=0.03)."""
    import numpy as np
    from scipy.ndimage import uniform_filter
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    C1, C2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    vals = []
    for i in range(a.shape[0]):
        for c in range(a.shape[-1]):
            x, y = a[i, ..., c], b[i, ..., c]
            f = lambda t: uniform_filter(t, size=7)
            mx, my = f(x), f(y)
            vx = f(x * x) - mx * mx
            vy = f(y * y) - my * my
            cxy = f(x * y) - mx * my
            s = ((2 * mx * my + C1) * (2 * cxy + C2)) / (
                (mx * mx + my * my + C1) * (vx + vy + C2))
            vals.append(s.mean())
    return float(np.mean(vals))


def request(pipe: DiffusionPipeline, batch: int, size: int, steps: int, seed: int):
    """(images [B, size, size, 3] in [0, 1], seconds): one txt2img request,
    timed to its images on the host."""
    t0 = time.perf_counter()
    images = pipe.txt2img(PROMPT, NEGATIVE, width=size, height=size, num_steps=steps,
                          guidance_scale=7.5, sampler='dpm++_2m', seed=seed, batch_size=batch)
    return images, time.perf_counter() - t0


def compare(pipes, batch: int, size: int = 512, steps: int = 20, pairs: int = 3,
            seed: int = 0):
    """{'bf16': ..., 'int8': ...} for ``pipes`` with those keys: each mode's
    request seconds over ``pairs`` requests in turns (bf16 first in even
    pairs, int8 first in odd ones) after one warm-up request each, its
    images of the last pair, and for int8 PSNR and SSIM against bf16."""
    for mode in ('bf16', 'int8'):
        request(pipes[mode], batch, size, steps, seed)
    seconds = {'bf16': [], 'int8': []}
    images = {}
    for i in range(pairs):
        for mode in (('bf16', 'int8') if i % 2 == 0 else ('int8', 'bf16')):
            images[mode], s = request(pipes[mode], batch, size, steps, seed)
            seconds[mode].append(s)
    out = {}
    for mode in ('bf16', 'int8'):
        med = statistics.median(seconds[mode])
        out[mode] = {'mode': mode, 'batch': batch, 'size': size, 'steps': steps,
                     'seconds': seconds[mode], 'median_s': med, 's_per_image': med / batch,
                     'images': images[mode]}
    a, b = images['int8'], images['bf16']
    out['int8'].update(psnr_db=psnr(a, b, data_range=1.0), ssim=ssim(a, b, data_range=1.0),
                       speedup_vs_bf16=out['bf16']['median_s'] / out['int8']['median_s'])
    return out


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--batch', type=int, default=4)
    p.add_argument('--size', type=int, default=512)
    p.add_argument('--steps', type=int, default=20)
    p.add_argument('--pairs', type=int, default=3)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('int8_quality needs a CUDA card')
    device = torch.device('cuda', 0)
    unet, vae, te = build_sd15(device, args.seed)
    pipes = {'bf16': DiffusionPipeline(unet, vae, te),
             'int8': DiffusionPipeline(unet_copy(unet, device, int8=True), vae, te)}
    res = compare(pipes, args.batch, args.size, args.steps, args.pairs, args.seed)
    gpu = gpu_name_and_power_limit()
    lines = []
    for mode in ('bf16', 'int8'):
        line = {k: v for k, v in res[mode].items() if k != 'images'}
        line.update(gpu=gpu, finite=bool(np.isfinite(res[mode]['images']).all()))
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(lines, f, indent=1)
    return lines


if __name__ == '__main__':
    main()
