"""Warm-up before the first request (counterpart of
``hcpdiff_tpu/infer/aot.py``, which compiles the JAX denoise loops ahead
of time).

The port has no loop to compile; what its first request would pay is the
kernels' build (``ops/_build.py``: nvcc on the first launch), their plans,
cuDNN's algorithm choice and the allocator's growth. ``precompile`` runs
one txt2img request per setting, synchronizes and prints its seconds.
"""
from __future__ import annotations

import time
from typing import Iterable, Tuple

import torch


def precompile(pipe, settings: Iterable[Tuple[int, int, int, str]], guidance_scale: float = 7.5,
               batch_size: int = 1) -> None:
    """settings: (width, height, num_steps, sampler) each."""
    for (w, h, steps, sampler) in settings:
        t0 = time.perf_counter()
        pipe.txt2img('warmup', '', width=w, height=h, num_steps=steps,
                     guidance_scale=guidance_scale, sampler=sampler, seed=0,
                     batch_size=batch_size, return_latents=True)
        if pipe.device.type == 'cuda':
            torch.cuda.synchronize(pipe.device)
        print(f'[aot] {w}x{h} {sampler}/{steps} batch {batch_size}: '
              f'{time.perf_counter() - t0:.1f}s', flush=True)
