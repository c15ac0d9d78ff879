"""Where a LoRA training step's time goes on the card, for one checkout.

    python hcpdiff_tpu_torch/tools/profile_train.py [--tree DIR] [--steps 5] [--out FILE]

Builds chip_smoke.py's training run (SD1.5 at full width, frozen fp32 UNet
computing in bf16 with remat, LoRA rank 8, Min-SNR, AdamW, batch 8 of
[64, 64, 4] latents, seeded) with the ``hcpdiff_tpu_torch`` of the checkout
rooted at ``--tree`` (by default this one; chip_smoke.py is read from this
one), so two checkouts can be compared in turns (old, new, new, old), one
process each. Takes two warm-up steps, times ``--steps`` steps (host clock,
each ending when its loss reaches the host) and profiles one more with
``torch.profiler``. Prints the step seconds, the kernel time by family (ms
and launches a step, kernels E and F by name) and the device's idle share
(1 - kernel time / the median step time), and writes them as JSON to
--out. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
BWD_FAMILIES = (('flash_bwd_dq', 'E flash_attention_bwd_dq'),
                ('flash_bwd_dkv', 'F flash_attention_bwd_dkv'))


def kernel_families(prof, steps: int = 1) -> dict:
    """{family: {'ms', 'launches'}} of a ``torch.profiler`` run's device
    kernels, divided by ``steps``; the families of
    ``profile_txt2img.FAMILIES`` and E and F by name."""
    from hcpdiff_tpu_torch.tools.profile_txt2img import FAMILIES
    families = BWD_FAMILIES + tuple(FAMILIES)
    fams = {}
    for ev in prof.key_averages():
        us = getattr(ev, 'self_device_time_total', None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = next((f for key, f in families if key.lower() in ev.key.lower()), 'other')
        rec = fams.setdefault(fam, {'ms': 0.0, 'launches': 0})
        rec['ms'] += us / 1e3 / steps
        rec['launches'] += ev.count / steps
    return fams


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--tree', default=str(REPO))
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_train: needs a CUDA card')
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(REPO)]
    import chip_smoke as cs
    from hcpdiff_tpu_torch.ops import _build
    from hcpdiff_tpu_torch.tools.random_sd15 import clip_config
    from hcpdiff_tpu_torch.trainer.optimizers import make_optimizer
    from hcpdiff_tpu_torch.trainer.step import init_train_state
    if not Path(_build.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f'profile_train: imported {_build.__file__}, not the checkout at {tree}')
    _build.library()

    device = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    unet, te, overlay, scales, frozen, _ = cs.build_training(device, clip_config()[1])
    step = cs.make_step(unet, te, scales)
    state = init_train_state({'lora_unet': overlay},
                             make_optimizer('adamw', lr=1e-4, clip_norm=1.0, weight_decay=1e-4))
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 4)
    batch = {'latents': torch.randn(cs.TRAIN_BATCH, cs.TRAIN_LATENT, cs.TRAIN_LATENT, 4,
                                    generator=gen, device=device),
             'input_ids': torch.randint(0, cs.CLIP_VOCAB, (cs.TRAIN_BATCH, 77), generator=gen,
                                        device=device)}

    def one_step():
        nonlocal state
        t0 = time.perf_counter()
        state, m = step(state, frozen, batch, gen)
        float(m['loss'])                    # waits for the step
        return time.perf_counter() - t0

    for _ in range(2):
        one_step()
    secs = [one_step() for _ in range(args.steps)]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_step()
        torch.cuda.synchronize()
    fams = kernel_families(prof)
    median = statistics.median(secs)
    kernel_ms = sum(f['ms'] for f in fams.values())
    result = {'tree': args.tree, 'card': torch.cuda.get_device_name(0), 'step_s': secs,
              'median_s': median, 'kernel_ms': kernel_ms,
              'idle_share': 1.0 - kernel_ms / 1e3 / median,
              'launches': sum(f['launches'] for f in fams.values()),
              'families': dict(sorted(fams.items(), key=lambda kv: -kv[1]['ms']))}
    print(f'== {args.tree}: steps {[round(s, 4) for s in secs]} s, median {median:.4f} s; '
          f'kernel time {kernel_ms:.1f} ms, {result["launches"]} launches, '
          f'idle {result["idle_share"]:.1%}')
    for fam, f in result['families'].items():
        print(f'   {fam:28s} {f["ms"]:9.2f} ms {f["launches"]:6d} launches')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
