"""Where a step of the config-driven trainer's time goes on the card.

    python -m hcpdiff_tpu_torch.tools.profile_trainer [--model sd15|sdxl] [--steps 6]
        [--out FILE]

Runs chip_smoke.py's trainer phase set-up (the seeded SD1.5 directory in
F16, its 16 seeded PNGs in a 512x512 and a 640x448 bucket,
``cfgs/train/examples/lora_conventional.yaml`` at batch 4 with the latent
cache and remat; ``--model sdxl``: phase 4g's ``lora_sdxl.yaml`` at batch 1
on ``tools/random_sdxl.py:sdxl_world``, with 1024 px PNGs only, so every
step is a 1024x1024 one) through ``Trainer``: 4 warm-up steps, then
``--steps`` steps under ``torch.profiler``. Prints each profiled step's seconds (host
clock, each ending when its loss reaches the host; the first profiled
step has no start mark), the kernel time by family (ms and launches a
step) and the device's idle share (1 - kernel time a step / the median
step), and writes them as JSON to --out.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
WARM_UP = 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', choices=('sd15', 'sdxl'), default='sd15')
    ap.add_argument('--steps', type=int, default=6)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_trainer: needs a CUDA card')
    sys.path.insert(0, str(REPO))
    os.chdir(REPO)                        # the configs' relative template paths
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from hcpdiff_tpu_torch.config import load
    from hcpdiff_tpu_torch.tools.profile_train import kernel_families
    from hcpdiff_tpu_torch.tools.random_diffusers import write_dir
    from hcpdiff_tpu_torch.trainer.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix='hcp_profile_trainer_')
    try:
        model_dir, imgs = os.path.join(tmp, 'sd15'), os.path.join(tmp, 'imgs')
        device = torch.device('cuda', 0)
        if args.model == 'sdxl':
            from hcpdiff_tpu_torch.tools.random_sdxl import sdxl_world
            cs.write_dataset(imgs, ((1024, 1024),) * 4, cs.SEED + 50)
            src = 'data.dataset1.source.data_source1'
            trainer = Trainer(load('cfgs/train/examples/lora_sdxl.yaml', [
                f'exp_dir={os.path.join(tmp, "exp")}', f'{src}.img_root={imgs}',
                f'{src}.caption_file={imgs}/captions.json', 'data.dataset1.bucket.step_size=64',
                'train.save_step=1000']), world=sdxl_world(device, cs.SEED))
        else:
            write_dir(model_dir, 'sd15', cs.SEED, torch.float16, device)
            cs.write_dataset(imgs)
            argv = cs.train_args('lora_conventional.yaml', model_dir, os.path.join(tmp, 'exp'),
                                 imgs, 'train.save_step=1000')
            trainer = Trainer(load(argv[1], argv[2:]))
        trainer.train_steps = WARM_UP
        trainer.train()
        trainer.start_step, trainer.train_steps = WARM_UP, WARM_UP + args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train()
            torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ends = trainer.step_ends
    secs = [b - a for a, b in zip(ends, ends[1:])]
    fams = kernel_families(prof, args.steps)
    kernel_ms = sum(f['ms'] for f in fams.values())
    median = statistics.median(secs)
    result = {'card': torch.cuda.get_device_name(0), 'step_s': secs, 'median_s': median,
              'shapes': trainer.step_shapes, 'kernel_ms_a_step': kernel_ms,
              'idle_share': 1.0 - kernel_ms / 1e3 / median,
              'launches_a_step': sum(f['launches'] for f in fams.values()),
              'families': dict(sorted(fams.items(), key=lambda kv: -kv[1]['ms']))}
    print(f'== trainer steps {[round(s, 4) for s in secs]} s, median {result["median_s"]:.4f} '
          f's; kernel time {kernel_ms:.1f} ms and {result["launches_a_step"]:.0f} launches a '
          f'step; idle {result["idle_share"]:.1%}; card {result["card"]}, '
          f'{cs.gpu_name_and_power_limit()}')
    for fam, f in result['families'].items():
        print(f'   {fam:28s} {f["ms"]:9.2f} ms {f["launches"]:8.1f} launches')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
