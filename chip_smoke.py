"""Smoke run of the PyTorch port (hcpdiff_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA GPU (written for the H100, sm_90a) and the CUDA toolkit's
nvcc; it builds the port's kernels from hcpdiff_tpu_torch/csrc at first use.
It exits non-zero, printing no result, when there is no CUDA device or the
package is missing. Phases, each fatal on failure:

1. build the kernels (seconds printed);
2. build SD1.5 at full width in bf16 with seeded random weights (flax-like
   init): UNetConfig.sd15(), VAEConfig.sd(), CLIPTextConfig.sd15() with the
   byte-level tiny tokenizer's BOS/EOS ids (the repo ships no CLIP vocab);
3. answer three txt2img requests through DiffusionPipeline.txt2img: 512x512,
   20 DPM++ 2M steps, guidance 7.5, batch 1, 2 and 4, each image finite and
   in [0, 1]; the kernels' launch counters are zeroed just before and read
   just after, and each of kernels A-D must have launched;
4. hold the card's UNet, VAE decode and CLIP (bf16, kernels) against the
   same weights in fp32 on the CPU (plain versions) on a small input;
5. hold each kernel against its plain version on the card at the path's
   shapes, and time both.

The line before the last is one JSON object with the kernels' records; the
last line is {"ok": true, "device": {...}}.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

SEED = 0
REQUESTS = (1, 2, 4)            # batch sizes of the three txt2img requests
STEPS, GUIDANCE, SIZE = 20, 7.5, 512
PROMPT = 'a photo of a cat sitting on a wooden table, highly detailed'
NEGATIVE = 'blurry, low quality'
# kernel vs plain on the card: both bf16 with fp32 accumulation, each
# rounding its output to bf16 once, at another place: about two bf16 ulps
ATOL, RTOL = 1e-2, 1.6e-2
# card (bf16, kernels) vs CPU (fp32, plain versions) on the same weights:
# relative L2 error of the whole network's output
MODEL_REL_TOL = 5e-2


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f'chip smoke check failed: {what}')


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def build_models(device):
    from hcpdiff_tpu.utils.clip_tokenizer import CLIPTokenizer
    from hcpdiff_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from hcpdiff_tpu_torch.models.layers import init_flax_like
    from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from hcpdiff_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    tok = CLIPTokenizer.tiny()
    clip_cfg = dataclasses.replace(CLIPTextConfig.sd15(), bos_token_id=tok.bos_token_id,
                                   eos_token_id=tok.eos_token_id)
    gen = torch.Generator(device=device).manual_seed(SEED)
    models = []
    for cls, cfg in ((UNet2DCondition, UNetConfig.sd15()), (AutoencoderKL, VAEConfig.sd()),
                     (CLIPTextModel, clip_cfg)):
        with device:
            m = init_flax_like(cls(cfg), gen).to(torch.bfloat16)
        models.append(m.to(memory_format=torch.channels_last).eval())
    unet, vae, clip = models
    return unet, vae, TextEncoderFrontend(tok, clip)


def counters():
    from hcpdiff_tpu_torch.ops.flash_attention import flash_attention
    from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu
    from hcpdiff_tpu_torch.ops.matmul import fused_dense, geglu_dense
    return {'flash_attention': flash_attention, 'geglu_dense': geglu_dense,
            'fused_dense': fused_dense, 'group_norm_silu': group_norm_silu}


def rel_err(out, ref):
    out, ref = out.float().cpu(), ref.float().cpu()
    return float((out - ref).norm() / ref.norm())


@torch.inference_mode()
def reference_phase(pipe, device):
    """Card vs CPU fp32 on a 32x32 latent: big enough that the UNet's first
    level and the VAE's mid block take kernel A (S = 1024)."""
    from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend
    gen = torch.Generator().manual_seed(SEED + 1)
    lat = torch.randn(2, 32, 32, 4, generator=gen)
    t = torch.tensor([801, 301])
    te_cpu = TextEncoderFrontend(pipe.te.tokenizer, copy.deepcopy(pipe.te.model).float().cpu())
    ctx, _ = pipe.te.encode([NEGATIVE, PROMPT])
    ctx_cpu, _ = te_cpu.encode([NEGATIVE, PROMPT])
    errs = {'clip': rel_err(ctx, ctx_cpu)}
    unet_cpu = copy.deepcopy(pipe.unet).float().cpu().to(memory_format=torch.contiguous_format)
    errs['unet'] = rel_err(pipe.unet(lat.to(device), t.to(device), ctx),
                           unet_cpu(lat, t, ctx.float().cpu()))
    del unet_cpu
    vae_cpu = copy.deepcopy(pipe.vae).float().cpu().to(memory_format=torch.contiguous_format)
    errs['vae_decode'] = rel_err(pipe.vae.decode(lat[:1].to(device)), vae_cpu.decode(lat[:1]))
    for name, err in errs.items():
        log(f'reference {name}: card bf16 vs cpu fp32 rel L2 err {err:.3e} '
            f'(limit {MODEL_REL_TOL})')
        check(err <= MODEL_REL_TOL, f'{name} rel err {err} > {MODEL_REL_TOL}')


def time_ms(fn, iters=10):
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
def kernel_phase(launches):
    from hcpdiff_tpu_torch.ops.flash_attention import attention_plain, flash_attention
    from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
    from hcpdiff_tpu_torch.ops.matmul import (fused_dense, fused_dense_plain, geglu_dense,
                                              geglu_dense_plain)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, device='cuda', generator=gen) * scale).to(torch.bfloat16)

    def gn_args(B, S, C):
        return (rn(B, S, C, scale=3.0) + 1.0,
                torch.rand(C, device='cuda', generator=gen) + 0.5,
                torch.randn(C, device='cuda', generator=gen))

    csrc = 'hcpdiff_tpu_torch/csrc/'
    fa, mm, gn = ('hcpdiff_tpu/ops/flash_attention.py:', 'hcpdiff_tpu/ops/matmul.py:',
                  'hcpdiff_tpu/ops/groupnorm.py:')
    cases = {   # name -> (source, TPU kernels replaced, kernel, plain, [(label, args)])
        'flash_attention': (
            csrc + 'flash_attention.cu', [fa + '379', fa + '226'],
            flash_attention, attention_plain,
            [(f'q/k/v {list(s)}', [rn(*s), rn(*s), rn(*s)])
             for s in ((4, 8, 4096, 40), (4, 8, 1024, 80), (2, 1, 4096, 512))]),
        'geglu_dense': (
            csrc + 'gemm.cu', [mm + '301'], geglu_dense, geglu_dense_plain,
            [('x [16384, 320], w [2560, 320]',
              [rn(16384, 320), rn(2560, 320, scale=320 ** -0.5), rn(2560)])]),
        'fused_dense': (
            csrc + 'gemm.cu', [mm + '87', mm + '66'], fused_dense, fused_dense_plain,
            [('x [1024, 5120], w [1280, 5120], res',
              [rn(1024, 5120), rn(1280, 5120, scale=5120 ** -0.5), rn(1280), rn(1024, 1280)])]),
        'group_norm_silu': (
            csrc + 'groupnorm.cu', [gn + '22'],
            group_norm_silu, group_norm_silu_plain,
            [('x [4, 64*64, 320] silu', [*gn_args(4, 64 * 64, 320), 32, 1e-5, True]),
             ('x [4, 16*16, 1280] silu', [*gn_args(4, 16 * 16, 1280), 32, 1e-5, True]),
             ('x [2, 512*512, 128] silu', [*gn_args(2, 512 * 512, 128), 32, 1e-6, True])]),
    }
    records = []
    for name, (source, replaces, kernel, plain, shapes) in cases.items():
        per_shape = []
        for label, args in shapes:
            out, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            max_err = float(err.max())
            ok = bool((err <= ATOL + RTOL * ref.float().abs()).all())
            ms = time_ms(lambda: kernel(*args))
            plain_ms = time_ms(lambda: plain(*args))
            log(f'kernel {name} {label}: max_abs_err {max_err:.4g} '
                f'(tol {ATOL} + {RTOL}*|plain|) kernel {ms:.4f} ms plain {plain_ms:.4f} ms')
            check(ok, f'{name} {label} disagrees with its plain version: {max_err}')
            per_shape.append({'shape': label, 'max_abs_err': max_err, 'ms': ms,
                              'plain_ms': plain_ms})
        # max_abs_err is the largest over the shapes, ms and plain_ms their
        # sums; each shape's own numbers are under 'shapes'
        records.append({
            'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces[0],
            'also_replaces': replaces[1:],
            'launches': launches[name],
            'max_abs_err': max(s['max_abs_err'] for s in per_shape),
            'ms': sum(s['ms'] for s in per_shape),
            'plain_ms': sum(s['plain_ms'] for s in per_shape),
            'tolerance': {'atol': ATOL, 'rtol': RTOL}, 'shapes': per_shape})
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this run needs one GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hcpdiff_tpu_torch.infer.pipeline import DiffusionPipeline
    from hcpdiff_tpu_torch.ops import _build

    device = torch.device('cuda', 0)
    gpu = gpu_name_and_power_limit()
    log(f'torch {torch.__version__} cuda {torch.version.cuda}; card: {gpu}')

    t0 = time.perf_counter()
    _build.library()
    log(f'build seconds: {time.perf_counter() - t0:.2f} ({_build.BUILD_DIR})')

    t0 = time.perf_counter()
    unet, vae, te = build_models(device)
    pipe = DiffusionPipeline(unet, vae, te)
    log(f'model build seconds (SD1.5 full width, bf16, seed {SEED}): '
        f'{time.perf_counter() - t0:.2f}')
    # a 2-step warm-up at each batch size (cuDNN algorithm choice, lazy
    # module loading, allocator), not counted or timed
    for batch in REQUESTS:
        pipe.txt2img(PROMPT, NEGATIVE, width=SIZE, height=SIZE, num_steps=2,
                     guidance_scale=GUIDANCE, seed=SEED, batch_size=batch)

    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    for i, batch in enumerate(REQUESTS):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images = pipe.txt2img(PROMPT, NEGATIVE, width=SIZE, height=SIZE, num_steps=STEPS,
                              guidance_scale=GUIDANCE, sampler='dpm++_2m', seed=SEED + i,
                              batch_size=batch)
        seconds = time.perf_counter() - t0
        log(f'request {i}: txt2img {SIZE}x{SIZE} batch {batch}, {STEPS} DPM++ 2M steps, '
            f'guidance {GUIDANCE}: {seconds:.3f} s ({seconds / batch:.3f} s/image), '
            f'peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
            f'image mean {images.mean():.4f} std {images.std():.4f}')
        check(images.shape == (batch, SIZE, SIZE, 3), f'image shape {images.shape}')
        check(bool(torch.isfinite(torch.from_numpy(images)).all()), 'non-finite image')
        check(images.min() >= 0.0 and images.max() <= 1.0, 'image outside [0, 1]')
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f'kernel launches during the requests: {launches}')
    for name, n in launches.items():
        check(n > 0, f'kernel {name} never launched on the main path')

    reference_phase(pipe, device)
    records = kernel_phase(launches)
    log(gpu)
    print(json.dumps({'kernels': records}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
