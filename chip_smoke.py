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
5. train: a run shaped like bench_train.py's sd15 run. SD1.5 at full width
   (UNet frozen in fp32, computing in bf16 with remat; CLIP fp32), LoRA
   rank 8 on bench_train's two layer patterns, Min-SNR gamma 1, AdamW 1e-4
   (weight decay 1e-4) after a global-norm clip at 1.0, batch 8 of seeded
   [64, 64, 4] latents and random input_ids; one warm-up step (after which
   every LoRA up factor must have left zero), then 5 timed steps with the
   launch counters zeroed before and read after (kernels A-F must each
   launch); seconds per step, samples per second, peak device memory;
6. hold one step's LoRA gradients on the card (bf16, kernels) against the
   same weights in fp32 on the CPU (plain versions), on [2, 32, 32, 4]
   latents (S=1024 at level 0, so E and F run), fixed noise and t, and up
   factors set to small random values first;
7. hold each kernel against its plain version on the card at the paths'
   shapes (A with its lse, E and F at the training shapes), and time both.

The line before the last is one JSON object with the kernels' records; the
last line is {"ok": true, "device": {...}}.
"""
import copy
import dataclasses
import json
import math
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
# relative L2 error of the whole network's output, and of the LoRA
# gradients (over all up factors, and over all down factors)
MODEL_REL_TOL = 5e-2
GRAD_REL_TOL = 5e-2
# kernels E and F vs the plain backward: E/F round P and dS to bf16 before
# their second product and sum thousands of such terms, so an element near
# zero is bounded by the gradient's scale: GRAD_ATOL_REL * max|plain|
GRAD_ATOL_REL = 1e-2
# A's lse vs the plain lse, both fp32
LSE_ATOL = 1e-3
TRAIN_BATCH, TRAIN_LATENT, TIMED_STEPS = 8, 64, 5
LORA_PATTERNS = ['re:.*attn[12]\\.to_(q|k|v|out)$', 're:.*ff\\.(proj|out)$']
CLIP_VOCAB = 49405              # bench_train.py draws input_ids in [0, 49405)


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f'chip smoke check failed: {what}')


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def clip_config():
    """The byte-level tiny tokenizer and CLIPTextConfig.sd15() with its
    BOS/EOS ids (the repo ships no CLIP vocabulary)."""
    from hcpdiff_tpu.utils.clip_tokenizer import CLIPTokenizer
    from hcpdiff_tpu_torch.models.clip import CLIPTextConfig
    tok = CLIPTokenizer.tiny()
    return tok, dataclasses.replace(CLIPTextConfig.sd15(), bos_token_id=tok.bos_token_id,
                                    eos_token_id=tok.eos_token_id)


def build_models(device):
    from hcpdiff_tpu_torch.models.clip import CLIPTextModel
    from hcpdiff_tpu_torch.models.layers import init_flax_like
    from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from hcpdiff_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    tok, clip_cfg = clip_config()
    gen = torch.Generator(device=device).manual_seed(SEED)
    models = []
    for cls, cfg in ((UNet2DCondition, UNetConfig.sd15()), (AutoencoderKL, VAEConfig.sd()),
                     (CLIPTextModel, clip_cfg)):
        with device:
            m = init_flax_like(cls(cfg), gen).to(torch.bfloat16)
        models.append(m.to(memory_format=torch.channels_last).eval())
    unet, vae, clip = models
    return unet, vae, TextEncoderFrontend(tok, clip)


def counters(training: bool = False):
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu
    from hcpdiff_tpu_torch.ops.matmul import fused_dense, geglu_dense
    out = {'flash_attention': fa.flash_attention, 'geglu_dense': geglu_dense,
           'fused_dense': fused_dense, 'group_norm_silu': group_norm_silu}
    if training:
        out.update({'flash_attention_lse': fa.flash_attention_lse,
                    'flash_attention_bwd_dq': fa.flash_attention_bwd_dq,
                    'flash_attention_bwd_dkv': fa.flash_attention_bwd_dkv})
    return out


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


def build_training(device, clip_cfg):
    """The frozen fp32 UNet (remat) and CLIP from the seed, the LoRA pack,
    and a CPU fp32 copy of both models for the gradient check."""
    from hcpdiff_tpu_torch.adapt.overlay import make_lora_overlay
    from hcpdiff_tpu_torch.models.clip import CLIPTextModel
    from hcpdiff_tpu_torch.models.layers import init_flax_like
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from hcpdiff_tpu_torch.trainer.assemble import lora_base_weights

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    with device:
        unet = init_flax_like(UNet2DCondition(UNetConfig.sd15(), remat=True), gen)
        te = init_flax_like(CLIPTextModel(clip_cfg), gen)
        overlay, scales = make_lora_overlay(
            gen, unet, [{'layers': LORA_PATTERNS, 'rank': 8}])
    cpu_models = (copy.deepcopy(unet).cpu(), copy.deepcopy(te).cpu())
    frozen = {'unet': lora_base_weights(unet, overlay)}
    unet.to_compute_dtype(torch.bfloat16).to(memory_format=torch.channels_last)
    for m in (unet, te, *cpu_models):
        m.requires_grad_(False)
    return unet, te, overlay, scales, frozen, cpu_models


def make_step(unet, te, scales):
    from hcpdiff_tpu_torch.diffusion.losses import MinSNRLoss
    from hcpdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from hcpdiff_tpu_torch.trainer.assemble import make_unet_apply
    from hcpdiff_tpu_torch.trainer.step import StepConfig, build_train_step
    schedule = NoiseSchedule.make()
    return build_train_step(make_unet_apply(unet),
                            lambda ids, tm: te(ids, embedding_multiplier=tm)[:2],
                            schedule, MinSNRLoss(schedule, gamma=1.0), StepConfig(),
                            {'lora_unet': scales})


def train_phase(device):
    """5 timed LoRA steps at bench_train.py's sd15 shapes; returns the
    training path's launch counts and what the gradient check needs."""
    from hcpdiff_tpu_torch.trainer.optimizers import make_optimizer
    from hcpdiff_tpu_torch.trainer.step import init_train_state

    t0 = time.perf_counter()
    unet, te, overlay, scales, frozen, cpu_models = build_training(device, clip_config()[1])
    step = make_step(unet, te, scales)
    state = init_train_state({'lora_unet': overlay},
                             make_optimizer('adamw', lr=1e-4, clip_norm=1.0, weight_decay=1e-4))
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    batch = {'latents': torch.randn(TRAIN_BATCH, TRAIN_LATENT, TRAIN_LATENT, 4, generator=gen,
                                    device=device),
             'input_ids': torch.randint(0, CLIP_VOCAB, (TRAIN_BATCH, 77), generator=gen,
                                        device=device)}
    log(f'train setup seconds (SD1.5 full width, fp32 frozen, bf16 compute, remat, '
        f'LoRA rank 8 on {len(overlay)} layers): {time.perf_counter() - t0:.2f}')

    def checked_step(label):
        nonlocal state
        t0 = time.perf_counter()
        state, m = step(state, frozen, batch, gen)
        loss, gnorm = float(m['loss']), float(m['grad_norm'])   # waits for the step
        seconds = time.perf_counter() - t0
        log(f'train {label}: loss {loss:.6f} grad_norm {gnorm:.6f} {seconds:.3f} s')
        check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0,
              f'train {label}: loss {loss}, grad_norm {gnorm}')
        return seconds

    checked_step('warm-up step')
    still_zero = [p for p, e in state.pack['lora_unet'].items() if not bool(e['up'].any())]
    check(not still_zero, f'LoRA up factors still zero after a step: {still_zero[:3]}')
    kernels = counters(training=True)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = [checked_step(f'step {i}') for i in range(TIMED_STEPS)]
    launches = {name: fn.launches for name, fn in kernels.items()}
    per_step = sum(times) / len(times)
    log(f'train timed: {TIMED_STEPS} steps, batch {TRAIN_BATCH}, '
        f'{TRAIN_LATENT * 8}px: {per_step:.4f} s/step '
        f'({TRAIN_BATCH / per_step:.3f} samples/s), steps {[round(t, 4) for t in times]}, '
        f'peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    log(f'kernel launches during the timed steps (remat runs each forward twice): {launches}')
    for name, n in launches.items():
        check(n > 0, f'kernel {name} never launched in the training steps')
    del state, batch
    return launches, (unet, te, overlay, scales, frozen, cpu_models)


def gradient_phase(device, training):
    """One step's LoRA gradients, card (bf16, kernels) vs CPU fp32 (plain
    versions), on the same weights, latents, noise and t."""
    from hcpdiff_tpu_torch.trainer.assemble import lora_base_weights
    unet, te, overlay, scales, frozen, (unet_cpu, te_cpu) = training
    unet_cpu.remat = False      # remat gives the same gradients (CPU tests)
    gen = torch.Generator().manual_seed(SEED + 5)
    for e in overlay.values():
        e['up'].detach().copy_(torch.randn(e['up'].shape, generator=gen) * 1e-2)
    lat = torch.randn(2, 32, 32, 4, generator=gen)
    noise = torch.randn(2, 32, 32, 4, generator=gen)
    ids = torch.randint(0, CLIP_VOCAB, (2, 77), generator=gen)
    t = torch.tensor([801, 301])
    factors = [(p, k) for p in overlay for k in ('down', 'up')]
    grads = {}
    for side, dev, um, tm, fz in (
            ('card', device, unet, te, frozen),
            ('cpu', torch.device('cpu'), unet_cpu, te_cpu,
             {'unet': lora_base_weights(unet_cpu, overlay)})):
        pack = {'lora_unet': {p: {k: v.detach().to(dev).requires_grad_(True)
                                  for k, v in e.items()} for p, e in overlay.items()}}
        batch = {'latents': lat.to(dev), 'input_ids': ids.to(dev)}
        loss = make_step(um, tm, scales).forward_loss(pack, fz, batch, noise.to(dev), t.to(dev))
        g = torch.autograd.grad(loss, [pack['lora_unet'][p][k] for p, k in factors])
        grads[side] = {k: torch.cat([gi.float().cpu().flatten()
                                     for gi, (_, kk) in zip(g, factors) if kk == k])
                       for k in ('down', 'up')}
        log(f'gradient check {side}: loss {float(loss.detach()):.6f}')
    for factor in ('down', 'up'):
        card, cpu = grads['card'][factor], grads['cpu'][factor]
        err = float((card - cpu).norm() / cpu.norm())
        log(f'gradient check: LoRA {factor} gradients, card bf16 vs cpu fp32 rel L2 err '
            f'{err:.3e} (limit {GRAD_REL_TOL}; |grad| {float(cpu.norm()):.4e})')
        check(err <= GRAD_REL_TOL, f'LoRA {factor} gradient rel err {err} > {GRAD_REL_TOL}')


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


def _record(name, source, replaces, launches, per_shape, tolerance, **extra):
    """max_abs_err is the largest over the shapes, ms and plain_ms their
    sums; each shape's own numbers are under 'shapes'."""
    return {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces[0],
            'also_replaces': replaces[1:], 'launches': launches,
            'max_abs_err': max(s['max_abs_err'] for s in per_shape),
            'ms': sum(s['ms'] for s in per_shape),
            'plain_ms': sum(s['plain_ms'] for s in per_shape),
            'tolerance': tolerance, 'shapes': per_shape, **extra}


def _measure(label, kernel, plain, args, ok_fn, what):
    """Run, compare (ok_fn(out, ref) -> (ok, max_abs_err)) and time a kernel
    and its plain version on the same inputs."""
    out, ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    oks, errs = zip(*(ok_fn(o, r) for o, r in zip(outs, refs)))
    max_err = max(errs)
    ms = time_ms(lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*args))
    log(f'kernel {what} {label}: max_abs_err {max_err:.4g} kernel {ms:.4f} ms '
        f'plain {plain_ms:.4f} ms')
    check(all(oks), f'{what} {label} disagrees with its plain version: {max_err}')
    return {'shape': label, 'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms}


def _within(out, ref):
    err = (out.float() - ref.float()).abs()
    return bool((err <= ATOL + RTOL * ref.float().abs()).all()), float(err.max())


def _within_grad(out, ref):
    ref = ref.float()
    err = (out.float() - ref).abs()
    bound = GRAD_ATOL_REL * ref.abs().max() + RTOL * ref.abs()
    return bool((err <= bound).all()), float(err.max())


def _within_lse(out, ref):
    if out.dtype != torch.float32:          # the o of (o, lse)
        return _within(out, ref)
    err = float((out - ref).abs().max())
    return err <= LSE_ATOL, err


CSRC = 'hcpdiff_tpu_torch/csrc/'
FA, MM, GN = ('hcpdiff_tpu/ops/flash_attention.py:', 'hcpdiff_tpu/ops/matmul.py:',
              'hcpdiff_tpu/ops/groupnorm.py:')


def _rn_on(gen):
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, device='cuda', generator=gen) * scale).to(torch.bfloat16)
    return rn


@torch.inference_mode()
def kernel_phase(launches):
    """Kernels A-D at the txt2img path's shapes."""
    from hcpdiff_tpu_torch.ops.flash_attention import attention_plain, flash_attention
    from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
    from hcpdiff_tpu_torch.ops.matmul import (fused_dense, fused_dense_plain, geglu_dense,
                                              geglu_dense_plain)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    rn = _rn_on(gen)

    def gn_args(B, S, C):
        return (rn(B, S, C, scale=3.0) + 1.0,
                torch.rand(C, device='cuda', generator=gen) + 0.5,
                torch.randn(C, device='cuda', generator=gen))

    cases = {   # name -> (source, TPU kernels replaced, kernel, plain, [(label, args)])
        'flash_attention': (
            CSRC + 'flash_attention.cu', [FA + '379', FA + '226'],
            flash_attention, attention_plain,
            [(f'q/k/v {list(s)}', [rn(*s), rn(*s), rn(*s)])
             for s in ((4, 8, 4096, 40), (4, 8, 1024, 80), (2, 1, 4096, 512))]),
        'geglu_dense': (
            CSRC + 'gemm.cu', [MM + '301'], geglu_dense, geglu_dense_plain,
            [('x [16384, 320], w [2560, 320]',
              [rn(16384, 320), rn(2560, 320, scale=320 ** -0.5), rn(2560)])]),
        'fused_dense': (
            CSRC + 'gemm.cu', [MM + '87', MM + '66'], fused_dense, fused_dense_plain,
            [('x [1024, 5120], w [1280, 5120], res',
              [rn(1024, 5120), rn(1280, 5120, scale=5120 ** -0.5), rn(1280), rn(1024, 1280)])]),
        'group_norm_silu': (
            CSRC + 'groupnorm.cu', [GN + '22'],
            group_norm_silu, group_norm_silu_plain,
            [('x [4, 64*64, 320] silu', [*gn_args(4, 64 * 64, 320), 32, 1e-5, True]),
             ('x [4, 16*16, 1280] silu', [*gn_args(4, 16 * 16, 1280), 32, 1e-5, True]),
             ('x [2, 512*512, 128] silu', [*gn_args(2, 512 * 512, 128), 32, 1e-6, True])]),
    }
    records = []
    for name, (source, replaces, kernel, plain, shapes) in cases.items():
        per_shape = [_measure(label, kernel, plain, args, _within, name)
                     for label, args in shapes]
        records.append(_record(name, source, replaces, launches['txt2img'][name], per_shape,
                               {'atol': ATOL, 'rtol': RTOL},
                               launches_train=launches['train'][name]))
    return records


@torch.inference_mode()
def train_kernel_phase(launches):
    """A with its lse, E and F at the training path's shapes."""
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device='cuda').manual_seed(SEED + 6)
    rn = _rn_on(gen)
    per = {'flash_attention_lse': [], 'flash_attention_bwd_dq': [],
           'flash_attention_bwd_dkv': []}
    for shape in ((TRAIN_BATCH, 8, 4096, 40), (TRAIN_BATCH, 8, 1024, 80)):
        label = f'q/k/v/dO {list(shape)}'
        q, k, v, do = (rn(*shape) for _ in range(4))
        scale = shape[-1] ** -0.5
        per['flash_attention_lse'].append(_measure(
            label, lambda q, k, v: fa.flash_attention_lse(q, k, v, scale),
            lambda q, k, v: (fa.attention_plain(q, k, v, scale),
                             fa.attention_lse_plain(q, k, scale)),
            [q, k, v], _within_lse, 'flash_attention_lse'))
        o, lse = fa.flash_attention_lse(q, k, v, scale)
        delta = fa.attention_delta(o, do)
        args = [q, k, v, lse, do, delta, scale]
        per['flash_attention_bwd_dq'].append(_measure(
            label, fa.flash_attention_bwd_dq, fa.flash_bwd_dq_plain, args, _within_grad,
            'flash_attention_bwd_dq'))
        per['flash_attention_bwd_dkv'].append(_measure(
            label, fa.flash_attention_bwd_dkv, fa.flash_bwd_dkv_plain, args, _within_grad,
            'flash_attention_bwd_dkv'))
        del q, k, v, do, o, lse, delta, args
    grad_tol = {'atol': f'{GRAD_ATOL_REL} * max|plain|', 'rtol': RTOL}
    return [
        _record('flash_attention_lse', CSRC + 'flash_attention.cu', [FA + '379'],
                launches['flash_attention_lse'], per['flash_attention_lse'],
                {'o': {'atol': ATOL, 'rtol': RTOL}, 'lse_atol': LSE_ATOL},
                note='kernel A writing its lse output (emit_lse variant of #1)'),
        _record('flash_attention_bwd_dq', CSRC + 'flash_attention_bwd.cu', [FA + '780'],
                launches['flash_attention_bwd_dq'], per['flash_attention_bwd_dq'], grad_tol,
                note='kernel E; plain is flash_bwd_dq_plain'),
        _record('flash_attention_bwd_dkv', CSRC + 'flash_attention_bwd.cu', [FA + '834'],
                launches['flash_attention_bwd_dkv'], per['flash_attention_bwd_dkv'], grad_tol,
                note='kernel F; plain is flash_bwd_dkv_plain'),
    ]


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
    # fp32 products on the card (the B and C backwards, the LoRA merge)
    # run in full fp32, as the JAX package computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_launches, training = train_phase(device)
    gradient_phase(device, training)
    del training
    torch.cuda.empty_cache()
    records = kernel_phase({'txt2img': launches, 'train': train_launches})
    records += train_kernel_phase(train_launches)
    log(gpu)
    print(json.dumps({'kernels': records}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
