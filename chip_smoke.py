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
3b. the fused-sublayer UNet (fused_sublayers=True, the default UNet's
   weights) answers a batch-1 and a batch-4 request the same way; kernels
   G, H, I, J, A, C and D must launch, and B must not;
4. hold the card's UNet, VAE decode and CLIP (bf16, kernels) against the
   same weights in fp32 on the CPU (plain versions) on a small input, and
   the fused UNet too;
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
   factors set to small random values first; then again with a fused,
   remat UNet (kernels G-J's autograd wiring);
7. hold each kernel against its plain version on the card at the paths'
   shapes (A with its lse, E and F at the training shapes, G-J at the
   fused path's) and time both, and the one PyTorch call that computes
   the same function where there is one (library_ms, a yardstick the port
   never calls); each record has its bound (bound_ms: the larger of the
   bytes it must move over 3.35 TB/s and its operations over 989 TFLOP/s
   bf16, or 67 TFLOP/s fp32 outside the tensor cores); B and C (with the
   block residual) at every transformer level of a batch-4 request and at
   the 64x64 (B) and 16x16 (C, a split grid) levels of the batch-2
   requests this script drives, each also beside F.linear on the same product (linear_ms: the product
   alone, since no single call computes B, or C with a residual);
7b. the same for A, A with lse, E and F at the shapes of the TPU's
   classic-layout kernels (#2 _flash_kernel, #4 _flash_kernel_lse, #6
   _flash_bwd_dq/dkv_kernel), causal and not: [2, 10, 4096, 64] (SDXL's
   1024 px level-1 self-attention under CFG) and [2, 8, 4096, 128] (the
   head dim the JAX defaults send to the classic kernels), and E and F at
   [8, 8, 1024, 160] (SD1.5's 1024 px 32x32 level at batch 8); and at the
   VAE's [2, 1, 4096, 512], A causal, A with lse, E and F causal and not;
   A's o there also within a relative L2 error; a causal bound counts only
   the S(S+1)/2 unmasked pairs of a head. These shapes join the records of
   the same wrappers (no path here runs them; the records' launches are
   the paths', at #2/#4/#6's exact-route shapes);
7c. kernel J also at the UNet's other levels (the 8x8 and 16x16 convs,
   most of them split K; 32x32 and 64x64 at Cin 640 and 960), with
   F.conv2d as the yardstick for the bias-only epilogue; kernel D is
   timed at every GroupNorm shape of a batch-4 request (UNet [8, S, C],
   VAE [4, S, C]; tools/time_kernels.py's GN_SHAPES: both of its regimes),
   without SiLU (the transformer and VAE-attention norms) beside
   F.group_norm, and at each shape also launched twice (bitwise equal),
   with fp32 scale and bias, and on an fp32 x;
8. head dims outside the built set: A, A with lse, E and F at D = 16, 96,
   144 and 192 (zero-padded by the wrappers to 48, 128, 160, 512; causal
   at 144 and 192) against their plain versions;
9. fp32 on the card: one case per kernel family (A, A with lse, E, F,
   B, C, D, G, H, I, J) at a main-path shape against its fp32 plain
   version on the operands rounded to bf16 as the fp32 route rounds them
   (each record's `fp32` entry), and the tiny UNet (default and fused) at
   a 32x32 latent in fp32 against the CPU; kernels A and D (and J, G in
   the fused one) must launch.

The line before the last is one JSON object with the kernels' records; the
last line is {"ok": true, "device": {...}}.
"""
import copy
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

SEED = 0
REQUESTS = (1, 2, 4)            # batch sizes of the three txt2img requests
FUSED_REQUESTS = (1, 4)         # and of the fused UNet's
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
# and each whole gradient within a relative L2 error: the larger of 1e-2
# and twice the worst value of the mma.sync kernels E and F replaced, over
# every E/F shape here and in the card tests: 2.73e-3
# (tools/bwd_errors.py on that checkout, H100 80GB HBM3), so 1e-2
GRAD_REL_L2 = 1e-2
# A's lse vs the plain lse, both fp32
LSE_ATOL = 1e-3
# A's o at every shape, also relative L2 over the whole tensor: at S=4096
# |o| is ~0.03, so ATOL alone would pass an error of a third of o; rounding
# o and P to bf16 gives a few 1e-3
O_REL_L2 = 1e-2
TRAIN_BATCH, TRAIN_LATENT, TIMED_STEPS = 8, 64, 5
LORA_PATTERNS = ['re:.*attn[12]\\.to_(q|k|v|out)$', 're:.*ff\\.(proj|out)$']
CLIP_VOCAB = 49405              # bench_train.py draws input_ids in [0, 49405)
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores, fp32
# outside them, device memory
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f'chip smoke check failed: {what}')


def build_seconds(log_path) -> dict:
    """Each source's nvcc seconds and the whole build's, from the build log."""
    out = {}
    for line in open(log_path).read().splitlines():
        m = re.match(r'== (\S+) \(rc \d+, ([0-9.]+) s\)', line)
        if m:
            out[m.group(1)] = float(m.group(2))
        m = re.match(r'== build seconds: ([0-9.]+)', line)
        if m:
            out['total'] = float(m.group(1))
    return out


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# the kernels each path must launch
TXT2IMG_KERNELS = ('flash_attention', 'geglu_dense', 'fused_dense', 'group_norm_silu')
TRAIN_KERNELS = TXT2IMG_KERNELS + ('flash_attention_lse', 'flash_attention_bwd_dq',
                                   'flash_attention_bwd_dkv')
FUSED_KERNELS = ('ln_qkv', 'ln_geglu', 'ln_dense', 'conv3x3', 'flash_attention',
                 'fused_dense', 'group_norm_silu')


def counters():
    """Every kernel wrapper by name; each counts its own launches."""
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    from hcpdiff_tpu_torch.ops import matmul as mm
    from hcpdiff_tpu_torch.ops.conv import conv3x3
    from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu
    return {'flash_attention': fa.flash_attention, 'flash_attention_lse': fa.flash_attention_lse,
            'flash_attention_bwd_dq': fa.flash_attention_bwd_dq,
            'flash_attention_bwd_dkv': fa.flash_attention_bwd_dkv,
            'geglu_dense': mm.geglu_dense, 'fused_dense': mm.fused_dense,
            'group_norm_silu': group_norm_silu, 'ln_qkv': mm.ln_qkv, 'ln_geglu': mm.ln_geglu,
            'ln_dense': mm.ln_dense, 'conv3x3': conv3x3}


def zero_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters(what, expected, absent=()):
    """The launch counts since zero_counters(); each kernel in `expected`
    must have launched and none in `absent`."""
    launches = {name: fn.launches for name, fn in counters().items()}
    log(f'kernel launches during {what}: {launches}')
    for name in expected:
        check(launches[name] > 0, f'kernel {name} never launched during {what}')
    for name in absent:
        check(launches[name] == 0, f'kernel {name} launched during {what}: routing is wrong')
    return launches


def rel_err(out, ref):
    out, ref = out.float().cpu(), ref.float().cpu()
    return float((out - ref).norm() / ref.norm())


def cpu_fp32(module):
    return copy.deepcopy(module).float().cpu().to(memory_format=torch.contiguous_format)


@torch.inference_mode()
def reference_phase(pipe, fused_unet, device):
    """Card vs CPU fp32 on a 32x32 latent: big enough that the UNet's first
    level and the VAE's mid block take kernel A (S = 1024)."""
    from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend
    gen = torch.Generator().manual_seed(SEED + 1)
    lat = torch.randn(2, 32, 32, 4, generator=gen)
    t = torch.tensor([801, 301])
    te_cpu = TextEncoderFrontend(pipe.te.tokenizer, cpu_fp32(pipe.te.model))
    ctx, _ = pipe.te.encode([NEGATIVE, PROMPT])
    ctx_cpu, _ = te_cpu.encode([NEGATIVE, PROMPT])
    errs = {'clip': rel_err(ctx, ctx_cpu)}
    for name, unet in (('unet', pipe.unet), ('fused unet', fused_unet)):
        unet_cpu = cpu_fp32(unet)
        errs[name] = rel_err(unet(lat.to(device), t.to(device), ctx),
                             unet_cpu(lat, t, ctx.float().cpu()))
        del unet_cpu
    vae_cpu = cpu_fp32(pipe.vae)
    errs['vae_decode'] = rel_err(pipe.vae.decode(lat[:1].to(device)), vae_cpu.decode(lat[:1]))
    for name, err in errs.items():
        log(f'reference {name}: card bf16 vs cpu fp32 rel L2 err {err:.3e} '
            f'(limit {MODEL_REL_TOL})')
        check(err <= MODEL_REL_TOL, f'{name} rel err {err} > {MODEL_REL_TOL}')


def build_training(device, clip_cfg, fused: bool = False):
    """The frozen fp32 UNet (remat; fused_sublayers=fused) and CLIP from
    the seed, the LoRA pack, and a CPU fp32 copy of both models for the
    gradient check."""
    from hcpdiff_tpu_torch.adapt.overlay import make_lora_overlay
    from hcpdiff_tpu_torch.models.clip import CLIPTextModel
    from hcpdiff_tpu_torch.models.layers import init_flax_like
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from hcpdiff_tpu_torch.trainer.assemble import lora_base_weights

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    with device:
        unet = init_flax_like(UNet2DCondition(UNetConfig.sd15(), remat=True,
                                              fused_sublayers=fused), gen)
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
    from hcpdiff_tpu_torch.tools.random_sd15 import clip_config
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
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    times = [checked_step(f'step {i}') for i in range(TIMED_STEPS)]
    launches = read_counters('the timed steps (remat runs each forward twice)', TRAIN_KERNELS)
    per_step = sum(times) / len(times)
    log(f'train timed: {TIMED_STEPS} steps, batch {TRAIN_BATCH}, '
        f'{TRAIN_LATENT * 8}px: {per_step:.4f} s/step '
        f'({TRAIN_BATCH / per_step:.3f} samples/s), steps {[round(t, 4) for t in times]}, '
        f'peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    del state, batch
    return launches, (unet, te, overlay, scales, frozen, cpu_models)


def gradient_phase(device, training, what='gradient check'):
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
        log(f'{what} {side}: loss {float(loss.detach()):.6f}')
    for factor in ('down', 'up'):
        card, cpu = grads['card'][factor], grads['cpu'][factor]
        err = float((card - cpu).norm() / cpu.norm())
        log(f'{what}: LoRA {factor} gradients, card bf16 vs cpu fp32 rel L2 err '
            f'{err:.3e} (limit {GRAD_REL_TOL}; |grad| {float(cpu.norm()):.4e})')
        check(err <= GRAD_REL_TOL,
              f'{what}: LoRA {factor} gradient rel err {err} > {GRAD_REL_TOL}')


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


def bound(flops, nbytes, peak=PEAK_BF16):
    """(ms, what bounds it): the least time the card could take for
    `flops` operations at `peak` and `nbytes` moved at PEAK_BYTES."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')


# The work of each kernel at one shape: each input read once and each
# output written once (bf16 2 bytes, fp32 4), and the operations its
# function needs.
def attention_pairs(S, causal):
    """The (query, key) pairs of one head that are work: under causal only
    the S(S+1)/2 unmasked ones."""
    return S * (S + 1) // 2 if causal else S * S


def attention_work(B, H, S, D, lse=False, causal=False):
    return bound(4 * B * H * attention_pairs(S, causal) * D,
                 2 * 4 * B * H * S * D + (4 * B * H * S if lse else 0))


def attention_bwd_work(B, H, S, D, dkv, causal=False):
    """E recomputes S = QK^T and does dP = dO V^T and dQ = dS K; F
    recomputes S and dP and does dV = P^T dO and dK = dS^T Q. Both read q,
    k, v, dO and the fp32 lse and delta; E writes dq, F dk and dv."""
    flops = (8 if dkv else 6) * B * H * attention_pairs(S, causal) * D
    return bound(flops, 2 * B * H * S * D * (6 if dkv else 5) + 2 * 4 * B * H * S)


def gemm_work(M, K, rows, n_out, nw=1, bias=0, res=False, ln=False):
    """nw weights [rows, K], each into an [M, n_out] output (GEGLU: rows =
    2 * n_out), a bias of `bias` values, a residual [M, n_out], LayerNorm
    scale and shift [K]."""
    nbytes = 2 * (M * K + nw * rows * K + bias + nw * M * n_out + (M * n_out if res else 0)
                  + (2 * K if ln else 0))
    return bound(2 * M * K * rows * nw, nbytes)


def conv_work(B, H, W, Cin, Cout, row_bias=False, res=False):
    pix = B * H * W
    nbytes = 2 * (pix * Cin + 9 * Cin * Cout + Cout + (B * Cout if row_bias else 0)
                  + pix * Cout * (2 if res else 1))
    return bound(2 * pix * 9 * Cin * Cout, nbytes)


def group_norm_work(B, S, C, silu=True):
    """About 10 fp32 operations an element (statistics, normalization,
    affine, SiLU; 6 without SiLU), outside the tensor cores; bf16 x, y,
    scale and bias."""
    return bound((10 if silu else 6) * B * S * C, 2 * 2 * B * S * C + 2 * 2 * C, PEAK_FP32)


def _time_library(fn, what):
    """The yardstick's time; a call this PyTorch build refuses gives null
    (the port never makes it, so it fails nothing)."""
    try:
        return time_ms(fn)
    except (RuntimeError, TypeError, NotImplementedError) as e:
        log(f'library call for {what} refused, library_ms null: {e}')
        return None


def _record(name, source, replaces, launches, per_shape, tolerance, **extra):
    """max_abs_err is the largest over the shapes; ms, plain_ms and bound_ms
    their sums; library_ms the sum over the shapes that have a library call
    (library_shapes; null if none); bound_by what bounds most of bound_ms.
    Each shape's own numbers are under 'shapes'."""
    lib = [s for s in per_shape if s['library_ms'] is not None]
    bound_ms = sum(s['bound_ms'] for s in per_shape)
    by_ops = sum(s['bound_ms'] for s in per_shape if s['bound_by'] == 'operations')
    return {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces[0],
            'also_replaces': replaces[1:], 'launches': launches,
            'max_abs_err': max(s['max_abs_err'] for s in per_shape),
            'ms': sum(s['ms'] for s in per_shape),
            'plain_ms': sum(s['plain_ms'] for s in per_shape),
            'bound_ms': bound_ms, 'bound_by': 'operations' if 2 * by_ops >= bound_ms else 'bytes',
            'library_ms': sum(s['library_ms'] for s in lib) if lib else None,
            'library_shapes': [s['shape'] for s in lib],
            'tolerance': tolerance, 'shapes': per_shape, **extra}


def _measure(label, kernel, plain, args, ok_fn, what, work, library=None, yardsticks=None):
    """Run, compare (ok_fn(out, ref) -> (ok, max_abs_err)) and time a kernel
    and its plain version on the same inputs, and `library` (one PyTorch
    call that computes the same function) where there is one; `work` is
    the shape's (bound_ms, bound_by); `yardsticks` ({key: call}) are timed
    beside it under their keys (a part of the function, e.g. its product
    alone)."""
    out, ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    oks, errs = zip(*(ok_fn(o, r) for o, r in zip(outs, refs)))
    max_err = max(errs)
    del out, ref, outs, refs
    ms = time_ms(lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*args))
    library_ms = None if library is None else _time_library(library, f'{what} {label}')
    extra = {key: time_ms(fn) for key, fn in (yardsticks or {}).items()}
    bound_ms, bound_by = work
    log(f'kernel {what} {label}: max_abs_err {max_err:.4g} kernel {ms:.4f} ms '
        f'plain {plain_ms:.4f} ms library {library_ms} ms bound {bound_ms:.4f} ms ({bound_by})'
        + ''.join(f' {k} {v:.4f} ms' for k, v in extra.items()))
    check(all(oks), f'{what} {label} disagrees with its plain version: {max_err}')
    return {'shape': label, 'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            'library_ms': library_ms, 'bound_ms': bound_ms, 'bound_by': bound_by, **extra}


def _within(out, ref):
    err = (out.float() - ref.float()).abs()
    return bool((err <= ATOL + RTOL * ref.float().abs()).all()), float(err.max())


# kernel D in fp32 against its fp32 plain version (fp32 sums in two orders)
GN_F32_TOL = 1e-5


def _within_gn32(out, ref):
    err = (out - ref).abs()
    return bool((err <= GN_F32_TOL * (1 + ref.abs())).all()), float(err.max())


def _within_grad(out, ref):
    """|out - ref| <= GRAD_ATOL_REL * max|ref| + RTOL * |ref|, and a relative
    L2 error of at most GRAD_REL_L2."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    bound = GRAD_ATOL_REL * ref.abs().max() + RTOL * ref.abs()
    rel = float((out - ref).norm() / ref.norm())
    log(f'  grad rel L2 err {rel:.3e} (limit {GRAD_REL_L2})')
    return bool((err <= bound).all()) and rel <= GRAD_REL_L2, float(err.max())


def _within_lse(out, ref):
    if out.dtype != torch.float32:          # the o of (o, lse)
        return _within(out, ref)
    err = float((out - ref).abs().max())
    return err <= LSE_ATOL, err


def _within_rel(out, ref):
    """_within, and a relative L2 error of at most O_REL_L2; the lse of
    (o, lse) as _within_lse."""
    if out.dtype == torch.float32:
        return _within_lse(out, ref)
    ok, err = _within(out, ref)
    out, ref = out.float(), ref.float()
    rel = float((out - ref).norm() / ref.norm())
    log(f'  o rel L2 err {rel:.3e} (limit {O_REL_L2})')
    return ok and rel <= O_REL_L2, err


CSRC = 'hcpdiff_tpu_torch/csrc/'
FA, MM, GN, CV = ('hcpdiff_tpu/ops/flash_attention.py:', 'hcpdiff_tpu/ops/matmul.py:',
                  'hcpdiff_tpu/ops/groupnorm.py:', 'hcpdiff_tpu/ops/conv.py:')


def _rn_on(gen):
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, device='cuda', generator=gen) * scale).to(torch.bfloat16)
    return rn


def _run_cases(cases, launches, extra_launches):
    """cases: name -> (source, TPU kernels replaced, kernel, plain, ok_fn,
    tolerance, [(label, args, work, library[, yardsticks])]); launches: the
    main path's counts; extra_launches: {label: counts} of the other paths."""
    records = []
    for name, (source, replaces, kernel, plain, ok_fn, tol, shapes) in cases.items():
        per_shape = [_measure(label, kernel, plain, args, ok_fn, name, work, library, *more)
                     for label, args, work, library, *more in shapes]
        records.append(_record(name, source, replaces, launches[name], per_shape, tol,
                               **{f'launches_{k}': v[name] for k, v in extra_launches.items()}))
    return records


TOL = {'atol': ATOL, 'rtol': RTOL}
# (S, C) of the UNet's transformer levels: 64x64, 32x32, 16x16 and the 8x8 mid block
FFN_LEVELS = ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
O_TOL = {**TOL, 'o_rel_l2': O_REL_L2}          # kernel A's o


def gn_checks(B, S, C, args):
    """Kernel D beyond the timed call at one shape: two launches bitwise
    equal; fp32 scale and bias (an fp32 model's parameters under a bf16
    UNet) within TOL; an fp32 x within GN_F32_TOL. Fatal on failure."""
    from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
    x, sc, bi, *rest = args
    out, again = group_norm_silu(*args), group_norm_silu(*args)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f'D at [{B}, {S}, {C}]: two launches differ')
    del out, again
    f32 = [sc.float(), bi.float(), *rest]
    ok, err = _within(group_norm_silu(x, *f32), group_norm_silu_plain(x, *f32))
    check(ok, f'D at [{B}, {S}, {C}] with fp32 scale/bias disagrees: {err}')
    xf = x.float()
    ok32, err32 = _within_gn32(group_norm_silu(xf, *f32), group_norm_silu_plain(xf, *f32))
    check(ok32, f'D at [{B}, {S}, {C}] in fp32 disagrees: {err32}')
    log(f'  D [{B}, {S}, {C}]: bitwise equal twice; fp32 scale/bias max err {err:.3g}; '
        f'fp32 x max err {err32:.3g}')
    del xf
    torch.cuda.empty_cache()


@torch.inference_mode()
def kernel_phase(launches):
    """Kernels A-D at the txt2img path's shapes."""
    from hcpdiff_tpu_torch.ops.flash_attention import attention_plain, flash_attention
    from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
    from hcpdiff_tpu_torch.ops.matmul import (fused_dense, fused_dense_plain, geglu_dense,
                                              geglu_dense_plain)
    from hcpdiff_tpu_torch.tools.time_kernels import GN_SHAPES
    F = torch.nn.functional
    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    rn = _rn_on(gen)

    def gn_case(B, S, C, silu):
        """D at one GroupNorm shape of a batch-4 request, with bf16 scale
        and bias as the model holds them (the VAE's norms at batch 4 take
        eps 1e-6); without SiLU the yardstick is F.group_norm on the same
        tensor viewed as [B, C, S]."""
        x = rn(B, S, C, scale=3.0) + 1.0
        sc, bi = rn(C, scale=0.2) + 1.0, rn(C)
        eps = 1e-6 if B == 4 else 1e-5
        args = [x, sc, bi, 32, eps, silu]
        gn_checks(B, S, C, args)
        library = None if silu else (
            lambda: F.group_norm(x.transpose(1, 2), 32, sc, bi, eps))
        return (f'x [{B}, {S}, {C}]{" silu" if silu else " no silu"}', args,
                group_norm_work(B, S, C, silu), library)

    def attn(s):
        q, k, v = rn(*s), rn(*s), rn(*s)
        return (f'q/k/v {list(s)}', [q, k, v], attention_work(*s),
                lambda: F.scaled_dot_product_attention(q, k, v))

    def ffn(kind, M, K, rows):
        """B, or C with the block residual, at one transformer level;
        F.linear times the product alone (linear_ms)."""
        x, w, b = rn(M, K), rn(rows, K, scale=K ** -0.5), rn(rows)
        if kind == 'B':
            return (f'x [{M}, {K}], w [{rows}, {K}]', [x, w, b],
                    gemm_work(M, K, rows, rows // 2, bias=rows), None,
                    {'linear_ms': lambda: F.linear(x, w, b)})
        return (f'x [{M}, {K}], w [{rows}, {K}], res', [x, w, b, rn(M, rows)],
                gemm_work(M, K, rows, rows, bias=rows, res=True), None,
                {'linear_ms': lambda: F.linear(x, w, b)})

    x_in, w_in, b_in = rn(32768, 320), rn(320, 320, scale=320 ** -0.5), rn(320)
    cases = {
        'flash_attention': (
            CSRC + 'flash_attention.cu', [FA + '379', FA + '226'],
            flash_attention, attention_plain, _within_rel, O_TOL,
            [attn(s) for s in ((4, 8, 4096, 40), (4, 8, 1024, 80), (2, 1, 4096, 512))]),
        'geglu_dense': (
            CSRC + 'gemm_wgmma.cu', [MM + '301'], geglu_dense, geglu_dense_plain, _within, TOL,
            [ffn('B', 8 * S, C, 8 * C) for S, C in FFN_LEVELS] + [ffn('B', 16384, 320, 2560)]),
        'fused_dense': (
            CSRC + 'gemm_wgmma.cu', [MM + '87', MM + '66'], fused_dense, fused_dense_plain,
            _within, TOL,
            [ffn('C', 8 * S, 4 * C, C) for S, C in FFN_LEVELS] + [ffn('C', 1024, 5120, 1280)]
            + [('x [32768, 320], w [320, 320] (proj_in, no res)', [x_in, w_in, b_in],
                gemm_work(32768, 320, 320, 320, bias=320), lambda: F.linear(x_in, w_in, b_in))]),
        'group_norm_silu': (
            CSRC + 'groupnorm.cu', [GN + '22', GN + '177', GN + '204'],
            group_norm_silu, group_norm_silu_plain, _within, TOL,
            [gn_case(*shape) for shape in GN_SHAPES]),
    }
    return _run_cases(cases, launches['txt2img'],
                      {'train': launches['train'], 'fused': launches['fused']})


def _library_attention(q, k, v, do, scale, causal):
    """PyTorch's own flash-attention forward (with its logsumexp) and
    backward (dq, dk and dv in one call) on these inputs; the backward is
    None when this build refuses the forward."""
    aten = torch.ops.aten

    def lib_fwd():
        return aten._scaled_dot_product_flash_attention(q, k, v, is_causal=causal, scale=scale)
    try:
        r = lib_fwd()

        def lib_bwd():
            return aten._scaled_dot_product_flash_attention_backward(
                do, q, k, v, r[0], r[1], r[2], r[3], r[4], r[5], 0.0, causal, r[6], r[7],
                scale=scale)
    except (RuntimeError, TypeError, NotImplementedError) as e:
        log(f'library flash-attention forward refused, no backward yardstick: {e}')
        lib_bwd = None
    return lib_fwd, lib_bwd


GRAD_TOL = {'atol': f'{GRAD_ATOL_REL} * max|plain|', 'rtol': RTOL, 'rel_l2': GRAD_REL_L2}
# what E and F share (the header, wgmma), and their D=512 variants
BWD_SOURCES = [CSRC + 'flash_attention_bwd.cuh', CSRC + 'wgmma.cuh',
               CSRC + 'flash_attention_bwd_chunked.cu']
LIB_BWD_NOTE = ('library_ms: one aten flash-attention backward call, which computes dq, dk '
                'and dv together (the same call is timed for E and for F)')


@torch.inference_mode()
def train_kernel_phase(launches):
    """A with its lse, E and F at the training path's shapes. The library
    calls are PyTorch's own flash-attention forward (with its logsumexp)
    and backward (dq, dk and dv in one call, timed for E and F each)."""
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device='cuda').manual_seed(SEED + 6)
    rn = _rn_on(gen)
    per = {'flash_attention_lse': [], 'flash_attention_bwd_dq': [],
           'flash_attention_bwd_dkv': []}
    for shape in ((TRAIN_BATCH, 8, 4096, 40), (TRAIN_BATCH, 8, 1024, 80)):
        label = f'q/k/v/dO {list(shape)}'
        q, k, v, do = (rn(*shape) for _ in range(4))
        scale = shape[-1] ** -0.5
        lib_fwd, lib_bwd = _library_attention(q, k, v, do, scale, False)
        per['flash_attention_lse'].append(_measure(
            label, lambda q, k, v: fa.flash_attention_lse(q, k, v, scale),
            lambda q, k, v: (fa.attention_plain(q, k, v, scale),
                             fa.attention_lse_plain(q, k, scale)),
            [q, k, v], _within_rel, 'flash_attention_lse', attention_work(*shape, lse=True),
            lib_fwd))
        o, lse = fa.flash_attention_lse(q, k, v, scale)
        delta = fa.attention_delta(o, do)
        args = [q, k, v, lse, do, delta, scale]
        for name, kernel, plain, dkv in (
                ('flash_attention_bwd_dq', fa.flash_attention_bwd_dq, fa.flash_bwd_dq_plain,
                 False),
                ('flash_attention_bwd_dkv', fa.flash_attention_bwd_dkv, fa.flash_bwd_dkv_plain,
                 True)):
            per[name].append(_measure(label, kernel, plain, args, _within_grad, name,
                                      attention_bwd_work(*shape, dkv), lib_bwd))
        del q, k, v, do, o, lse, delta, args
    return [
        _record('flash_attention_lse', CSRC + 'flash_attention.cu', [FA + '379'],
                launches['flash_attention_lse'], per['flash_attention_lse'],
                {'o': O_TOL, 'lse_atol': LSE_ATOL},
                note='kernel A writing its lse output (emit_lse variant of #1, :453-457)'),
        _record('flash_attention_bwd_dq', CSRC + 'flash_attention_bwd_dq.cu', [FA + '780'],
                launches['flash_attention_bwd_dq'], per['flash_attention_bwd_dq'], GRAD_TOL,
                note='kernel E; plain is flash_bwd_dq_plain; ' + LIB_BWD_NOTE,
                also_sources=BWD_SOURCES),
        _record('flash_attention_bwd_dkv', CSRC + 'flash_attention_bwd_dkv.cu', [FA + '834'],
                launches['flash_attention_bwd_dkv'], per['flash_attention_bwd_dkv'], GRAD_TOL,
                note='kernel F; plain is flash_bwd_dkv_plain; ' + LIB_BWD_NOTE,
                also_sources=BWD_SOURCES),
    ]


# the classic-layout kernels' shapes: SDXL's 1024 px level-1 self-attention
# under CFG (D=64, which takes #2 under HCP_FLASH_NOMAX=0) and the head dim
# the JAX defaults send to #2 (D=128); the backward also at SD1.5's 1024 px
# 32x32 level at batch 8 (D=160)
CLASSIC_SHAPES = ((2, 10, 4096, 64), (2, 8, 4096, 128))
CLASSIC_BWD_SHAPES = CLASSIC_SHAPES + ((TRAIN_BATCH, 8, 1024, 160),)
# the VAE's mid-block attention shape (D=512): A causal, A with lse, E and F
# (E and F: the D-chunked variant); A without causal is kernel_phase's
# record
VAE_SHAPE = (2, 1, 4096, 512)


@torch.inference_mode()
def classic_kernel_phase():
    """A, A with lse, E and F at the classic-layout kernels' (#2, #4, #6)
    shapes, causal and not: {wrapper name: (TPU kernel, per-shape
    records)}, to add to the wrappers' own records."""
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    F = torch.nn.functional
    gen = torch.Generator(device='cuda').manual_seed(SEED + 8)
    rn = _rn_on(gen)
    per = {'flash_attention': (FA + '54', []), 'flash_attention_lse': (FA + '613', []),
           'flash_attention_bwd_dq': (FA + '683', []),
           'flash_attention_bwd_dkv': (FA + '733', [])}
    for shape in CLASSIC_BWD_SHAPES + (VAE_SHAPE,):
        for causal in (False, True):
            label = (f'{"vae" if shape == VAE_SHAPE else "classic"} q/k/v/dO {list(shape)}'
                     + (' causal' if causal else ''))
            q, k, v, do = (rn(*shape) for _ in range(4))
            scale = shape[-1] ** -0.5
            lib_fwd, lib_bwd = _library_attention(q, k, v, do, scale, causal)
            if shape in CLASSIC_SHAPES or (shape == VAE_SHAPE and causal):
                per['flash_attention'][1].append(_measure(
                    label, lambda q, k, v: fa.flash_attention(q, k, v, scale, causal),
                    lambda q, k, v: fa.attention_plain(q, k, v, scale, causal), [q, k, v],
                    _within_rel, 'flash_attention', attention_work(*shape, causal=causal),
                    lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)))
            if shape in CLASSIC_SHAPES or shape == VAE_SHAPE:
                per['flash_attention_lse'][1].append(_measure(
                    label, lambda q, k, v: fa.flash_attention_lse(q, k, v, scale, causal),
                    lambda q, k, v: (fa.attention_plain(q, k, v, scale, causal),
                                     fa.attention_lse_plain(q, k, scale, causal)),
                    [q, k, v], _within_rel, 'flash_attention_lse',
                    attention_work(*shape, lse=True, causal=causal), lib_fwd))
            o, lse = fa.flash_attention_lse(q, k, v, scale, causal)
            args = [q, k, v, lse, do, fa.attention_delta(o, do), scale, causal]
            for name, kernel, plain, dkv in (
                    ('flash_attention_bwd_dq', fa.flash_attention_bwd_dq, fa.flash_bwd_dq_plain,
                     False),
                    ('flash_attention_bwd_dkv', fa.flash_attention_bwd_dkv,
                     fa.flash_bwd_dkv_plain, True)):
                per[name][1].append(_measure(label, kernel, plain, args, _within_grad, name,
                                             attention_bwd_work(*shape, dkv, causal), lib_bwd))
            del q, k, v, do, o, lse, args
            torch.cuda.empty_cache()
    return per


CLASSIC_NOTE = ("the shapes labelled classic are #2/#4/#6's (D=64/128/160, causal and not), "
                "and those labelled vae the VAE's D=512 causal (A, A with lse, E, F) and with "
                "lse or a backward, which no path driven here runs: the launches are the "
                "paths' D=40/80 non-causal ones, at #2/#4/#6's exact-route shapes")


def add_classic_shapes(records, classic):
    """The records of A, A with lse, E and F with the classic shapes added
    (and the TPU kernels they replace there)."""
    out = []
    for rec in records:
        if rec['name'] in classic:
            replaces, shapes = classic[rec['name']]
            keep = {k: v for k, v in rec.items()
                    if k.startswith('launches_') or k in ('note', 'also_sources')}
            rec = _record(rec['name'], rec['source'],
                          [rec['replaces'], *rec['also_replaces'], replaces], rec['launches'],
                          rec['shapes'] + shapes, rec['tolerance'], classic_note=CLASSIC_NOTE,
                          **keep)
        out.append(rec)
    return out


# kernel J at the UNet's other levels (size, Cin, Cout): the 8x8 and
# 16x16 convs, most of whose grids the plan splits over K, and one conv
# each at 32x32 and 64x64
J_LEVELS = ((32, 640, 640), (16, 1280, 1280), (16, 2560, 1280), (8, 1280, 1280),
            (64, 960, 320))


@torch.inference_mode()
def fused_kernel_phase(launches):
    """Kernels G-J at the fused path's shapes (SD1.5 512 px, batch 4, so
    a UNet batch of 8): G-I at levels 0 and 2, J at level 0 with each
    epilogue and at the 8x8, Cin = 2560 conv (up_0's first resblock)."""
    from hcpdiff_tpu_torch.ops import matmul as mm
    from hcpdiff_tpu_torch.ops.conv import conv3x3, conv3x3_plain
    F = torch.nn.functional
    gen = torch.Generator(device='cuda').manual_seed(SEED + 7)
    rn = _rn_on(gen)
    cl = torch.channels_last
    eps = 1e-6

    def ln_args(M, C):
        return rn(M, C), 1.0 + rn(C, scale=0.1), rn(C, scale=0.1)

    levels = ((8 * 64 * 64, 320), (8 * 16 * 16, 1280))       # (M, C) at levels 0 and 2
    g_shapes, h_shapes, i_shapes = [], [], []
    for M, C in levels:
        x, g, b = ln_args(M, C)
        ws = [rn(C, C, scale=C ** -0.5) for _ in range(3)]
        w2, b2 = rn(8 * C, C, scale=C ** -0.5), rn(8 * C)
        g_shapes.append((f'x [{M}, {C}], wq/wk/wv [{C}, {C}]', [x, g, b, *ws, eps],
                         gemm_work(M, C, C, C, nw=3, ln=True), None))
        h_shapes.append((f'x [{M}, {C}], w [{8 * C}, {C}]', [x, g, b, w2, b2, eps],
                         gemm_work(M, C, 8 * C, 4 * C, bias=8 * C, ln=True), None))
        i_shapes.append((f'x [{M}, {C}], w [{C}, {C}]', [x, g, b, ws[0], eps],
                         gemm_work(M, C, C, C, ln=True), None))

    def conv_case(B, Cin, H, W, Cout, epilogue):
        from hcpdiff_tpu_torch.ops.conv import conv_plan
        log(f'  J plan at [{B}, {Cin}, {H}, {W}] -> {Cout}: {conv_plan(B, H, W, Cin, Cout)}')
        x = rn(B, Cin, H, W).to(memory_format=cl)
        w = rn(Cout, Cin, 3, 3, scale=(9 * Cin) ** -0.5).to(memory_format=cl)
        b = rn(Cout)
        rb = rn(B, Cout) if epilogue == 'row_bias' else None
        res = rn(B, Cout, H, W).to(memory_format=cl) if epilogue == 'res' else None
        library = (lambda: F.conv2d(x, w, b, padding=1)) if epilogue == 'bias' else None
        return (f'x [{B}, {Cin}, {H}, {W}] -> {Cout}, {epilogue}', [x, w, b, rb, res],
                conv_work(B, H, W, Cin, Cout, rb is not None, res is not None), library)

    cases = {
        'ln_qkv': (CSRC + 'gemm.cu', [MM + '412'], mm.ln_qkv, mm.ln_qkv_plain, _within, TOL,
                   g_shapes),
        'ln_geglu': (CSRC + 'gemm.cu', [MM + '497'], mm.ln_geglu, mm.ln_geglu_plain, _within,
                     TOL, h_shapes),
        'ln_dense': (CSRC + 'gemm.cu', [MM + '600'], mm.ln_dense, mm.ln_dense_plain, _within,
                     TOL, i_shapes),
        'conv3x3': (CSRC + 'conv.cu', [CV + '48'], conv3x3, conv3x3_plain, _within, TOL,
                    [conv_case(8, 320, 64, 64, 320, 'row_bias'),
                     conv_case(8, 320, 64, 64, 320, 'res'),
                     conv_case(8, 320, 64, 64, 320, 'bias'),
                     conv_case(8, 2560, 8, 8, 1280, 'bias')]
                    + [conv_case(8, Cin, size, size, Cout, 'bias')
                       for size, Cin, Cout in J_LEVELS]),
    }
    return _run_cases(cases, launches, {})


@torch.inference_mode()
def head_dim_phase():
    """A, A with lse, E and F at head dims outside the built set, which the
    wrappers zero-pad to the next built one (16 -> 48, 96 -> 128, 144 ->
    160, 192 -> 512), against the plain versions at D; causal at 144 and
    192."""
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device='cuda').manual_seed(SEED + 9)
    rn = _rn_on(gen)
    zero_counters()
    for D, causal in ((16, False), (96, False), (144, True), (192, True)):
        shape = (2, 8, 1024, D)
        q, k, v, do = (rn(*shape) for _ in range(4))
        sc = D ** -0.5
        o, lse = fa.flash_attention_lse(q, k, v, sc, causal)
        delta = fa.attention_delta(o, do)
        dq = fa.flash_attention_bwd_dq(q, k, v, lse, do, delta, sc, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, sc, causal)
        checks = [('o', _within_rel(fa.flash_attention(q, k, v, sc, causal),
                                    fa.attention_plain(q, k, v, sc, causal))),
                  ('o with lse', _within_rel(o, fa.attention_plain(q, k, v, sc, causal))),
                  ('lse', _within_lse(lse, fa.attention_lse_plain(q, k, sc, causal)))]
        refs = fa.flash_attention_backward_plain(q, k, v, o, lse, do, sc, causal)
        checks += [(n, _within_grad(a, r)) for n, a, r in zip(('dq', 'dk', 'dv'), (dq, dk, dv),
                                                               refs)]
        log(f'head dim {D} (kernel at {fa.kernel_head_dim("A", D)})'
            f'{" causal" if causal else ""}: ' + ', '.join(f'{n} max err {e:.3g}'
                                                          for n, (_, e) in checks))
        for n, (ok, e) in checks:
            check(ok, f'head dim {D}: {n} disagrees with its plain version ({e})')
    read_counters('the head-dim checks', ('flash_attention', 'flash_attention_lse',
                                          'flash_attention_bwd_dq', 'flash_attention_bwd_dkv'))


def _r(t):
    """t with its values rounded to bf16: an fp32 call's matrix operand."""
    return t.to(torch.bfloat16).to(t.dtype)


def _ln_fp32_reference(route, x, g, b, *params, eps):
    """G, H and I's fp32 function: LayerNorm of the rounded x with the
    rounded scale and shift, rounded to bf16 (the product's operand, as in
    the bf16 route), then the fp32 product with the rounded weights, and
    H's bias in fp32."""
    from hcpdiff_tpu_torch.ops import matmul as mm
    xn = mm._layer_norm(x.to(torch.bfloat16), g.to(torch.bfloat16), b.to(torch.bfloat16), eps)
    if route == 'ln_geglu':
        return mm.geglu_dense_plain(xn, _r(params[0]), params[1])
    outs = tuple(torch.nn.functional.linear(xn, _r(w)) for w in params)
    return outs if route == 'ln_qkv' else outs[0]


@torch.inference_mode()
def fp32_phase(records, device):
    """Every kernel family on fp32 tensors at a main-path shape, stored as
    each record's `fp32` entry: the tensor-core kernels compute the fp32
    function on their matrix operands rounded to bf16 (the TPU's default
    fp32 matmul precision) with an fp32 epilogue and output, and are held
    to TOL against the plain versions on those rounded operands; D is fp32
    throughout, held to GN_F32_TOL. Then the tiny UNet (default and fused)
    in fp32 at a 32x32 latent against the CPU."""
    from hcpdiff_tpu_torch.models.layers import init_flax_like
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    from hcpdiff_tpu_torch.ops import matmul as mm
    from hcpdiff_tpu_torch.ops.conv import conv3x3, conv3x3_plain
    from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
    gen = torch.Generator(device='cuda').manual_seed(SEED + 10)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, device='cuda', generator=gen) * scale

    q, k, v, do = (rn(8, 8, 1024, 80) for _ in range(4))
    sc = 80 ** -0.5
    o, lse = fa.attention_plain(q, k, v, sc), fa.attention_lse_plain(q, k, sc)
    bwd = [q, k, v, lse, do, fa.attention_delta(o, do), sc]
    x1, x2 = rn(16384, 320), rn(2048, 1280)
    g2, b2 = 1.0 + rn(1280, scale=0.1), rn(1280, scale=0.1)
    w2 = [rn(1280, 1280, scale=1280 ** -0.5) for _ in range(3)]
    cl = torch.channels_last
    xc = rn(8, 320, 64, 64).to(memory_format=cl)
    wc = rn(320, 320, 3, 3, scale=2880 ** -0.5).to(memory_format=cl)
    def qkv(q, k, v, *rest):
        return (_r(q), _r(k), _r(v), *rest)

    def grads(q, k, v, lse, do, *rest):
        return (_r(q), _r(k), _r(v), lse, _r(do), *rest)

    cases = {
        'flash_attention': ('q/k/v [8, 8, 1024, 80]', fa.flash_attention,
                            lambda *a: fa.attention_plain(*qkv(*a), sc), [q, k, v], _within),
        'flash_attention_lse': ('q/k/v [8, 8, 1024, 80]',
                                lambda *a: fa.flash_attention_lse(*a, sc),
                                lambda *a: (fa.attention_plain(*qkv(*a), sc),
                                            fa.attention_lse_plain(*qkv(*a)[:2], sc)),
                                [q, k, v], _within_lse),
        'flash_attention_bwd_dq': ('q/k/v/dO [8, 8, 1024, 80]', fa.flash_attention_bwd_dq,
                                   lambda *a: fa.flash_bwd_dq_plain(*grads(*a)), bwd,
                                   _within_grad),
        'flash_attention_bwd_dkv': ('q/k/v/dO [8, 8, 1024, 80]', fa.flash_attention_bwd_dkv,
                                    lambda *a: fa.flash_bwd_dkv_plain(*grads(*a)), bwd,
                                    _within_grad),
        'geglu_dense': ('x [16384, 320], w [2560, 320]', mm.geglu_dense,
                        lambda x, w, b: mm.geglu_dense_plain(_r(x), _r(w), b),
                        [x1, rn(2560, 320, scale=320 ** -0.5), rn(2560)], _within),
        'fused_dense': ('x [16384, 320], w [320, 320], res', mm.fused_dense,
                        lambda x, w, *e: mm.fused_dense_plain(_r(x), _r(w), *e),
                        [x1, rn(320, 320, scale=320 ** -0.5), rn(320), rn(16384, 320)], _within),
        'group_norm_silu': ('x [4, 4096, 320] silu', group_norm_silu, group_norm_silu_plain,
                            [rn(4, 4096, 320, scale=3.0) + 1.0,
                             torch.rand(320, device='cuda', generator=gen) + 0.5, rn(320), 32,
                             1e-5, True], _within_gn32),
        'ln_qkv': ('x [2048, 1280], wq/wk/wv [1280, 1280]', mm.ln_qkv,
                   lambda *a: _ln_fp32_reference('ln_qkv', *a[:-1], eps=a[-1]),
                   [x2, g2, b2, *w2, 1e-6], _within),
        'ln_geglu': ('x [2048, 1280], w [10240, 1280]', mm.ln_geglu,
                     lambda *a: _ln_fp32_reference('ln_geglu', *a[:-1], eps=a[-1]),
                     [x2, g2, b2, rn(10240, 1280, scale=1280 ** -0.5), rn(10240), 1e-6],
                     _within),
        'ln_dense': ('x [2048, 1280], w [1280, 1280]', mm.ln_dense,
                     lambda *a: _ln_fp32_reference('ln_dense', *a[:-1], eps=a[-1]),
                     [x2, g2, b2, w2[0], 1e-6], _within),
        'conv3x3': ('x [8, 320, 64, 64] -> 320, row_bias', conv3x3,
                    lambda x, w, *e: conv3x3_plain(_r(x), _r(w), *e),
                    [xc, wc, rn(320), rn(8, 320), None], _within),
    }
    zero_counters()
    by_name = {r['name']: r for r in records}
    for name, (label, kernel, plain, args, ok_fn) in cases.items():
        outs = kernel(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        check(all(t.dtype == torch.float32 for t in outs), f'{name} fp32 output dtype')
        del outs
        rec = _measure(f'fp32 {label}', kernel, plain, args, ok_fn, name, (0.0, 'none'))
        del rec['bound_ms'], rec['bound_by'], rec['library_ms']
        by_name[name]['fp32'] = rec
    read_counters('the fp32 checks', tuple(cases))
    del cases, q, k, v, do, o, lse, bwd, x1, x2, xc
    torch.cuda.empty_cache()

    cpu = init_flax_like(UNet2DCondition(UNetConfig.tiny()), torch.Generator().manual_seed(SEED))
    lat = torch.randn(2, 32, 32, 4, generator=torch.Generator().manual_seed(SEED + 11))
    ctx = torch.randn(2, 77, 32, generator=torch.Generator().manual_seed(SEED + 12))
    t = torch.tensor([801, 301])
    ref = cpu(lat, t, ctx)
    for fused in (False, True):
        card = UNet2DCondition(UNetConfig.tiny(), fused_sublayers=fused)
        card.load_state_dict(cpu.state_dict())
        card = card.to(device).to(memory_format=cl).eval()
        zero_counters()
        err = rel_err(card(lat.to(device), t.to(device), ctx.to(device)), ref)
        what = f'the tiny {"fused " if fused else ""}UNet in fp32 at a 32x32 latent'
        read_counters(what, ('flash_attention', 'group_norm_silu')
                      + (('conv3x3', 'ln_qkv') if fused else ()))
        log(f'{what}: card vs cpu fp32 rel L2 err {err:.3e} (limit {MODEL_REL_TOL})')
        check(err <= MODEL_REL_TOL, f'{what}: rel err {err} > {MODEL_REL_TOL}')


def answer_requests(pipe, batches, what):
    """Time txt2img requests at 512 px, 20 DPM++ 2M steps; check images."""
    for i, batch in enumerate(batches):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images = pipe.txt2img(PROMPT, NEGATIVE, width=SIZE, height=SIZE, num_steps=STEPS,
                              guidance_scale=GUIDANCE, sampler='dpm++_2m', seed=SEED + i,
                              batch_size=batch)
        seconds = time.perf_counter() - t0
        log(f'{what} {i}: txt2img {SIZE}x{SIZE} batch {batch}, {STEPS} DPM++ 2M steps, '
            f'guidance {GUIDANCE}: {seconds:.3f} s ({seconds / batch:.3f} s/image), '
            f'peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
            f'image mean {images.mean():.4f} std {images.std():.4f}')
        check(images.shape == (batch, SIZE, SIZE, 3), f'image shape {images.shape}')
        check(bool(torch.isfinite(torch.from_numpy(images)).all()), 'non-finite image')
        check(images.min() >= 0.0 and images.max() <= 1.0, 'image outside [0, 1]')


def warm_up(pipe, batches):
    """A 2-step request at each batch size (cuDNN algorithm choice, lazy
    module loading, allocator), not counted or timed."""
    for batch in batches:
        pipe.txt2img(PROMPT, NEGATIVE, width=SIZE, height=SIZE, num_steps=2,
                     guidance_scale=GUIDANCE, seed=SEED, batch_size=batch)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this run needs one GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hcpdiff_tpu_torch.infer.pipeline import DiffusionPipeline
    from hcpdiff_tpu_torch.ops import _build
    from hcpdiff_tpu_torch.tools.random_sd15 import build_sd15, clip_config, fused_copy

    device = torch.device('cuda', 0)
    gpu = gpu_name_and_power_limit()
    log(f'torch {torch.__version__} cuda {torch.version.cuda}; card: {gpu}')

    t0 = time.perf_counter()
    _build.library()
    log(f'build seconds: {time.perf_counter() - t0:.2f} ({_build.BUILD_DIR}); nvcc seconds '
        f'by source: {build_seconds(_build.BUILD_DIR / "build.log")}')

    t0 = time.perf_counter()
    unet, vae, te = build_sd15(device, SEED)
    pipe = DiffusionPipeline(unet, vae, te)
    log(f'model build seconds (SD1.5 full width, bf16, seed {SEED}): '
        f'{time.perf_counter() - t0:.2f}')
    warm_up(pipe, REQUESTS)
    zero_counters()
    answer_requests(pipe, REQUESTS, 'request')
    launches = read_counters('the requests', TXT2IMG_KERNELS)

    fused_pipe = DiffusionPipeline(fused_copy(unet, device), vae, te)
    warm_up(fused_pipe, FUSED_REQUESTS)
    zero_counters()
    answer_requests(fused_pipe, FUSED_REQUESTS, 'fused request')
    fused_launches = read_counters('the fused requests', FUSED_KERNELS, absent=('geglu_dense',))

    reference_phase(pipe, fused_pipe.unet, device)
    del fused_pipe
    # fp32 products on the card (the B and C backwards, the LoRA merge)
    # run in full fp32, as the JAX package computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_launches, training = train_phase(device)
    gradient_phase(device, training)
    del training
    gradient_phase(device, build_training(device, clip_config()[1], fused=True),
                   'fused gradient check')
    torch.cuda.empty_cache()
    records = kernel_phase({'txt2img': launches, 'train': train_launches,
                            'fused': fused_launches})
    records += train_kernel_phase(train_launches)
    records = add_classic_shapes(records, classic_kernel_phase())
    records += fused_kernel_phase(fused_launches)
    head_dim_phase()
    fp32_phase(records, device)
    log(gpu)
    print(json.dumps({'kernels': records}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
