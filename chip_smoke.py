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
4b. SDXL: build UNetConfig.sdxl(), VAEConfig.sdxl() and CLIP-L + bigG
   (CLIPTextConfig.sd15() and .sdxl_big_g(), the tiny tokenizer's BOS/EOS
   ids) at full width and depth, bf16, seeded (tools/random_sdxl.py);
   answer txt2img requests at 1024x1024, 20 DPM++ 2M steps, guidance 7.5,
   batch 1 and 4 (the pooled embedding and time_ids conditioning), each
   image finite and in [0, 1], with seconds a request and an image and
   peak device memory; kernels A-D must launch, as often as the configs
   say (SDXL_LAUNCHES), and G-J never;
4c. hold the SDXL text frontend (both encoders, full width: hidden and
   pooled) and the SDXL UNet at full width with one transformer block a
   level (transformer_layers_per_block (1, 1, 1)) on a [2, 64, 64, 4]
   latent (S = 1024 at level 1, so A runs) against the same weights in
   fp32 on the CPU;
4d. the config-driven entry point (python -m hcpdiff_tpu_torch.visualizer):
   write SD1.5 at full width as a diffusers-layout directory (F16
   safetensors, tools/random_diffusers.py, seed SEED) into a temporary
   directory, load it with build_models on the card in bf16 and check
   every tensor equals the seeded original rounded to fp16 (then cast to
   the loaded dtype); answer cfgs/infer/text2img.yaml through main()
   (batch 4, 512 px, 20 DPM++ 2M steps, CFG 7.5, bf16, seed 1): A-D launch
   as often as an SD1.5 request does (sd15_launches), four PNGs and four
   YAMLs are written and the PNGs read back equal the images, and the
   final latents equal DiffusionPipeline.txt2img's on the same modules;
   euler_a.yaml twice (bitwise equal); img2img.yaml and inpaint.yaml on
   512x512 PNGs written here, whose VAE encode runs A at [1, 1, 4096, 512]
   and D at the encoder's 22 GroupNorm shapes (forward hooks), with the
   encode held against the CPU in fp32 at 256 px; each request's seconds
   and peak memory printed;
4e. the training entry point (python -m hcpdiff_tpu_torch.train) on the
   same directory: lora_conventional.yaml through main() on 16 seeded PNGs
   (10 at 640x640, 6 at 768x512) with step_size 64 (a 512x512 and a 640x448
   bucket), batch 4, UNet LoRA r8 + CLIP LoRA r4, bf16, remat under the
   default HCP_REMAT_POLICY=flash, the latent cache, 12 steps saving at 6
   and 12: losses finite, the four checkpoint
   files written and unet-12/text_encoder-12 loading back equal to the final
   pack, every LoRA up factor moved, launches of A (with lse), E, F, B, C and
   D equal to the reckoning from the steps' buckets and the latent cache's
   encodes (trainer_reckoning: under flash A with its lse once an
   attention a step, the recompute taking its o and lse); the directory-load and latent-cache
   seconds, the median and spread of steps 2-12, samples/s and peak memory
   printed; then a run resumed (train.resume.auto) from a copy stopped at
   step 6 must equal the uninterrupted one bitwise (the relative
   differences are printed), and 3 steps of fine-tuning.yaml (every UNet
   weight an fp32 master under AdamW) must give finite losses and move
   every weight tensor; the run's kernel shapes join the kernel records
   (labelled trainer, launches_trainer);
4f. the server (python -m hcpdiff_tpu_torch.server's InferenceServer and
   handler, 127.0.0.1 on an ephemeral port, a reload token) on the same
   directory and the trainer's unet-12/text_encoder-12 LoRAs at alpha 0.8
   (cfgs/infer/text2img_lora.yaml, bf16, 512 px): merge-at-load seconds
   and peak memory, precompile, /health, three /txt2img requests (batch
   4, 1, 4; launches as reckoned; the first response's PNGs bitwise the
   uint8 of vis_images at its seed), every merged UNet (bf16) and CLIP
   (fp32) weight against an fp64 merge of the files on the CPU, /reload
   without the token (403), then with it: alpha 0.4 (no directory read,
   the same modules, latents bitwise a fresh Visualizer's), save_model
   (its load with no merge block gives those latents bitwise), a large
   seeded LoRA (the image moves), a branch: n LoRA (DreamArtist: each
   step's UNet launches doubled, batch 1 and 4 timed) and an emb_dir
   word (the CLIP input rows at its ids are the file's vectors); the
   phase's launches join the kernel records (launches_server);
4g. the rest of the train step: cfgs/train/examples/lora_sdxl.yaml through
   the config loader and Trainer(cfgs, world=...) on tools/random_sdxl.py's
   seeded SDXL world at full width and depth (fp32 frozen, bf16 compute,
   remat; UNet LoRA r8, CLIP-L and bigG LoRA r4), 4 PNGs at 1024 px and 2
   at 1216x832 (a 1024x1024 and a 1216x832 bucket), batch 1, crop-info
   time_ids, the latent cache, 6 steps saving at 6: losses finite, every
   up factor of lora_unet, lora_te and lora_te2 moved but those of CLIP-L's
   top layer (above clip_skip 1; the pooled embedding is bigG's), which no
   gradient reaches and which must stay zero, unet-6,
   text_encoder-6 and text_encoder_2-6 written and loading back equal to
   the pack, launches of A (with lse), E, F, B, C and D equal to the
   reckoning (E and F at D = 64 at both transformer levels of the 1024 px
   bucket); the median and spread of the step seconds, samples/s and peak
   memory printed; then DreamArtist++.yaml through main() on the 4d
   directory and the 4e PNGs, its words pt-dog1 and pt-dog1-neg made by
   tools/create_embedding.py: 4 steps at batch 1 with cfg_scale
   '1.0-3.0:cos', losses finite, both branches' up factors and both words'
   rows moved, B and C launching twice a plain step's (the reckoning with
   two UNet calls a step), and pt-dog1-4.pt / pt-dog1-neg-4.pt loading
   back equal to the pack's rows; the SDXL run's shapes join the kernel
   records (labelled trainer_sdxl: A with lse, E and F at [1, 10, 4096,
   64] and [1, 20, 1024, 64], B, C and D at levels 1 and 2;
   launches_trainer_sdxl, launches_trainer_sdxl_step_1024 (the counters
   read around the run's first 1024 px step; every step's counts are held
   to the reckoning for its shape) and launches_trainer_da); then that
   1024 px batch's step under HCP_REMAT_POLICY full and flash in turns,
   three times (A with lse 140 and 70 a step, each held to its reckoning;
   step seconds and peak memory printed); after phase
   6, the SDXL UNet at full width with one transformer block a level holds
   one step's LoRA gradients (card, bf16, remat) against the CPU (fp32) on
   a [2, 64, 64, 4] latent (A with lse, E and F at D = 64), within phase
   6's tolerance;
4h. SD2.1 768-v: tools/random_diffusers.py --model sd21 (F16, seed SEED,
   Linear proj_in/proj_out, use_linear_projection: true) into the
   temporary directory, loaded in bf16 and held tensor by tensor against
   the seeded originals; the SD2.1 UNet at full width against fp32 on the
   CPU on a [2, 32, 32, 4] latent (A at [2, 5, 1024, 64]); a config written
   there from cfgs/infer/text2img.yaml with new_components.scheduler
   prediction_type: v_prediction answers 768x768 requests through main()
   at batch 1 and 4 (20 DPM++ 2M steps, guidance 7.5): images finite in
   [0, 1], launches as an SD1.5 request's, A's shapes counted through the
   dispatcher ([2b, 5, 9216, 64] and [2b, 10, 2304, 64] 100 each, the
   VAE's [b, 1, 9216, 512] once), seconds a request and an image, peak
   memory; then cfgs/train/examples/sd21_vpred.yaml through the config
   loader and Trainer on that directory, four 768x768 PNGs (target_area
   768^2), batch 2, bf16, remat, 6 steps: v-prediction, losses finite,
   every LoRA up factor moved, launches as reckoned (A with lse, E and F at
   [2, 5, 9216, 64] and [2, 10, 2304, 64]), step median and spread,
   samples/s, peak memory; its kernel shapes join the records (labelled
   sd21, launches_sd21, with launches_sd21_requests and
   launches_deepcache);
4i. DeepCache and the encoder mask on the 4d directory: text2img.yaml
   through main() with infer_args.deep_cache_interval 3, then 2 (512 px,
   batch 4): launches as reckoned (deepcache_launches: a full UNet call at
   every Nth step, a reuse call of down level 0 and the last up level at
   the others, so A 7 x 10 + 13 x 5 in the loop at interval 3), images
   finite in [0, 1] and not the exact request's; the exact and both
   DeepCache requests timed in turns on one Visualizer (vis_images); the
   card's DeepCache loop (bf16) against the CPU's (fp32) on a 32x32
   latent; one request with encoder_attention_mask: true (launches as an
   exact request's, images not the unmasked ones);
5. train: a run shaped like bench_train.py's sd15 run. SD1.5 at full width
   (UNet frozen in fp32, computing in bf16 with remat; CLIP fp32), LoRA
   rank 8 on bench_train's two layer patterns, Min-SNR gamma 1, AdamW 1e-4
   (weight decay 1e-4) after a global-norm clip at 1.0, batch 8 of seeded
   [64, 64, 4] latents and random input_ids; one warm-up step (after which
   every LoRA up factor must have left zero), then 5 timed steps with the
   launch counters zeroed before and read after (kernels A-F must each
   launch, as trainer_reckoning counts them); seconds per step, samples
   per second, peak device memory; then steps under HCP_REMAT_POLICY full
   and flash in turns, five of each (launches as reckoned, seconds and
   peak memory);
6. hold one step's LoRA gradients on the card (bf16, kernels) against the
   same weights in fp32 on the CPU (plain versions), on [2, 32, 32, 4]
   latents (S=1024 at level 0, so E and F run), fixed noise and t, and up
   factors set to small random values first; the card's gradients under
   HCP_REMAT_POLICY=flash also against those under full (expected equal,
   POLICY_REL_TOL; the largest difference printed; cuDNN's deterministic
   algorithms, since the fused UNet's plain J backward otherwise varies
   from run to run); then again with a fused, remat UNet (kernels G-J's
   autograd wiring);
7. hold each kernel against its plain version on the card at the paths'
   shapes (A with its lse, E and F at the training shapes, G-J at the
   fused path's; A and D also at the VAE encoder's batch-1 shapes of an
   img2img request, labelled enc) and time both, and the one PyTorch call
   that computes the same function where there is one (library_ms, a
   yardstick the port never calls); each record has its bound (bound_ms:
   the larger of the bytes it must move over 3.35 TB/s and its operations
   over 989 TFLOP/s bf16, or 67 TFLOP/s fp32 outside the tensor cores); B
   and C (with the block residual) at every transformer level of a batch-4
   request and at the 64x64 (B) and 16x16 (C, a split grid) levels of
   the batch-2 requests this script drives, and G, H and I at every transformer level
   of a batch-4 request (each also launched twice, bitwise equal, and its
   plan logged), each beside F.linear on the same product (linear_ms: the
   product alone, since no single call computes B, C with a residual, or
   a LayerNorm and a product);
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
7d. A, B, C and D also at the SDXL request's batch-4 shapes (labelled
   sdxl): A at [8, 10, 4096, 64], [8, 20, 1024, 64] (self-attention at
   levels 1 and 2) and [1, 1, 16384, 512] (the 1024 px VAE's mid-block
   attention, compared at batch 1: the plain version's scores take 1 GiB
   a head); B and C at both transformer levels; D, with the same checks
   as 7c, at every GroupNorm shape of the request that no 512 px request
   has: the UNet's [8, 128^2, 320/640/960], [8, 64^2, 1280/1920] and
   [8, 32^2, 2560] with SiLU and its transformer norms [8, 64^2, 640] and
   [8, 32^2, 1280] without, the 1024 px VAE's [4, 1024^2, 128],
   [4, 1024^2, 256] and [4, 512^2, 512] with SiLU and its mid-block
   attention norm [4, 128^2, 512] without;
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
import collections
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

SEED = 0
REQUESTS = (1, 2, 4)            # batch sizes of the three txt2img requests
FUSED_REQUESTS = (1, 4)         # and of the fused UNet's
STEPS, GUIDANCE, SIZE = 20, 7.5, 512
SDXL_REQUESTS, SDXL_SIZE = (1, 4), 1024
# an SDXL request's launches, by its configs: 70 transformer blocks a UNet
# call (each one A, B and C), 46 GroupNorms a call, STEPS calls; then the
# VAE decode's mid-block attention (A) and 30 GroupNorms
SDXL_LAUNCHES = {'flash_attention': 70 * STEPS + 1, 'geglu_dense': 70 * STEPS,
                 'fused_dense': 70 * STEPS, 'group_norm_silu': 46 * STEPS + 30}
# the VAE encode of img2img/inpaint: its mid-block attention and 22 GroupNorms
ENCODE_LAUNCHES = {'flash_attention': 1, 'group_norm_silu': 22}


def sd15_launches(steps, encode=False, unet_calls=1, decode=True):
    """An SD1.5 512 px request's launches, by its configs: 10
    self-attentions at S >= 1024 (A), 16 transformer blocks (B, C) and 61
    GroupNorms (D) a UNet call, `unet_calls` calls a step (2 with
    DreamArtist's negative branch), `steps` steps, then the VAE decode's
    mid-block attention and 30 GroupNorms (unless the request returns
    latents), and the encode's, if asked."""
    n = steps * unet_calls
    out = {'flash_attention': 10 * n + int(decode), 'geglu_dense': 16 * n,
           'fused_dense': 16 * n, 'group_norm_silu': 61 * n + 30 * int(decode)}
    if encode:
        out = {k: n + ENCODE_LAUNCHES.get(k, 0) for k, n in out.items()}
    return out


VIS_SEED = 1
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
# the card's LoRA gradients under the two remat policies: the same kernels
# on the same inputs, A's o and lse kept or launched again (expected equal)
POLICY_REL_TOL = 1e-6
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
FUSED_ONLY = ('ln_qkv', 'ln_geglu', 'ln_dense', 'conv3x3')


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
    launches = read_counters(f'the timed steps (remat, policy {unet.remat_policy})',
                             TRAIN_KERNELS)
    shape = (TRAIN_BATCH, TRAIN_LATENT, TRAIN_LATENT, 4)
    _check_launches(launches, trainer_reckoning(unet.cfg, [[shape]] * TIMED_STEPS, [], 8, 0,
                                                policy=unet.remat_policy), 'the timed steps')
    per_step = sum(times) / len(times)
    log(f'train timed: {TIMED_STEPS} steps, batch {TRAIN_BATCH}, '
        f'{TRAIN_LATENT * 8}px: {per_step:.4f} s/step '
        f'({TRAIN_BATCH / per_step:.3f} samples/s), steps {[round(t, 4) for t in times]}, '
        f'peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')

    def one_step():
        nonlocal state
        state, m = step(state, frozen, batch, gen)
        return m['loss']
    _remat_policy_steps(unet, one_step, lambda policy: trainer_reckoning(
        unet.cfg, [[shape]], [], 8, 0, policy=policy), f'a {shape} SD1.5 LoRA step', rounds=5)
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
    policy = unet.remat_policy
    # the fused UNet's J backward is plain torch (cuDNN), whose default
    # algorithms vary from run to run, so its card gradients differ between
    # two steps under one policy: deterministic algorithms, so that the
    # policies are compared alone
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for side, dev, um, tm, fz in (
            ('card', device, unet, te, frozen),
            ('card full', device, unet, te, frozen),
            ('cpu', torch.device('cpu'), unet_cpu, te_cpu,
             {'unet': lora_base_weights(unet_cpu, overlay)})):
        # the card's gradients under the default remat policy (flash: A's
        # o and lse kept for the backward), then under HCP_REMAT_POLICY=full
        unet.remat_policy = 'full' if side == 'card full' else policy
        pack = {'lora_unet': {p: {k: v.detach().to(dev).requires_grad_(True)
                                  for k, v in e.items()} for p, e in overlay.items()}}
        batch = {'latents': lat.to(dev), 'input_ids': ids.to(dev)}
        loss = make_step(um, tm, scales).forward_loss(pack, fz, batch, noise.to(dev), t.to(dev))
        g = torch.autograd.grad(loss, [pack['lora_unet'][p][k] for p, k in factors])
        grads[side] = {k: torch.cat([gi.float().cpu().flatten()
                                     for gi, (_, kk) in zip(g, factors) if kk == k])
                       for k in ('down', 'up')}
        log(f'{what} {side}: loss {float(loss.detach()):.6f}')
    unet.remat_policy = policy
    torch.backends.cudnn.deterministic = deterministic
    for factor in ('down', 'up'):
        flash, full = grads['card'][factor], grads['card full'][factor]
        diff = float((flash - full).abs().max())
        rel = float((flash - full).norm() / full.norm())
        log(f'{what}: LoRA {factor} gradients on the card under HCP_REMAT_POLICY={policy} vs '
            f'full: max abs diff {diff:.3e}, rel L2 {rel:.3e} (limit {POLICY_REL_TOL})')
        check(policy == 'flash' and rel <= POLICY_REL_TOL,
              f'{what}: LoRA {factor} gradients under {policy} and full differ: rel {rel}')
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
# SDXL's batch-4 shapes (a UNet batch of 8): self-attention at levels 1
# and 2 (D = 64) and the 1024 px VAE's mid-block attention, compared at
# batch 1; (S, C) of the two transformer levels (D's: time_kernels.py's
# SDXL_GN_SHAPES)
SDXL_ATTN_SHAPES = ((8, 10, 4096, 64), (8, 20, 1024, 64), (1, 1, 16384, 512))
SDXL_FFN_LEVELS = ((4096, 640), (1024, 1280))


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
    from hcpdiff_tpu_torch.tools.time_kernels import ENC_GN_SHAPES, GN_SHAPES, SDXL_GN_SHAPES
    F = torch.nn.functional
    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    rn = _rn_on(gen)

    def gn_case(B, S, C, silu, prefix='', eps=None):
        """D at one GroupNorm shape of a batch-4 request, with bf16 scale
        and bias as the model holds them (the VAE's norms at batch 4 take
        eps 1e-6); without SiLU the yardstick is F.group_norm on the same
        tensor viewed as [B, C, S]."""
        x = rn(B, S, C, scale=3.0) + 1.0
        sc, bi = rn(C, scale=0.2) + 1.0, rn(C)
        eps = eps or (1e-6 if B == 4 else 1e-5)
        args = [x, sc, bi, 32, eps, silu]
        gn_checks(B, S, C, args)
        library = None if silu else (
            lambda: F.group_norm(x.transpose(1, 2), 32, sc, bi, eps))
        return (f'{prefix}x [{B}, {S}, {C}]{" silu" if silu else " no silu"}', args,
                group_norm_work(B, S, C, silu), library)

    def attn(s, prefix=''):
        q, k, v = rn(*s), rn(*s), rn(*s)
        return (f'{prefix}q/k/v {list(s)}', [q, k, v], attention_work(*s),
                lambda: F.scaled_dot_product_attention(q, k, v))

    def ffn(kind, M, K, rows, prefix=''):
        """B, or C with the block residual, at one transformer level;
        F.linear times the product alone (linear_ms)."""
        x, w, b = rn(M, K), rn(rows, K, scale=K ** -0.5), rn(rows)
        if kind == 'B':
            return (f'{prefix}x [{M}, {K}], w [{rows}, {K}]', [x, w, b],
                    gemm_work(M, K, rows, rows // 2, bias=rows), None,
                    {'linear_ms': lambda: F.linear(x, w, b)})
        return (f'{prefix}x [{M}, {K}], w [{rows}, {K}], res', [x, w, b, rn(M, rows)],
                gemm_work(M, K, rows, rows, bias=rows, res=True), None,
                {'linear_ms': lambda: F.linear(x, w, b)})

    x_in, w_in, b_in = rn(32768, 320), rn(320, 320, scale=320 ** -0.5), rn(320)
    cases = {
        'flash_attention': (
            CSRC + 'flash_attention.cu', [FA + '379', FA + '226'],
            flash_attention, attention_plain, _within_rel, O_TOL,
            [attn(s) for s in ((4, 8, 4096, 40), (4, 8, 1024, 80), (2, 1, 4096, 512))]
            + [attn(s, 'sdxl ') for s in SDXL_ATTN_SHAPES]
            + [attn((1, 1, 4096, 512), 'enc ')]),
        'geglu_dense': (
            CSRC + 'gemm_wgmma.cu', [MM + '301'], geglu_dense, geglu_dense_plain, _within, TOL,
            [ffn('B', 8 * S, C, 8 * C) for S, C in FFN_LEVELS] + [ffn('B', 16384, 320, 2560)]
            + [ffn('B', 8 * S, C, 8 * C, 'sdxl ') for S, C in SDXL_FFN_LEVELS]),
        'fused_dense': (
            CSRC + 'gemm_wgmma.cu', [MM + '87', MM + '66'], fused_dense, fused_dense_plain,
            _within, TOL,
            [ffn('C', 8 * S, 4 * C, C) for S, C in FFN_LEVELS] + [ffn('C', 1024, 5120, 1280)]
            + [('x [32768, 320], w [320, 320] (proj_in, no res)', [x_in, w_in, b_in],
                gemm_work(32768, 320, 320, 320, bias=320), lambda: F.linear(x_in, w_in, b_in))]
            + [ffn('C', 8 * S, 4 * C, C, 'sdxl ') for S, C in SDXL_FFN_LEVELS]),
        'group_norm_silu': (
            CSRC + 'groupnorm.cu', [GN + '22', GN + '177', GN + '204'],
            group_norm_silu, group_norm_silu_plain, _within, TOL,
            [gn_case(*shape) for shape in GN_SHAPES]
            + [gn_case(*shape, 'sdxl ') for shape in SDXL_GN_SHAPES]
            + [gn_case(*shape, 'enc ', eps=1e-6) for shape in ENC_GN_SHAPES]),
    }
    return _run_cases(cases, launches['txt2img'],
                      {'train': launches['train'], 'fused': launches['fused'],
                       'sdxl': launches['sdxl'], 'visualizer': launches['visualizer'],
                       'server': launches['server']})


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


def trainer_kernel_phase(shapes, tag='trainer'):
    """A (the latent cache's VAE encode), A with its lse, E, F, B, C and D
    at a trainer run's shapes (labelled ``tag``): {wrapper name:
    per-shape records}, to add to the wrappers' own records."""
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    from hcpdiff_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
    from hcpdiff_tpu_torch.ops.matmul import (fused_dense, fused_dense_plain, geglu_dense,
                                              geglu_dense_plain)
    F = torch.nn.functional
    rn = _rn_on(torch.Generator(device='cuda').manual_seed(SEED + 31))
    per = {name: [] for name in TRAINER_KERNELS}
    for shape in shapes['attn']:
        label = f'{tag} q/k/v/dO {list(shape)}'
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
        args = [q, k, v, lse, do, fa.attention_delta(o, do), scale]
        for name, kernel, plain, dkv in (
                ('flash_attention_bwd_dq', fa.flash_attention_bwd_dq, fa.flash_bwd_dq_plain,
                 False),
                ('flash_attention_bwd_dkv', fa.flash_attention_bwd_dkv, fa.flash_bwd_dkv_plain,
                 True)):
            per[name].append(_measure(label, kernel, plain, args, _within_grad, name,
                                      attention_bwd_work(*shape, dkv), lib_bwd))
        del q, k, v, do, o, lse, args
        torch.cuda.empty_cache()
    with torch.inference_mode():
        for shape in shapes['enc_attn']:
            q, k, v = rn(*shape), rn(*shape), rn(*shape)
            per['flash_attention'].append(_measure(
                f'{tag} enc q/k/v {list(shape)}', fa.flash_attention, fa.attention_plain,
                [q, k, v], _within_rel, 'flash_attention', attention_work(*shape),
                lambda: F.scaled_dot_product_attention(q, k, v)))
        for M, C in shapes['ffn']:
            x, w, b = rn(M, C), rn(8 * C, C, scale=C ** -0.5), rn(8 * C)
            per['geglu_dense'].append(_measure(
                f'{tag} x [{M}, {C}], w [{8 * C}, {C}]', geglu_dense, geglu_dense_plain,
                [x, w, b], _within, 'geglu_dense', gemm_work(M, C, 8 * C, 4 * C, bias=8 * C),
                None, {'linear_ms': lambda: F.linear(x, w, b)}))
            x, w, b = rn(M, 4 * C), rn(C, 4 * C, scale=(4 * C) ** -0.5), rn(C)
            per['fused_dense'].append(_measure(
                f'{tag} x [{M}, {4 * C}], w [{C}, {4 * C}], res', fused_dense,
                fused_dense_plain, [x, w, b, rn(M, C)], _within, 'fused_dense',
                gemm_work(M, 4 * C, C, C, bias=C, res=True), None,
                {'linear_ms': lambda: F.linear(x, w, b)}))
        for B, S, C, silu in shapes['gn']:
            x = rn(B, S, C, scale=3.0) + 1.0
            sc, bi = rn(C, scale=0.2) + 1.0, rn(C)
            args = [x, sc, bi, 32, 1e-5, silu]
            gn_checks(B, S, C, args)
            per['group_norm_silu'].append(_measure(
                f'{tag} x [{B}, {S}, {C}]{" silu" if silu else " no silu"}', group_norm_silu,
                group_norm_silu_plain, args, _within, 'group_norm_silu',
                group_norm_work(B, S, C, silu),
                None if silu else lambda: F.group_norm(x.transpose(1, 2), 32, sc, bi, 1e-5)))
            del x, args
            torch.cuda.empty_cache()
    return per


def add_trainer_shapes(records, per, launches, tag='trainer', **more):
    """Each record with a trainer run's shapes added and its launches in
    that run (``launches_<tag>``; ``more``: {key: launches} of other
    counts to keep beside them)."""
    out = []
    for rec in records:
        name = rec['name']
        if per.get(name):
            keep = {k: v for k, v in rec.items() if k not in (
                'name', 'route', 'source', 'replaces', 'also_replaces', 'launches',
                'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                'library_shapes', 'tolerance', 'shapes')}
            rec = _record(name, rec['source'], [rec['replaces'], *rec['also_replaces']],
                          rec['launches'], rec['shapes'] + per[name], rec['tolerance'], **keep)
        rec[f'launches_{tag}'] = launches.get(name, 0)
        for key, counts in more.items():
            rec[key] = counts.get(name, 0)
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
    a UNet batch of 8): G-I at every transformer level, each also launched
    twice (bitwise equal, fatal) and beside F.linear on its product alone
    (linear_ms; G's three weights as one), J at level 0 with each epilogue
    and at the 8x8, Cin = 2560 conv (up_0's first resblock)."""
    from hcpdiff_tpu_torch.ops import matmul as mm
    from hcpdiff_tpu_torch.ops.conv import conv3x3, conv3x3_plain
    F = torch.nn.functional
    gen = torch.Generator(device='cuda').manual_seed(SEED + 7)
    rn = _rn_on(gen)
    cl = torch.channels_last
    eps = 1e-6

    def ln_case(kind, kernel, M, C, args, work, product):
        """One G/H/I shape: its plan logged, two launches bitwise equal."""
        geglu = kind == 'H'
        plan = mm.ln_gemm_plan(geglu, 3 if kind == 'G' else 1, M, 4 * C if geglu else C, C)
        outs, again = kernel(*args), kernel(*args)
        torch.cuda.synchronize()
        outs, again = (outs, again) if kind == 'G' else ((outs,), (again,))
        check(all(torch.equal(a, b) for a, b in zip(outs, again)),
              f'{kind} at x [{M}, {C}]: two launches differ')
        log(f'  {kind} plan at x [{M}, {C}]: {plan}; bitwise equal twice')
        del outs, again
        label = (f'x [{M}, {C}], ' + ('wq/wk/wv' if kind == 'G' else 'w')
                 + f' [{args[3].shape[0]}, {C}]')
        return (label, args, work, None, {'linear_ms': product})

    g_shapes, h_shapes, i_shapes = [], [], []
    for S, C in FFN_LEVELS:
        M = 8 * S
        x, g, b = rn(M, C), 1.0 + rn(C, scale=0.1), rn(C, scale=0.1)
        ws = [rn(C, C, scale=C ** -0.5) for _ in range(3)]
        w2, b2 = rn(8 * C, C, scale=C ** -0.5), rn(8 * C)
        wqkv = torch.cat(ws)
        g_shapes.append(ln_case('G', mm.ln_qkv, M, C, [x, g, b, *ws, eps],
                                gemm_work(M, C, C, C, nw=3, ln=True),
                                lambda x=x, w=wqkv: F.linear(x, w)))
        h_shapes.append(ln_case('H', mm.ln_geglu, M, C, [x, g, b, w2, b2, eps],
                                gemm_work(M, C, 8 * C, 4 * C, bias=8 * C, ln=True),
                                lambda x=x, w=w2, bb=b2: F.linear(x, w, bb)))
        i_shapes.append(ln_case('I', mm.ln_dense, M, C, [x, g, b, ws[0], eps],
                                gemm_work(M, C, C, C, ln=True),
                                lambda x=x, w=ws[0]: F.linear(x, w)))

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
        'ln_qkv': (CSRC + 'ln_gemm_wgmma.cu', [MM + '412'], mm.ln_qkv, mm.ln_qkv_plain,
                   _within, TOL, g_shapes),
        'ln_geglu': (CSRC + 'ln_gemm_wgmma.cu', [MM + '497'], mm.ln_geglu, mm.ln_geglu_plain,
                     _within, TOL, h_shapes),
        'ln_dense': (CSRC + 'ln_gemm_wgmma.cu', [MM + '600'], mm.ln_dense, mm.ln_dense_plain,
                     _within, TOL, i_shapes),
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


def answer_requests(pipe, batches, what, size=SIZE):
    """Time txt2img requests at `size` px, 20 DPM++ 2M steps; check images."""
    for i, batch in enumerate(batches):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images = pipe.txt2img(PROMPT, NEGATIVE, width=size, height=size, num_steps=STEPS,
                              guidance_scale=GUIDANCE, sampler='dpm++_2m', seed=SEED + i,
                              batch_size=batch)
        seconds = time.perf_counter() - t0
        log(f'{what} {i}: txt2img {size}x{size} batch {batch}, {STEPS} DPM++ 2M steps, '
            f'guidance {GUIDANCE}: {seconds:.3f} s ({seconds / batch:.3f} s/image), '
            f'peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
            f'image mean {images.mean():.4f} std {images.std():.4f}')
        check(images.shape == (batch, size, size, 3), f'image shape {images.shape}')
        check(bool(torch.isfinite(torch.from_numpy(images)).all()), 'non-finite image')
        check(images.min() >= 0.0 and images.max() <= 1.0, 'image outside [0, 1]')


def warm_up(pipe, batches, size=SIZE):
    """A 2-step request at each batch size (cuDNN algorithm choice, lazy
    module loading, allocator), not counted or timed."""
    for batch in batches:
        pipe.txt2img(PROMPT, NEGATIVE, width=size, height=size, num_steps=2,
                     guidance_scale=GUIDANCE, seed=SEED, batch_size=batch)


def gib(module) -> float:
    return sum(p.numel() * p.element_size() for p in module.parameters()) / 2**30


def _check_launches(launches, expected, what):
    log(f'{what} launches against the configs\' reckoning: '
        + ', '.join(f'{k} {launches[k]} (reckoned {n})' for k, n in expected.items()))
    check(all(launches[k] == n for k, n in expected.items()),
          f'{what}: launch counts {launches} are not the reckoned {expected}')


def sdxl_phase(device):
    """SDXL txt2img at 1024 px, batch 1 and 4; returns the requests' launch
    counts and the pipeline."""
    from hcpdiff_tpu_torch.infer.pipeline import DiffusionPipeline
    from hcpdiff_tpu_torch.tools.random_sdxl import build_sdxl
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    unet, vae, te = build_sdxl(device, SEED)
    pipe = DiffusionPipeline(unet, vae, te)
    log(f'model build seconds (SDXL full width and depth, bf16, seed {SEED}): '
        f'{time.perf_counter() - t0:.2f}; weights GiB: unet {gib(unet):.3f}, vae {gib(vae):.3f}, '
        f'clip-L {gib(te.fe1.model):.3f}, bigG {gib(te.fe2.model):.3f}; build peak '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    warm_up(pipe, SDXL_REQUESTS, SDXL_SIZE)
    zero_counters()
    answer_requests(pipe, SDXL_REQUESTS, 'sdxl request', SDXL_SIZE)
    launches = read_counters('the SDXL requests', TXT2IMG_KERNELS, absent=FUSED_ONLY)
    _check_launches(launches, {k: n * len(SDXL_REQUESTS) for k, n in SDXL_LAUNCHES.items()},
                    'the SDXL requests')
    return launches, pipe


@torch.inference_mode()
def sdxl_reference_phase(pipe, device):
    """Card (bf16, kernels) vs CPU fp32 (plain versions) on the same
    weights: the SDXL text frontend at full width, and the SDXL UNet at
    full width with one transformer block a level on a [2, 64, 64, 4]
    latent, so that level 1 (S = 1024) runs kernel A."""
    from hcpdiff_tpu_torch.models.compose.sdxl_te import SDXLTextEncoderFrontend
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from hcpdiff_tpu_torch.tools.random_sdxl import build_model
    te = pipe.te
    te_cpu = SDXLTextEncoderFrontend(te.tokenizer, cpu_fp32(te.fe1.model),
                                     cpu_fp32(te.fe2.model))
    ctx, pooled = te.encode([NEGATIVE, PROMPT])
    ctx_cpu, pooled_cpu = te_cpu.encode([NEGATIVE, PROMPT])
    del te_cpu
    errs = {'sdxl text frontend hidden': rel_err(ctx, ctx_cpu),
            'sdxl text frontend pooled': rel_err(pooled, pooled_cpu)}
    cfg = dataclasses.replace(UNetConfig.sdxl(), transformer_layers_per_block=(1, 1, 1))
    unet = build_model(UNet2DCondition, cfg, device,
                       torch.Generator(device=device).manual_seed(SEED + 13))
    unet_cpu = cpu_fp32(unet)
    gen = torch.Generator().manual_seed(SEED + 14)
    lat = torch.randn(2, 64, 64, 4, generator=gen)
    t = torch.tensor([801, 301])
    tids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024], [768, 1024, 64, 0, 1024, 1024]])
    zero_counters()
    out = unet(lat.to(device), t.to(device), ctx, pooled_text_emb=pooled,
               time_ids=tids.to(device))
    read_counters('the SDXL UNet (one block a level) on the card', TXT2IMG_KERNELS,
                  absent=FUSED_ONLY)
    t0 = time.perf_counter()
    ref = unet_cpu(lat, t, ctx.float().cpu(), pooled_text_emb=pooled.float().cpu(),
                   time_ids=tids)
    log(f'SDXL UNet (one block a level) on the CPU in fp32: {time.perf_counter() - t0:.2f} s')
    errs['sdxl unet (1, 1, 1)'] = rel_err(out, ref)
    del unet, unet_cpu
    for name, err in errs.items():
        log(f'reference {name}: card bf16 vs cpu fp32 rel L2 err {err:.3e} '
            f'(limit {MODEL_REL_TOL})')
        check(err <= MODEL_REL_TOL, f'{name} rel err {err} > {MODEL_REL_TOL}')


def _cli(model_dir, out_dir, cfg, *extra):
    """One request through the entry point a user runs:
    python -m hcpdiff_tpu_torch.visualizer --cfg cfgs/infer/<cfg> ...
    (``cfg`` an absolute path: that file). Returns the Visualizer, the
    images and the request's seconds."""
    from hcpdiff_tpu_torch.infer.visualizer import main
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    path = cfg if os.path.isabs(cfg) else f'cfgs/infer/{cfg}'
    viser, images = main(['--cfg', path, f'pretrained_model={model_dir}',
                          f'output_dir={out_dir}', f'interface.0.save_root={out_dir}',
                          f'seed={VIS_SEED}', *extra])
    seconds = time.perf_counter() - t0
    log(f'visualizer {" ".join((cfg,) + extra)}: {seconds:.3f} s (main(): directory load '
        f'and PNG/YAML writes included), images {list(images.shape)}, peak '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; image mean {images.mean():.4f} '
        f'std {images.std():.4f}')
    check(bool(torch.isfinite(torch.from_numpy(images)).all()) and images.min() >= 0.0
          and images.max() <= 1.0, f'{cfg}: images not finite in [0, 1]')
    return viser, images, seconds


def _check_written(out_dir, images, what):
    """The interface's files: {n}-img.png and {n}-img.yaml for each image,
    the PNGs equal to the images x 255 as uint8."""
    from hcpdiff_tpu_torch.utils.images import read_png
    n = images.shape[0]
    names = sorted(os.listdir(out_dir))
    want = sorted([f'{i}-img.png' for i in range(n)] + [f'{i}-img.yaml' for i in range(n)])
    check(names == want, f'{what}: wrote {names}, not {want}')
    expect = (images.clip(0, 1) * 255).astype('uint8')
    for i in range(n):
        png = read_png(os.path.join(out_dir, f'{i}-img.png'))
        check((png == expect[i]).all(), f'{what}: {i}-img.png differs from the image')
    log(f'{what}: {n} PNGs and {n} YAMLs written; the PNGs read back equal the images')


@torch.inference_mode()
def _encode_check(viser, device):
    """The VAE encode of a 512 px image on the card: kernel A once, at the
    mid-block's [1, 1, 4096, 512], and kernel D at the encoder's 22
    GroupNorm shapes (forward hooks), nothing else; then the encode at
    256 px (S = 1024 at the mid block, so A runs) against the CPU in fp32."""
    from hcpdiff_tpu_torch.models.layers import GroupNorm
    from hcpdiff_tpu_torch.tools.time_kernels import ENC_GN_SHAPES
    vae = viser.pipe.vae
    seen, attn = [], []
    hooks = [m.register_forward_hook(
        lambda m, args, out: seen.append((args[0].shape[2] * args[0].shape[3],
                                          args[0].shape[1], m.fused_silu)))
        for m in vae.encoder.modules() if isinstance(m, GroupNorm)]
    hooks.append(vae.encoder.mid_attn.register_forward_hook(
        lambda m, args, out: attn.append(list(args[0].shape))))
    gen = torch.Generator().manual_seed(SEED + 21)
    img = torch.rand(1, SIZE, SIZE, 3, generator=gen) * 2 - 1
    try:
        zero_counters()
        lat = viser.pipe.encode(img)
        torch.cuda.synchronize()
        launches = read_counters('the VAE encode (512 px)', ('flash_attention', 'group_norm_silu'),
                                 absent=('geglu_dense', 'fused_dense') + FUSED_ONLY)
    finally:
        for h in hooks:
            h.remove()
    check(lat.shape == (1, SIZE // 8, SIZE // 8, 4), f'encode latent shape {lat.shape}')
    check(attn == [[1, 512, 64, 64]], f'encoder mid-block attention inputs {attn}')
    check(len(seen) == ENCODE_LAUNCHES['group_norm_silu']
          and set(seen) == {(S, C, silu) for _, S, C, silu in ENC_GN_SHAPES},
          f'encoder GroupNorm shapes {seen}')
    _check_launches(launches, ENCODE_LAUNCHES, 'the VAE encode')
    log(f'VAE encode: A at [1, 1, 4096, 512] once, D at {len(seen)} GroupNorms: '
        + ', '.join(f'[1, {S}, {C}]{"" if silu else " no silu"}' for S, C, silu in seen))
    small = img[:, ::2, ::2].contiguous()
    vae_cpu = cpu_fp32(vae)
    err = rel_err(vae.encode(small.to(device))[0], vae_cpu.encode(small)[0])
    del vae_cpu
    log(f'reference vae_encode (256 px): card bf16 vs cpu fp32 rel L2 err {err:.3e} '
        f'(limit {MODEL_REL_TOL})')
    check(err <= MODEL_REL_TOL, f'vae_encode rel err {err} > {MODEL_REL_TOL}')


def write_model_dir(device, tmp):
    """The seeded SD1.5 directory (F16) the visualizer and trainer phases load."""
    from hcpdiff_tpu_torch.tools.random_diffusers import write_dir
    model_dir = os.path.join(tmp, 'sd15')
    t0 = time.perf_counter()
    write_dir(model_dir, 'sd15', SEED, torch.float16, device)
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(model_dir)
               for f in fs)
    log(f'diffusers-layout SD1.5 directory (F16, seed {SEED}) written in '
        f'{time.perf_counter() - t0:.2f} s: {size / 2**30:.3f} GiB')
    return model_dir


@torch.no_grad()
def _check_loaded(world, modules, what):
    """Every tensor build_models loaded (bf16) equals the seeded original
    ``modules`` (unet, vae, te) rounded to fp16 (F16 files), then cast to
    the dtype it is held in; fatal otherwise."""
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition
    n = 0
    for key, orig in zip(('unet', 'vae', 'te'), modules):
        loaded = world[key].state_dict()
        ref = orig.state_dict()
        check(loaded.keys() == ref.keys(), f'{what} {key}: loaded names differ')
        for name, t in ref.items():
            fp32 = key == 'te' or (key == 'unet'
                                   and name.startswith(UNet2DCondition.FP32_CHILDREN))
            want = t.half().to(torch.float32 if fp32 else torch.bfloat16)
            check(torch.equal(loaded[name], want),
                  f'{what} {key}.{name} is not the seeded original rounded to fp16')
        n += len(ref)
        del orig, ref
    log(f'build_models ({what}): all {n} tensors equal the seeded originals rounded to fp16 '
        f'(UNet and VAE bf16, the UNet\'s time MLP and CLIP fp32)')


def visualizer_phase(device, model_dir, tmp):
    """The config-driven entry point on a diffusers-layout SD1.5 directory;
    returns the launch counts of its requests."""
    from hcpdiff_tpu_torch.models.factory import build_models
    from hcpdiff_tpu_torch.tools.random_sd15 import sd15_modules
    from hcpdiff_tpu_torch.utils.images import write_png
    t0 = time.perf_counter()
    world = build_models(model_dir, torch.bfloat16, device)
    log(f'build_models (bf16, cuda): {time.perf_counter() - t0:.2f} s')
    _check_loaded(world, sd15_modules(device, SEED), 'SD1.5')
    del world
    torch.cuda.empty_cache()

    zero_counters()
    viser, images, seconds = _cli(model_dir, os.path.join(tmp, 't2i'), 'text2img.yaml')
    launches = read_counters('the visualizer text2img request', TXT2IMG_KERNELS,
                             absent=FUSED_ONLY)
    _check_launches(launches, sd15_launches(STEPS), 'the visualizer text2img request')
    check(images.shape == (4, SIZE, SIZE, 3), f'text2img images {images.shape}')
    _check_written(os.path.join(tmp, 't2i'), images, 'text2img')
    c = viser.cfgs
    ref = viser.pipe.txt2img(c.prompt, c.neg_prompt, width=SIZE, height=SIZE,
                             num_steps=STEPS, guidance_scale=GUIDANCE, sampler='dpm++_2m',
                             seed=VIS_SEED, batch_size=4, return_latents=True)
    diff = float((ref - viser.last_latents).abs().max())
    log(f'text2img latents vs DiffusionPipeline.txt2img on the same modules: '
        f'max abs diff {diff}')
    check(torch.equal(ref, viser.last_latents), 'the CLI\'s latents differ from txt2img\'s')
    total = dict(launches)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    t0 = time.perf_counter()
    again = viser.vis_images(c.prompt, c.neg_prompt, seed=VIS_SEED)
    alone = time.perf_counter() - t0
    check((again == images).all(), 'a second text2img request differs')
    log(f'text2img request on the loaded Visualizer (vis_images: no load, no writes): '
        f'{alone:.3f} s for 4 images at 512 px')
    requests = {'text2img': seconds, 'text2img request alone': alone}
    runs = []
    for i in range(2):
        zero_counters()
        viser, images, seconds = _cli(model_dir, os.path.join(tmp, f'euler_a_{i}'),
                                      'euler_a.yaml')
        check(viser.cfgs.infer_args.sampler == 'euler_a', 'euler_a.yaml maps to euler_a')
        launches = read_counters(f'the visualizer euler_a request {i}', TXT2IMG_KERNELS,
                                 absent=FUSED_ONLY)
        _check_launches(launches, sd15_launches(STEPS), 'the euler_a request')
        add(launches)
        runs.append(images)
        requests[f'euler_a {i}'] = seconds
    check((runs[0] == runs[1]).all(), 'euler_a.yaml is not deterministic for a seed')
    log('euler_a: two requests at one seed give equal images')

    gen = torch.Generator().manual_seed(SEED + 22)
    init = (torch.rand(SIZE, SIZE, 3, generator=gen) * 255).to(torch.uint8).numpy()
    mask = torch.zeros(SIZE, SIZE, dtype=torch.uint8)
    mask[:, SIZE // 2:] = 255
    write_png(os.path.join(tmp, 'init.png'), init)
    write_png(os.path.join(tmp, 'mask.png'), mask.numpy())
    _encode_check(viser, device)
    steps = 30 - (30 - int(30 * 0.75))     # the configs' inference_steps and strength
    for cfg in ('img2img.yaml', 'inpaint.yaml'):
        zero_counters()
        viser, images, seconds = _cli(
            model_dir, os.path.join(tmp, cfg), cfg, f'init_image={os.path.join(tmp, "init.png")}',
            f'mask_image={os.path.join(tmp, "mask.png")}')
        launches = read_counters(f'the visualizer {cfg} request', TXT2IMG_KERNELS,
                                 absent=FUSED_ONLY)
        _check_launches(launches, sd15_launches(steps, encode=True),
                             f'the {cfg} request')
        check(images.shape == (1, SIZE, SIZE, 3), f'{cfg} images {images.shape}')
        _check_written(os.path.join(tmp, cfg), images, cfg)
        add(launches)
        requests[cfg] = seconds
    log('visualizer seconds (main() unless marked alone): '
        + ', '.join(f'{k} {v:.3f}' for k, v in requests.items())
        + f'; card: {gpu_name_and_power_limit()}')
    del viser
    torch.cuda.empty_cache()
    return total


# the trainer phase: lora_conventional.yaml through the training entry
# point on the visualizer phase's SD1.5 directory and 16 seeded PNGs, 10
# square and 6 at 3:2, which step_size 64 puts in 512x512 and 640x448
# buckets (latents 64x64 and 80x56: S = 4096 and 4480 at level 0, where A
# runs, and 1024 and 1120 at level 1, where 1120 % 128 != 0 takes the plain
# attention by the dispatch rule)
TRAINER_IMAGES = ((640, 640),) * 10 + ((768, 512),) * 6
TRAINER_STEPS, TRAINER_SAVE, FT_STEPS = 12, 6, 3
TRAINER_KERNELS = ('flash_attention', 'flash_attention_lse', 'flash_attention_bwd_dq',
                   'flash_attention_bwd_dkv', 'geglu_dense', 'fused_dense', 'group_norm_silu')


def flash_route(S):
    """The dispatch rule (ops/attention.py) for a self-attention of S tokens."""
    from hcpdiff_tpu_torch.ops.attention import takes_kernel
    return takes_kernel(S, S, 64)


def transformer_levels(cfg):
    """The level of each Transformer2D in the UNet's order, with its depth."""
    n, tl = len(cfg.block_out_channels), cfg.transformer_layers_per_block
    out = [(b, tl[b]) for b, t in enumerate(cfg.down_block_types)
           if t == 'CrossAttnDownBlock2D' for _ in range(cfg.layers_per_block)]
    out += [(n - 1, tl[n - 1])] if cfg.mid_cross_attn else []
    out += [(n - 1 - b, tl[n - 1 - b]) for b, t in enumerate(cfg.up_block_types)
            if t == 'CrossAttnUpBlock2D' for _ in range(cfg.layers_per_block + 1)]
    return out


def trainer_reckoning(cfg, step_shapes, encodes, vae_scale, enc_norms, unet_calls=1,
                      grad_temb=False, first_dq=True, policy='flash'):
    """The launches a config's run must make, from the UNet's config, each
    step's latent shape and the latent cache's encode calls. A step is
    ``unet_calls`` UNet calls (DreamArtist's two branches: 2) under remat:
    every block runs forward and again in the backward, except the first
    resblock when its inputs carry no gradient (SD's: its input and
    weights carry none, and the first LoRA is in the transformer after
    it), so autograd never recomputes it; with ``grad_temb`` (SDXL with a
    LoRA in the second text encoder: the pooled embedding, and so the
    time embedding every resblock takes, carries one) it is recomputed
    too; the recompute takes A's o and lse from the forward under the
    remat ``policy`` 'flash' (HCP_REMAT_POLICY's default) and launches A
    again under 'full'. So per call: A with its lse once ('flash') or
    twice ('full') and E and F once per self-attention whose S the kernel
    takes, E one fewer where the first
    transformer's queries carry no gradient (``first_dq`` False: no LoRA
    on its to_q, as in DreamArtist++.yaml); B and C twice per transformer
    block; D twice per GroupNorm of the resblocks and transformers (less
    the first resblock's two unless ``grad_temb``), plus the output norm
    once. Per encode call: A once where the VAE mid block's S (the
    latent's) is taken, and the encoder's ``enc_norms`` GroupNorms (22 in
    SD's VAE)."""
    n = len(cfg.block_out_channels)
    levels = transformer_levels(cfg)
    n_res = n * cfg.layers_per_block + 2 + n * (cfg.layers_per_block + 1)
    depth = sum(d for _, d in levels)
    out = dict.fromkeys(TRAINER_KERNELS, 0)
    for shapes in step_shapes:
        for _, h, w, _ in shapes:
            flash = sum(d for lvl, d in levels if flash_route((h >> lvl) * (w >> lvl)))
            first = levels[0][0]
            no_dq = int(not first_dq and flash_route((h >> first) * (w >> first)))
            runs = {'flash': 1, 'full': 2}[policy]
            for name, count in (('flash_attention', runs * flash),
                                ('flash_attention_lse', runs * flash),
                                ('flash_attention_bwd_dq', flash - no_dq),
                                ('flash_attention_bwd_dkv', flash), ('geglu_dense', 2 * depth),
                                ('fused_dense', 2 * depth),
                                ('group_norm_silu', 2 * (2 * n_res + len(levels))
                                 - (0 if grad_temb else 2) + 1)):
                out[name] += unet_calls * count
    for _, (w, h) in encodes:
        out['flash_attention'] += int(flash_route((h // vae_scale) * (w // vae_scale)))
        out['group_norm_silu'] += enc_norms
    return out


def write_dataset(root, sizes=TRAINER_IMAGES, seed=SEED + 30):
    """Seeded PNGs of ``sizes`` (w, h) with their captions in captions.json."""
    import numpy as np
    from hcpdiff_tpu_torch.utils.images import write_png
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    captions = {}
    for i, (w, h) in enumerate(sizes):
        write_png(os.path.join(root, f'img_{i:02d}.png'),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        captions[f'img_{i:02d}'] = f'a photo of a cat, picture {i}'
    with open(os.path.join(root, 'captions.json'), 'w') as f:
        json.dump(captions, f)


def train_args(cfg, model_dir, exp_dir, imgs, *extra):
    """The command line of one run of the entry point a user runs:
    python -m hcpdiff_tpu_torch.train --cfg cfgs/train/examples/<cfg> ..."""
    src = 'data.dataset1.source.data_source1'
    return ['--cfg', f'cfgs/train/examples/{cfg}',
            f'model.pretrained_model_name_or_path={model_dir}', f'exp_dir={exp_dir}',
            f'{src}.img_root={imgs}', f'{src}.caption_file={imgs}/captions.json',
            'data.dataset1.bucket.step_size=64', 'logger.0.log_step=1', *extra]


def _train_cli(*args):
    from hcpdiff_tpu_torch.trainer.trainer import main
    return main(train_args(*args))


def _trainer_shapes(trainer):
    """The kernels' shapes on the run's path, for the kernel records: the
    self-attention (B, H, S, D) A, E and F take at each bucket, the VAE
    encoder's mid-block attention of each encode call, the transformer
    levels' B and C products, and every GroupNorm (B, S, C, silu) of one
    UNet call at each bucket and of each encode call (forward hooks)."""
    from hcpdiff_tpu_torch.models.layers import GroupNorm
    cfg, ds = trainer.unet.cfg, trainer.datasets[0]
    buckets = sorted({shape for shapes in trainer.step_shapes for shape in shapes})
    attn, ffn = set(), set()
    for B, h, w, _ in buckets:
        for lvl, _ in transformer_levels(cfg):
            S, C = (h >> lvl) * (w >> lvl), cfg.block_out_channels[lvl]
            ffn.add((B * S, C))
            if flash_route(S):
                attn.add((B, cfg.num_heads[lvl], S, C // cfg.num_heads[lvl]))
    f = 2 ** (len(trainer.vae.cfg.block_out_channels) - 1)
    enc_attn = sorted({(n, 1, (h // f) * (w // f), trainer.vae.cfg.block_out_channels[-1])
                       for n, (w, h) in ds.encodes if flash_route((h // f) * (w // f))})
    seen = set()
    hooks = [m.register_forward_hook(lambda m, a, o: seen.add(
        (a[0].shape[0], a[0].shape[2] * a[0].shape[3], a[0].shape[1], m.fused_silu)))
        for m in list(trainer.unet.modules()) + list(trainer.vae.encoder.modules())
        if isinstance(m, GroupNorm)]
    dev = trainer.device
    try:
        with torch.no_grad():
            ctx = torch.zeros(1, 77, cfg.cross_attention_dim, device=dev)
            for B, h, w, c in buckets:
                extra = ({'pooled_text_emb': torch.zeros(B, trainer.te2.cfg.projection_dim,
                                                         device=dev),
                          'time_ids': torch.zeros(B, 6, device=dev)} if trainer.sdxl else {})
                trainer.unet(torch.zeros(B, h, w, c, device=dev), torch.tensor([500] * B,
                                                                                device=dev),
                             ctx.expand(B, -1, -1), **extra)
            for n, (w, h) in sorted(set(ds.encodes)):
                trainer.vae.encode(torch.zeros(n, h, w, 3, device=dev, dtype=trainer.dtype))
    finally:
        for hk in hooks:
            hk.remove()
    return {'attn': sorted(attn), 'enc_attn': enc_attn, 'ffn': sorted(ffn),
            'gn': sorted(seen)}


def trainer_phase(device, model_dir, tmp):
    """lora_conventional.yaml through main() at SD1.5 full width, 512 px,
    batch 4 (UNet LoRA rank 8, CLIP LoRA rank 4, constant_with_warmup,
    AdamW, clip 1.0, the latent cache, remat), 12 steps; its resume from
    the step-6 state; 3 steps of fine-tuning.yaml. Returns the run's
    launch counts and the shapes its kernels took."""
    import numpy as np
    from hcpdiff_tpu_torch.ckpt.diffusers_layout import to_port, unet_key_map
    from hcpdiff_tpu_torch.models.factory import load_state_dict
    from hcpdiff_tpu_torch.trainer.step import pack_leaves
    imgs = os.path.join(tmp, 'train_imgs')
    write_dataset(imgs)
    exp = os.path.join(tmp, 'exp')
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    trainer = _train_cli('lora_conventional.yaml', model_dir, exp, imgs,
                         f'train.train_steps={TRAINER_STEPS}', f'train.save_step={TRAINER_SAVE}')
    seconds = time.perf_counter() - t0
    launches = read_counters('the trainer run (lora_conventional.yaml)', TRAINER_KERNELS,
                             absent=FUSED_ONLY)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ds = trainer.datasets[0]
    buckets = sorted({s for shapes in trainer.step_shapes for s in shapes})
    log(f'trainer: main() {seconds:.3f} s: directory load {trainer.seconds["model load"]:.3f} s, '
        f'latent cache {trainer.seconds["latent cache"]:.3f} s ({len(ds._latent_cache)} latents '
        f'in {len(ds.encodes)} VAE calls {ds.encodes}); buckets {ds.bucket.used_sizes()}, '
        f'steps\' latents {[s[0] for s in trainer.step_shapes]}; peak {peak:.2f} GiB')
    check(trainer.dtype == torch.bfloat16 and trainer.unet.remat
          and trainer.unet.remat_policy == 'flash',
          'the run is bf16 with remat under the default policy (HCP_REMAT_POLICY=flash)')
    check(len(trainer.history) == TRAINER_STEPS
          and all(math.isfinite(x) for x in trainer.history),
          f'trainer losses {trainer.history}')
    check(buckets == [(4, 56, 80, 4), (4, 64, 64, 4)], f'trainer buckets {buckets}')
    from hcpdiff_tpu_torch.models.layers import GroupNorm
    vae = trainer.vae
    _check_launches(launches, trainer_reckoning(
        trainer.unet.cfg, trainer.step_shapes, ds.encodes,
        2 ** (len(vae.cfg.block_out_channels) - 1),
        sum(isinstance(m, GroupNorm) for m in vae.encoder.modules())), 'the trainer run')
    steps = np.diff(trainer.step_ends)                     # steps 2..12
    med = float(np.median(steps))
    log(f'trainer timed steps 2-{TRAINER_STEPS} (batch 4, 512 px and 640x448, LoRA UNet r8 + '
        f'CLIP r4, remat): median {med:.4f} s/step, min {steps.min():.4f}, max '
        f'{steps.max():.4f}, all {[round(float(x), 4) for x in steps]}; '
        f'{4 / med:.3f} samples/s; losses {[round(x, 5) for x in trainer.history]}; '
        f'card: {gpu_name_and_power_limit()}')
    ckpts = sorted(os.listdir(os.path.join(exp, 'ckpts')))
    want = sorted(f'{m}-{s}.safetensors' for m in ('unet', 'text_encoder')
                  for s in (TRAINER_SAVE, TRAINER_STEPS))
    check(ckpts == want, f'trainer checkpoints {ckpts}')
    pack = trainer.state.pack
    for name, key, alias in (('unet', 'lora_unet', 'unet'), ('text_encoder', 'lora_te', 'te')):
        loaded = trainer.ckpt_manager.load_ckpt(
            os.path.join(exp, 'ckpts', f'{name}-{TRAINER_STEPS}.safetensors'),
            aliases=trainer.aliases[alias])['lora']
        check(sorted(loaded) == sorted(pack[key]) and all(
            torch.equal(a.cpu(), b.detach().cpu())
            for a, b in zip(pack_leaves(loaded), pack_leaves(pack[key]))),
            f'{name}-{TRAINER_STEPS} does not load back as the final {key}')
        zero = [p for p, e in pack[key].items() if not bool(e['up'].any())]
        check(not zero, f'{key} up factors still zero: {zero[:3]}')
    log(f'trainer: {want} written; unet-{TRAINER_STEPS} and text_encoder-{TRAINER_STEPS} load '
        f'back through load_ckpt equal to the final pack; every LoRA up factor moved '
        f'({len(pack["lora_unet"])} UNet and {len(pack["lora_te"])} CLIP layers)')
    shapes = _trainer_shapes(trainer)
    final = [t.detach().clone() for t in pack_leaves(pack)]
    history = list(trainer.history)
    del trainer, pack
    torch.cuda.empty_cache()

    # (c) resume from a copy of the run stopped at step 6
    cut = os.path.join(tmp, 'exp_cut')
    shutil.copytree(exp, cut)
    os.remove(os.path.join(cut, 'state', f'state_{TRAINER_STEPS}.pt'))
    for m in ('unet', 'text_encoder'):
        os.remove(os.path.join(cut, 'ckpts', f'{m}-{TRAINER_STEPS}.safetensors'))
    rest = _train_cli('lora_conventional.yaml', model_dir, cut, imgs,
                      f'train.train_steps={TRAINER_STEPS}', f'train.save_step={TRAINER_SAVE}',
                      'train.resume.auto=true')
    check(rest.start_step == TRAINER_SAVE, f'resumed at step {rest.start_step}')
    resumed = [t.detach() for t in pack_leaves(rest.state.pack)]
    bitwise = rest.history == history[TRAINER_SAVE:] and all(
        torch.equal(a, b) for a, b in zip(resumed, final))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(rest.history, history[TRAINER_SAVE:]))
    lora_err = {f: float(torch.cat([a.flatten() - b.flatten() for a, b, k in zip(
        resumed, final, _leaf_kinds(rest.state.pack)) if k == f]).norm() / torch.cat(
        [b.flatten() for b, k in zip(final, _leaf_kinds(rest.state.pack)) if k == f]).norm())
        for f in ('down', 'up')}
    want = [round(x, 5) for x in history[TRAINER_SAVE:]]
    log(f'trainer resume from step {TRAINER_SAVE}: steps {TRAINER_SAVE + 1}-{TRAINER_STEPS} '
        f'losses {[round(x, 5) for x in rest.history]} against {want}; bitwise equal (losses '
        f'and final LoRA): {bitwise}; max rel loss diff {loss_err:.3e}, LoRA rel L2 diff '
        f'{lora_err} (diagnostics only: the check is bitwise)')
    check(bitwise, f'the resumed run differs from the uninterrupted one: max rel loss diff '
          f'{loss_err}, LoRA rel L2 diff {lora_err}')
    del rest, resumed, final
    torch.cuda.empty_cache()

    # (d) fine-tuning.yaml: every UNet weight trainable (fp32 master, AdamW)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ft = _train_cli('fine-tuning.yaml', model_dir, os.path.join(tmp, 'exp_ft'), imgs,
                    f'train.train_steps={FT_STEPS}', f'train.save_step={FT_STEPS}')
    seconds = time.perf_counter() - t0
    sub = ft.state.pack['unet_ft']
    n_params = sum(t.numel() for t in sub.values())
    check(len(sub) == len(list(ft.unet.parameters())), 'fine-tuning trains every UNet weight')
    check(len(ft.history) == FT_STEPS and all(math.isfinite(x) for x in ft.history),
          f'fine-tuning losses {ft.history}')
    orig = to_port(load_state_dict(os.path.join(model_dir, 'unet')), unet_key_map(ft.unet.cfg),
                   model_dir)
    moved = sum(int(not torch.equal(t.detach().cpu(), orig[n].float())) for n, t in sub.items())
    log(f'trainer fine-tuning.yaml: {FT_STEPS} steps, {len(sub)} tensors / {n_params} weights '
        f'trainable, losses {[round(x, 5) for x in ft.history]}, {moved} of {len(sub)} tensors '
        f'moved from the directory\'s; main() {seconds:.3f} s, step seconds '
        f'{[round(float(x), 4) for x in np.diff(ft.step_ends)]}, peak '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    check(moved == len(sub), f'fine-tuning moved {moved} of {len(sub)} tensors')
    del ft, sub, orig
    torch.cuda.empty_cache()
    return launches, shapes


# the server phase: python -m hcpdiff_tpu_torch.server's parts on the
# trainer phase's LoRAs over the same directory
SERVER_TOKEN = 'smoke-reload-token'
SERVER_REQUESTS = (4, 1, 4)       # batch sizes of the served requests
SERVER_SEED = 11
# the card's merge (fp32, then cast) against the fp64 merge of the files:
# a bf16 weight within half a bf16 ulp (2^-8 relative) plus fp32 rounding,
# an fp32 one within 1e-6 relative
MERGE_BF16_RTOL, MERGE_FP32_RTOL, MERGE_ATOL_REL = 2.0 ** -8, 1e-6, 1e-6
EMB_WORD = 'hcpsmoke'


def _http(port, method, path, body=None, token=None):
    """(status, JSON body) of one request to the server on this host."""
    import http.client
    c = http.client.HTTPConnection('127.0.0.1', port, timeout=600)
    try:
        c.request(method, path, body=None if body is None else json.dumps(body),
                  headers={'X-Auth-Token': token} if token else {})
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def _served_images(out):
    import base64
    import numpy as np
    from hcpdiff_tpu_torch.utils.images import decode_png
    return np.stack([decode_png(base64.b64decode(b)) for b in out['images']])


def _uint8(images):
    import numpy as np
    return (np.clip(images, 0, 1) * 255).astype(np.uint8)


@torch.no_grad()
def _check_merge(world, model_dir, files, alpha):
    """Every weight of every LoRA'd layer on the card against base + alpha
    * delta computed on the CPU in fp64 from the directory and the files
    (the UNet's in bf16, CLIP's in fp32), and every other weight equal to
    the directory's, cast as the loader casts it."""
    from hcpdiff_tpu_torch.ckpt.diffusers_layout import (clip_canonical, clip_key_map, to_port,
                                                         unet_key_map)
    from hcpdiff_tpu_torch.ckpt.manager import CkptManagerSafe
    from hcpdiff_tpu_torch.models.factory import load_state_dict
    out = {}
    for key, sub, rtol in (('unet', 'unet', MERGE_BF16_RTOL), ('te', 'text_encoder',
                                                                MERGE_FP32_RTOL)):
        module = world[key]
        sd = load_state_dict(os.path.join(model_dir, sub))
        base = (to_port(sd, unet_key_map(module.cfg), sub) if key == 'unet'
                else to_port(clip_canonical(sd), clip_key_map(module.cfg), sub))
        overlay = CkptManagerSafe().load_ckpt(files[key], aliases=world['aliases'][key])['lora']
        held = module.state_dict()
        worst, n_rounded = 0.0, 0
        for path, e in overlay.items():
            name = f'{path}.weight'
            w = base[name].double()
            delta = ((e['up'].double() @ e['down'].double()) * (e['alpha'].double()
                                                               / e['down'].shape[0]) * alpha)
            ref = w + delta.reshape(w.shape)
            got = held[name].double().cpu()
            err = (got - ref).abs()
            lim = rtol * ref.abs() + MERGE_ATOL_REL * float(ref.abs().max())
            worst = max(worst, float((err / lim).max()))
            check(bool((err <= lim).all()), f'merged {key} {name}: max err {float(err.max())}')
            n_rounded += int(torch.equal(held[name].cpu(), ref.to(held[name].dtype)))
        names = {f'{p}.weight' for p in overlay}
        same = all(torch.equal(held[n].cpu(), base[n].to(held[n].dtype)) for n in held
                   if n not in names)
        check(same, f'{key}: a weight no LoRA touches differs from the directory\'s')
        out[key] = (len(overlay), n_rounded, worst)
        log(f'server merge check {key} (alpha {alpha}): {len(overlay)} LoRA\'d layers within '
            f'{rtol:.3g} relative of the fp64 merge (worst at {worst:.3f} of the limit), '
            f'{n_rounded} bitwise equal to it rounded to {held[name].dtype}; the other '
            f'{len(held) - len(names)} tensors equal the directory\'s')
    return out


def _big_lora(world, path, seed):
    """A seeded UNet LoRA (rank 8 on LORA_PATTERNS' layers) with large up
    factors, written by the port's save_model_with_lora: an effect that
    shows in the images."""
    from hcpdiff_tpu_torch.adapt.overlay import make_lora_overlay
    from hcpdiff_tpu_torch.ckpt.manager import CkptManagerSafe
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition
    with torch.device('meta'):                  # the module tree and shapes only
        unet = UNet2DCondition(world['unet'].cfg)
    gen = torch.Generator().manual_seed(seed)
    ov, _ = make_lora_overlay(gen, unet, [{'layers': LORA_PATTERNS, 'rank': 8}])
    for e in ov.values():
        e['up'] = torch.randn(e['up'].shape, generator=gen) * 0.5
    CkptManagerSafe().save_model_with_lora(path, unet, lora_overlay=ov,
                                           aliases=world['aliases']['unet'])
    return path


def server_phase(device, model_dir, tmp):
    """python -m hcpdiff_tpu_torch.server's parts at SD1.5 full width, 512
    px, bf16 on the trainer phase's unet-12/text_encoder-12 LoRAs at alpha
    0.8 (text2img_lora.yaml): merge at load, precompile, /health, served
    requests (PNGs bitwise vis_images', launches as reckoned, merged weights
    against the fp64 merge), /reload without and with the token, a reload
    of the recipe against a fresh Visualizer, save_model and its load, a
    large seeded LoRA, DreamArtist's negative branch and an emb_dir word.
    Returns the phase's launch counts."""
    import threading
    from http.server import ThreadingHTTPServer
    import numpy as np
    from hcpdiff_tpu_torch.ckpt.formats import save_webui_embedding
    from hcpdiff_tpu_torch.config import load, to_plain
    from hcpdiff_tpu_torch.infer.visualizer import Visualizer
    from hcpdiff_tpu_torch.models import factory
    from hcpdiff_tpu_torch.server import InferenceServer, make_handler, png_b64
    ckpts = os.path.join(tmp, 'exp', 'ckpts')
    files = {'unet': os.path.join(ckpts, f'unet-{TRAINER_STEPS}.safetensors'),
             'te': os.path.join(ckpts, f'text_encoder-{TRAINER_STEPS}.safetensors')}
    out_dir, emb_dir = os.path.join(tmp, 'server_out'), os.path.join(tmp, 'embs')
    over = [f'pretrained_model={model_dir}', f'output_dir={out_dir}',
            f'interface.0.save_root={out_dir}', f'seed={SERVER_SEED}', 'bs=4', 'emb_dir=null',
            f'merge.group1.lora.0.path={files["unet"]}',
            f'merge.group2.lora.0.path={files["te"]}']
    cfgs = load('cfgs/infer/text2img_lora.yaml', over)
    total = {name: 0 for name in counters()}

    def segment(what, expect=None, kernels=TXT2IMG_KERNELS):
        launches = read_counters(what, kernels, absent=FUSED_ONLY)
        if expect is not None:
            _check_launches(launches, expect, what)
        for k, v in launches.items():
            total[k] += v
        zero_counters()
        return launches

    reads = []
    load_state_dict = factory.load_state_dict

    def counted(path):
        reads.append(path)
        return load_state_dict(path)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    factory.load_state_dict = counted
    t0 = time.perf_counter()
    try:
        srv = InferenceServer(cfgs, reload_token=SERVER_TOKEN)
    finally:
        factory.load_state_dict = load_state_dict
    build_s = time.perf_counter() - t0
    viser = srv.viser
    world = viser.world
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'server start: InferenceServer {build_s:.3f} s ({len(reads)} weight directories read; '
        f'merge at load {viser.merge_seconds:.3f} s: {len(viser._written["unet"])} UNet and '
        f'{len(viser._written["te"])} CLIP tensors merged); peak {peak:.2f} GiB, held '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB (the fp32 base kept on the card); '
        f'card: {gpu_name_and_power_limit()}')
    check(len(reads) == 3, f'the start read {len(reads)} weight directories, not 3')
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), make_handler(srv))
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        srv.precompile()
        log(f'server precompile (the config\'s setting, batch 4): '
            f'{time.perf_counter() - t0:.3f} s')
        segment('the server precompile', sd15_launches(STEPS, decode=False))

        status, health = _http(port, 'GET', '/health')
        log(f'server /health: {status} {health}')
        check(status == 200 and health == {'status': 'ok', 'backend': 'cuda', 'devices': 1,
                                           'device_name': torch.cuda.get_device_name(0)},
              f'/health answered {status} {health}')

        def request(bs, seed, prompt=PROMPT):
            body = {'prompt': prompt, 'negative_prompt': NEGATIVE, 'width': SIZE,
                    'height': SIZE, 'steps': STEPS, 'cfg_scale': GUIDANCE, 'seed': seed,
                    'sampler': 'dpm++_2m', 'bs': bs}
            t0 = time.perf_counter()
            status, out = _http(port, 'POST', '/txt2img', body)
            seconds = time.perf_counter() - t0
            check(status == 200 and out.get('seed') == seed and len(out['images']) == bs,
                  f'/txt2img answered {status}: {str(out)[:300]}')
            images = _served_images(out)
            check(images.shape == (bs, SIZE, SIZE, 3), f'served images {images.shape}')
            return images, seconds

        served, plain_s = [], {}
        for i, bs in enumerate(SERVER_REQUESTS):
            images, seconds = request(bs, SERVER_SEED + i)
            served.append(images)
            plain_s.setdefault(bs, []).append(seconds)
            log(f'server /txt2img {i}: batch {bs}, {SIZE} px, {STEPS} DPM++ 2M steps: '
                f'{seconds:.3f} s (HTTP, PNG and base64 included)')
        segment('the served requests', {k: n * len(SERVER_REQUESTS)
                                        for k, n in sd15_launches(STEPS).items()})
        t0 = time.perf_counter()
        imgs = viser.vis_images(PROMPT, NEGATIVE, width=SIZE, height=SIZE,
                                inference_steps=STEPS, guidance_scale=GUIDANCE,
                                sampler='dpm++_2m', seed=SERVER_SEED, bs=SERVER_REQUESTS[0])
        alone_s = time.perf_counter() - t0
        segment('vis_images at the first request\'s seed', sd15_launches(STEPS))
        t0 = time.perf_counter()
        encoded = [png_b64(i) for i in imgs]
        png_s = time.perf_counter() - t0
        check(np.array_equal(served[0], _uint8(imgs)),
              'the first served PNGs differ from vis_images\' uint8 at the same seed')
        log(f'server: the first response\'s PNGs (read_png\'s decoder) are bitwise the uint8 '
            f'of vis_images at the same seed; that vis_images call on the main thread '
            f'{alone_s:.3f} s, its {len(encoded)} PNGs and base64 {png_s:.3f} s '
            f'({sum(map(len, encoded)) / 2**20:.2f} MiB of base64)')
        _check_merge(world, model_dir, files, 0.8)

        status, _ = _http(port, 'POST', '/reload', to_plain(cfgs))
        check(status == 403, f'/reload without the token answered {status}')
        log('server /reload without X-Auth-Token: 403')

        def reload(what, new):
            reads.clear()
            factory.load_state_dict = counted
            t0 = time.perf_counter()
            try:
                status, out = _http(port, 'POST', '/reload', new, SERVER_TOKEN)
            finally:
                factory.load_state_dict = load_state_dict
            seconds = time.perf_counter() - t0
            check(status == 200 and out == {'reloaded': True, 'full_rebuild': False},
                  f'/reload ({what}) answered {status} {out}')
            check(not reads, f'/reload ({what}) read {reads}')
            check(viser.world['unet'] is world['unet'] and viser.world['te'] is world['te'],
                  f'/reload ({what}) replaced the modules')
            log(f'server /reload ({what}): {seconds:.3f} s (merge {viser.merge_seconds:.3f} s), '
                f'no directory read, the same module objects')
            return seconds

        def with_merge(unet_loras, alpha, **top):
            new = to_plain(cfgs)
            new['merge']['group1']['lora'] = unet_loras
            new['merge']['group2']['lora'][0]['alpha'] = alpha
            new.update(top)
            return new

        base_lora = [{'path': files['unet'], 'alpha': 0.4}]
        reload('alpha 0.4', with_merge(base_lora, 0.4))
        request(4, SERVER_SEED)
        latents = viser.last_latents.clone()
        segment('a request at alpha 0.4', sd15_launches(STEPS))
        _check_merge(world, model_dir, files, 0.4)
        fresh_over = over + ['merge.group1.lora.0.alpha=0.4', 'merge.group2.lora.0.alpha=0.4']
        t0 = time.perf_counter()
        fresh = Visualizer(load('cfgs/infer/text2img_lora.yaml', fresh_over))
        fresh_s = time.perf_counter() - t0
        fresh.vis_images(PROMPT, NEGATIVE, width=SIZE, height=SIZE, inference_steps=STEPS,
                         guidance_scale=GUIDANCE, sampler='dpm++_2m', seed=SERVER_SEED, bs=4)
        segment('a fresh Visualizer\'s request at alpha 0.4', sd15_launches(STEPS))
        check(torch.equal(fresh.last_latents, latents),
              'the reloaded recipe\'s latents differ from a fresh Visualizer\'s')
        log(f'server: latents after the reload to alpha 0.4 equal a fresh Visualizer\'s at '
            f'alpha 0.4 bitwise (its build {fresh_s:.3f} s)')
        del fresh
        torch.cuda.empty_cache()

        saved = os.path.join(tmp, 'saved_model')
        t0 = time.perf_counter()
        viser.save_model(saved)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(saved)
                   for f in fs)
        t0 = time.perf_counter()
        loaded = Visualizer(load('cfgs/infer/text2img.yaml', [
            f'pretrained_model={saved}', f'output_dir={out_dir}',
            f'interface.0.save_root={out_dir}', 'emb_dir=null']))
        load_s = time.perf_counter() - t0
        check(not loaded.cfgs.get('merge'), 'the saved model loads with no merge block')
        loaded.vis_images(PROMPT, NEGATIVE, width=SIZE, height=SIZE, inference_steps=STEPS,
                          guidance_scale=GUIDANCE, sampler='dpm++_2m', seed=SERVER_SEED, bs=4)
        segment('the saved model\'s request', sd15_launches(STEPS))
        check(torch.equal(loaded.last_latents, latents),
              'the saved model\'s latents differ from the merged request\'s')
        log(f'server save_model: {save_s:.3f} s, {size / 2**30:.3f} GiB '
            f'({sorted(os.listdir(saved))}); loaded with no merge block in {load_s:.3f} s, its '
            f'latents equal the merged request\'s bitwise')
        del loaded
        shutil.rmtree(saved)
        torch.cuda.empty_cache()

        big = _big_lora(world, os.path.join(tmp, 'big_lora.safetensors'), SEED + 30)
        reload('a large seeded LoRA', with_merge(base_lora + [{'path': big, 'alpha': 1.0}], 0.4))
        moved, _ = request(1, SERVER_SEED + 1)
        segment('a request with the large LoRA', sd15_launches(STEPS))
        diff = float(np.abs(moved.astype(np.float32) - served[1].astype(np.float32)).mean())
        log(f'server: the large seeded LoRA moves the batch-1 image by {diff:.2f} of 255 '
            f'on average')
        check(diff > 1.0, f'the large LoRA moved the image by only {diff} of 255')

        neg = _big_lora(world, os.path.join(tmp, 'neg_lora.safetensors'), SEED + 32)
        reload('a branch: n LoRA', with_merge(
            base_lora + [{'path': neg, 'alpha': 0.65, 'branch': 'n'}], 0.4))
        check(viser.pipe.unet_params_neg is not None, 'no negative branch after the reload')
        n_neg = len(viser.pipe.unet_params_neg)
        da_s = {}
        for bs in (1, 4):
            images, da_s[bs] = request(bs, SERVER_SEED + 5)
            segment(f'a DreamArtist request at batch {bs}', sd15_launches(STEPS, unet_calls=2))
        log(f'server DreamArtist (negative branch over {n_neg} tensors): batch 1 '
            f'{da_s[1]:.3f} s, batch 4 {da_s[4]:.3f} s; plain batch 1 '
            f'{min(plain_s[1]):.3f} s, batch 4 {min(plain_s[4]):.3f} s; UNet launches twice '
            f'a plain request\'s a step')

        os.makedirs(emb_dir)
        vecs = torch.randn(2, world['te_cfg'].hidden_size,
                           generator=torch.Generator().manual_seed(SEED + 40)) * 0.02
        save_webui_embedding(os.path.join(emb_dir, f'{EMB_WORD}.pt'), vecs.numpy(), EMB_WORD)
        reload('emb_dir', with_merge(base_lora, 0.4, emb_dir=emb_dir))
        seen = []
        hook = world['te'].register_forward_pre_hook(
            lambda m, args, kw: seen.append((args[0], kw.get('emb_ext'))), with_kwargs=True)
        try:
            images, emb_s = request(1, SERVER_SEED + 6, f'a photo of {EMB_WORD} cat')
        finally:
            hook.remove()
        segment('a request with an emb_dir word', sd15_launches(STEPS))
        ids = viser.tokenizer.added_tokens[EMB_WORD]
        V = world['te_cfg'].vocab_size
        check(ids == [V, V + 1], f'{EMB_WORD} ids {ids}')
        input_ids, emb_ext = seen[0]
        where = torch.isin(input_ids, torch.tensor(ids, device=input_ids.device))
        rows = world['te'].embed_tokens(input_ids, emb_ext)[where]
        check(int(where.sum()) == 2 and torch.equal(rows.cpu(), vecs),
              'the CLIP input rows at the word\'s ids are not the file\'s vectors')
        log(f'server emb_dir: {EMB_WORD} -> ids {ids}; the CLIP input rows there equal the '
            f'file\'s 2 vectors; the request ({emb_s:.3f} s) gave finite images')
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), 'the server thread did not stop')
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'server phase peak {peak:.2f} GiB; launches {total}; card: {gpu_name_and_power_limit()}')
    del srv, viser, world
    torch.cuda.empty_cache()
    return total


# phase 4g: the rest of the train step. lora_sdxl.yaml on the seeded
# full-width SDXL world: 4 square PNGs at 1024 px and 2 at 1216x832, which
# step_size 64 puts in a 1024x1024 bucket (latent 128x128: S = 4096 at
# level 1 and 1024 at level 2, both on kernel A's route at D = 64) and a
# 1216x832 one (S = 3952 and 988: the plain attention)
SDXL_TRAIN_IMAGES = ((1024, 1024),) * 4 + ((1216, 832),) * 2
SDXL_TRAIN_STEPS = 6
SDXL_TRAIN_BUCKETS = [(1, 104, 152, 4), (1, 128, 128, 4)]
# the SDXL gradient check: one transformer block a level, a 64x64 latent
# (S = 1024 at level 1: A with lse, E and F at D = 64)
SDXL_GRAD_LATENT = 64
DA_STEPS = 4
DA_WORDS = (('pt-dog1', 'a photo of dog'), ('pt-dog1-neg', 'blurry, low quality'))


def _loads_back(trainer, exp, step, parts):
    """Each part's ckpts/<name>-<step>.safetensors loads back through
    load_ckpt equal to the final pack's LoRA (fatal otherwise)."""
    from hcpdiff_tpu_torch.trainer.step import pack_leaves
    names = {'unet': 'unet', 'te': 'text_encoder', 'te2': 'text_encoder_2'}
    pack = trainer.state.pack
    for part in parts:
        key = f'lora_{part}'
        loaded = trainer.ckpt_manager.load_ckpt(
            os.path.join(exp, 'ckpts', f'{names[part]}-{step}.safetensors'),
            aliases=trainer.aliases[part])['lora']
        check(sorted(loaded) == sorted(pack[key]) and all(
            torch.equal(a.cpu(), b.detach().cpu())
            for a, b in zip(pack_leaves(loaded), pack_leaves(pack[key]))),
            f'{names[part]}-{step} does not load back as the final {key}')


def _ups_moved(pack, keys, unused=()):
    """Every LoRA up factor of ``keys`` left zero, except those of the
    layers ``unused`` (path prefixes), which must not have."""
    for key in keys:
        idle = {p for p in pack[key] if p.startswith(tuple(unused))}
        zero = {p for p, e in pack[key].items() if not bool(e['up'].any())}
        check(zero == idle, f'{key} up factors still zero: {sorted(zero - idle)[:3]}; moved '
              f'where no gradient reaches: {sorted(idle - zero)[:3]}')


def sdxl_trainer_phase(device, tmp):
    """cfgs/train/examples/lora_sdxl.yaml through the port's config loader
    and Trainer(cfgs, world=...) on tools/random_sdxl.py's seeded SDXL
    world at full width and depth (UNet LoRA r8, CLIP-L and bigG LoRA r4,
    bf16, remat, the latent cache, crop-info time_ids, batch 1), 6 steps
    saving at 6. Returns the run's launches, those of its first 1024 px
    step (the counters read around each step) and the shapes its kernels
    took."""
    import numpy as np
    from hcpdiff_tpu_torch.config import load
    from hcpdiff_tpu_torch.models.layers import GroupNorm
    from hcpdiff_tpu_torch.tools.random_sdxl import sdxl_world
    from hcpdiff_tpu_torch.trainer.trainer import Trainer
    imgs, exp = os.path.join(tmp, 'sdxl_imgs'), os.path.join(tmp, 'exp_sdxl')
    write_dataset(imgs, SDXL_TRAIN_IMAGES, SEED + 50)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    world = sdxl_world(device, SEED)
    build_s = time.perf_counter() - t0
    src = 'data.dataset1.source.data_source1'
    cfgs = load('cfgs/train/examples/lora_sdxl.yaml', [
        f'exp_dir={exp}', f'{src}.img_root={imgs}', f'{src}.caption_file={imgs}/captions.json',
        'data.dataset1.bucket.step_size=64', 'logger.0.log_step=1',
        f'train.train_steps={SDXL_TRAIN_STEPS}', f'train.save_step={SDXL_TRAIN_STEPS}'])
    zero_counters()
    t0 = time.perf_counter()
    trainer = Trainer(cfgs, world=world)
    step_fn, per_step, batch_1024 = trainer._train_step, [], []

    def counted_step(state, frozen, batch, *args, **kw):
        if tuple(batch['latents'].shape) == SDXL_TRAIN_BUCKETS[1] and not batch_1024:
            batch_1024.append(batch)
        before = {name: fn.launches for name, fn in counters().items()}
        out = step_fn(state, frozen, batch, *args, **kw)
        per_step.append((tuple(batch['latents'].shape), {
            name: fn.launches - before[name] for name, fn in counters().items()}))
        return out
    trainer._train_step = counted_step
    try:
        trainer.train()
    finally:
        trainer.loggers.close()
    seconds = time.perf_counter() - t0
    launches = read_counters('the SDXL trainer run (lora_sdxl.yaml)', TRAINER_KERNELS,
                             absent=FUSED_ONLY)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ds = trainer.datasets[0]
    buckets = sorted({s for shapes in trainer.step_shapes for s in shapes})
    log(f'sdxl trainer: world build {build_s:.3f} s; Trainer build and train {seconds:.3f} s: '
        f'latent cache {trainer.seconds["latent cache"]:.3f} s ({len(ds._latent_cache)} latents '
        f'in {len(ds.encodes)} VAE calls {ds.encodes}); steps\' latents '
        f'{[s[0] for s in trainer.step_shapes]}; peak {peak:.2f} GiB')
    check(trainer.sdxl and trainer.dtype == torch.bfloat16 and trainer.unet.remat
          and trainer.unet.remat_policy == 'flash' and ds.with_crop_info,
          'the SDXL run is bf16 with remat under the default policy (HCP_REMAT_POLICY=flash) '
          'and crop-info time_ids')
    check(len(trainer.history) == SDXL_TRAIN_STEPS
          and all(math.isfinite(x) for x in trainer.history),
          f'sdxl trainer losses {trainer.history}')
    check(buckets == SDXL_TRAIN_BUCKETS, f'sdxl trainer buckets {buckets}')
    enc_norms = sum(isinstance(m, GroupNorm) for m in trainer.vae.encoder.modules())
    vae_scale = 2 ** (len(trainer.vae.cfg.block_out_channels) - 1)
    _check_launches(launches, trainer_reckoning(trainer.unet.cfg, trainer.step_shapes,
                                                ds.encodes, vae_scale, enc_norms,
                                                grad_temb=True), 'the SDXL trainer run')
    check([shape for shape, _ in per_step] == [s[0] for s in trainer.step_shapes],
          'the SDXL run\'s counted steps are its steps')
    for i, (shape, counts) in enumerate(per_step):
        _check_launches(counts, trainer_reckoning(trainer.unet.cfg, [[shape]], [], vae_scale,
                                                  enc_norms, grad_temb=True),
                        f'the SDXL trainer\'s step {i + 1} at {shape}')
    step_1024 = next(c for shape, c in per_step if shape == SDXL_TRAIN_BUCKETS[1])
    steps = np.diff(trainer.step_ends)
    med = float(np.median(steps))
    log(f'sdxl trainer timed steps 2-{SDXL_TRAIN_STEPS} (batch 1, 1024 px and 1216x832, LoRA '
        f'UNet r8 + CLIP-L/bigG r4, remat): median {med:.4f} s/step, min {steps.min():.4f}, '
        f'max {steps.max():.4f}, all {[round(float(x), 4) for x in steps]}; {1 / med:.3f} '
        f'samples/s; a 1024 px step launches {step_1024}; losses '
        f'{[round(x, 5) for x in trainer.history]}; card: {gpu_name_and_power_limit()}')
    ckpts = sorted(os.listdir(os.path.join(exp, 'ckpts')))
    want = sorted(f'{m}-{SDXL_TRAIN_STEPS}.safetensors'
                  for m in ('unet', 'text_encoder', 'text_encoder_2'))
    check(ckpts == want, f'sdxl trainer checkpoints {ckpts}')
    _loads_back(trainer, exp, SDXL_TRAIN_STEPS, ('unet', 'te', 'te2'))
    # CLIP-L gives only its hidden states clip_skip layers from the top (the
    # pooled embedding is bigG's), so no gradient reaches the layers above
    n, skip = trainer.te.cfg.num_hidden_layers, trainer.frontend.fe1.clip_skip
    unused = [f'layers_{i}.' for i in range(n - skip, n)]
    _ups_moved(trainer.state.pack, ('lora_unet', 'lora_te2'))
    _ups_moved(trainer.state.pack, ('lora_te',), unused)
    log(f'sdxl trainer: {want} written and loading back equal to the final pack; every LoRA '
        f'up factor moved ({len(trainer.pack["lora_unet"])} UNet, {len(trainer.pack["lora_te"])} '
        f'CLIP-L and {len(trainer.pack["lora_te2"])} bigG layers) but CLIP-L\'s {unused}, above '
        f'the layer its hidden states come from, which stayed zero')
    def sdxl_step():
        trainer.state, metrics = step_fn(trainer.state, trainer.frozen, batch_1024[0],
                                         trainer.generator)
        return metrics['loss']
    policy_steps = _remat_policy_steps(
        trainer.unet, sdxl_step, lambda policy: trainer_reckoning(
            trainer.unet.cfg, [[SDXL_TRAIN_BUCKETS[1]]], [], vae_scale, enc_norms,
            grad_temb=True, policy=policy), f'a {SDXL_TRAIN_BUCKETS[1]} SDXL LoRA step')
    check(policy_steps['full']['flash_attention_lse']
          == 2 * step_1024['flash_attention_lse'] > 0,
          f'a 1024 px step under HCP_REMAT_POLICY=full launches A with lse '
          f'{policy_steps["full"]["flash_attention_lse"]} times, not twice the default\'s '
          f'{step_1024["flash_attention_lse"]}')
    shapes = _trainer_shapes(trainer)
    level12 = {(h >> 1) * (w >> 1) for _, h, w, _ in SDXL_TRAIN_BUCKETS[1:]} | {
        (h >> 2) * (w >> 2) for _, h, w, _ in SDXL_TRAIN_BUCKETS[1:]}
    shapes = {'attn': shapes['attn'], 'enc_attn': [],
              'ffn': [(M, C) for M, C in shapes['ffn'] if M in level12],
              'gn': [g for g in shapes['gn'] if g[1] in level12]}
    del trainer, world, ds
    torch.cuda.empty_cache()
    return launches, step_1024, shapes


def _remat_policy_steps(unet, run_step, reckoning, what, rounds=3):
    """One LoRA step (``run_step()`` -> its loss) under HCP_REMAT_POLICY full
    and flash in turns (full, flash, ...), ``rounds`` of each, every step's
    launches held to ``reckoning(policy)``; prints each policy's step
    seconds and peak memory and returns the launches of a step under each.
    The UNet's policy is put back to flash."""
    seconds, peak, counts = {'flash': [], 'full': []}, {}, {}
    for policy in ('full', 'flash') * rounds:
        unet.remat_policy = policy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        loss = float(run_step())                            # waits for the step
        seconds[policy].append(time.perf_counter() - t0)
        peak[policy] = max(peak.get(policy, 0.0), torch.cuda.max_memory_allocated() / 2**30)
        check(math.isfinite(loss), f'{what}: the {policy} step\'s loss {loss}')
        counts[policy] = {name: fn.launches for name, fn in counters().items()}
        _check_launches(counts[policy], reckoning(policy),
                        f'{what} under HCP_REMAT_POLICY={policy}')
    unet.remat_policy = 'flash'
    log(f'remat policy, {what}, in turns: ' + '; '.join(
        f'{p}: step seconds {[round(x, 4) for x in seconds[p]]} (median '
        f'{sorted(seconds[p])[len(seconds[p]) // 2]:.4f}), peak {peak[p]:.2f} GiB, A with lse '
        f'{counts[p]["flash_attention_lse"]}' for p in ('flash', 'full'))
        + f'; card: {gpu_name_and_power_limit()}')
    return counts


def sdxl_gradient_phase(device):
    """One step's UNet LoRA gradients on the card (bf16, kernels, remat)
    against fp32 on the CPU (plain versions), on the SDXL UNet at full
    width with one transformer block a level, a [2, 64, 64, 4] latent
    (S = 1024 at level 1, so A with its lse, E and F run at D = 64), fixed
    noise, t, context, pooled embedding and time_ids, and up factors set to
    small random values first."""
    from hcpdiff_tpu_torch.adapt.overlay import make_lora_overlay
    from hcpdiff_tpu_torch.diffusion.losses import MinSNRLoss
    from hcpdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from hcpdiff_tpu_torch.models.layers import init_flax_like
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from hcpdiff_tpu_torch.trainer.assemble import assemble, lora_base_weights, make_unet_apply
    cfg = dataclasses.replace(UNetConfig.sdxl(), transformer_layers_per_block=(1, 1, 1))
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    with device:
        unet = init_flax_like(UNet2DCondition(cfg, remat=True), gen)
        overlay, scales = make_lora_overlay(gen, unet, [{'layers': LORA_PATTERNS, 'rank': 8}])
    unet_cpu = copy.deepcopy(unet).cpu()
    unet_cpu.remat = False      # remat gives the same gradients (CPU tests)
    frozen = {'card': lora_base_weights(unet, overlay),
              'cpu': lora_base_weights(unet_cpu, overlay)}
    unet.to_compute_dtype(torch.bfloat16).to(memory_format=torch.channels_last)
    for m in (unet, unet_cpu):
        m.requires_grad_(False)
    cpu_gen = torch.Generator().manual_seed(SEED + 16)
    for e in overlay.values():
        e['up'].detach().copy_(torch.randn(e['up'].shape, generator=cpu_gen) * 1e-2)
    L = SDXL_GRAD_LATENT
    lat, noise = (torch.randn(2, L, L, 4, generator=cpu_gen) for _ in range(2))
    ctx = torch.randn(2, 77, cfg.cross_attention_dim, generator=cpu_gen)
    pooled = torch.randn(2, cfg.projection_class_embeddings_input_dim
                         - 6 * cfg.addition_time_embed_dim, generator=cpu_gen)
    tids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024], [768, 1024, 64, 0, 1024, 1024]])
    t = torch.tensor([801, 301])
    schedule = NoiseSchedule.make()
    criterion = MinSNRLoss(schedule, gamma=1.0)
    factors = [(p, k) for p in overlay for k in ('down', 'up')]
    grads = {}
    for side, dev, um in (('card', device, unet), ('cpu', torch.device('cpu'), unet_cpu)):
        pack = {'lora_unet': {p: {k: v.detach().to(dev).requires_grad_(True)
                                  for k, v in e.items()} for p, e in overlay.items()}}
        zero_counters()
        t0 = time.perf_counter()
        x = lat.to(dev)
        pred = make_unet_apply(um)(assemble(frozen[side], pack, {'lora_unet': scales}),
                                   schedule.add_noise(x, noise.to(dev), t.to(dev)), t.to(dev),
                                   ctx.to(dev), pooled_text_emb=pooled.to(dev),
                                   time_ids=tids.to(dev))
        loss = criterion(pred, noise.to(dev), t.to(dev)).mean()
        g = torch.autograd.grad(loss, [pack['lora_unet'][p][k] for p, k in factors])
        grads[side] = {k: torch.cat([gi.float().cpu().flatten()
                                     for gi, (_, kk) in zip(g, factors) if kk == k])
                       for k in ('down', 'up')}
        log(f'sdxl gradient check {side}: loss {float(loss.detach()):.6f} '
            f'({time.perf_counter() - t0:.2f} s)')
        if side == 'card':
            read_counters('the SDXL gradient check on the card', TRAINER_KERNELS,
                          absent=FUSED_ONLY)
    for factor in ('down', 'up'):
        card, cpu = grads['card'][factor], grads['cpu'][factor]
        err = float((card - cpu).norm() / cpu.norm())
        log(f'sdxl gradient check: LoRA {factor} gradients ({len(overlay)} layers), card bf16 '
            f'vs cpu fp32 rel L2 err {err:.3e} (limit {GRAD_REL_TOL}; |grad| '
            f'{float(cpu.norm()):.4e})')
        check(err <= GRAD_REL_TOL, f'sdxl gradient check: LoRA {factor} rel err {err} > '
              f'{GRAD_REL_TOL}')
    del unet, unet_cpu, frozen, overlay
    torch.cuda.empty_cache()


def dreamartist_phase(device, model_dir, tmp):
    """DreamArtist++.yaml through main() on the SD1.5 directory and the
    trainer phase's PNGs (512 px and 640x448 buckets, batch 1,
    cfg_scale '1.0-3.0:cos', both LoRA branches on the UNet and CLIP), its
    words pt-dog1 and pt-dog1-neg made first by tools/create_embedding.py
    from the directory's text encoder; 4 steps. Returns the run's
    launches."""
    from hcpdiff_tpu_torch.ckpt.formats import load_webui_embedding
    from hcpdiff_tpu_torch.models.layers import GroupNorm
    from hcpdiff_tpu_torch.tools.create_embedding import main as create_embedding
    emb_dir, exp = os.path.join(tmp, 'da_embs'), os.path.join(tmp, 'exp_da')
    files = {w: create_embedding([model_dir, w, '2', '--init_text', text, '--root', emb_dir])
             for w, text in DA_WORDS}
    zero_counters()
    t0 = time.perf_counter()
    da = _train_cli('DreamArtist++.yaml', model_dir, exp, os.path.join(tmp, 'train_imgs'),
                    f'train.train_steps={DA_STEPS}', f'train.save_step={DA_STEPS}',
                    f'tokenizer_pt.emb_dir={emb_dir}')
    seconds = time.perf_counter() - t0
    launches = read_counters('the DreamArtist++ run', TRAINER_KERNELS, absent=FUSED_ONLY)
    check(da.dream_artist and da.datasets[0].bs == 1, 'DreamArtist++ runs both branches at '
          'batch 1')
    check(len(da.history) == DA_STEPS and all(math.isfinite(x) for x in da.history),
          f'DreamArtist++ losses {da.history}')
    pack = da.state.pack
    _ups_moved(pack, ('lora_unet', 'lora_unet_neg', 'lora_te', 'lora_te_neg'))
    for word, path in files.items():
        sl = da.emb_slices[word]
        start = torch.from_numpy(load_webui_embedding(path)[1])
        check(not torch.equal(pack['emb'][sl].detach().cpu(), start),
              f'the rows of {word} did not move')
        saved = os.path.join(exp, 'ckpts', f'{word}-{DA_STEPS}.pt')
        name, vecs = load_webui_embedding(saved)
        check(name == word and torch.equal(torch.from_numpy(vecs),
                                           pack['emb'][sl].detach().cpu()),
              f'{saved} does not load back as the pack\'s rows of {word}')
    ds, vae = da.datasets[0], da.vae
    args = (da.unet.cfg, da.step_shapes, ds.encodes, 2 ** (len(vae.cfg.block_out_channels) - 1),
            sum(isinstance(m, GroupNorm) for m in vae.encoder.modules()))
    want = trainer_reckoning(*args, unet_calls=2, first_dq=False)
    plain = trainer_reckoning(*args[:2], [], *args[3:], first_dq=False)
    _check_launches(launches, want, 'the DreamArtist++ run')
    check(all(launches[k] == 2 * plain[k] for k in ('geglu_dense', 'fused_dense')),
          'DreamArtist++ steps do not run the UNet twice')
    import numpy as np
    steps = np.diff(da.step_ends)
    log(f'DreamArtist++ (cfg_scale {da.cfgs["train"]["cfg_scale"]}, batch 1, '
        f'{len(pack["lora_unet"])} + {len(pack["lora_unet_neg"])} UNet and '
        f'{len(pack["lora_te"])} + {len(pack["lora_te_neg"])} CLIP LoRA layers, words '
        f'{sorted(files)}): main() {seconds:.3f} s, steps\' latents '
        f'{[s[0] for s in da.step_shapes]}, step seconds {[round(float(x), 4) for x in steps]}, '
        f'losses {[round(x, 5) for x in da.history]}; every up factor of both branches and '
        f'both words\' rows moved; the saved words load back equal to the pack; B and C '
        f'launch twice a plain step\'s ({plain["geglu_dense"]} over these steps)')
    del da, pack
    torch.cuda.empty_cache()
    return launches


# phase 4h, SD2.1 768-v: self-attention at 96x96 (S = 9216, 5 heads) and
# 48x48 (S = 2304, 10 heads), D = 64 at both, takes A; 24x24 (576) and the
# 12x12 mid block (144) the plain route; the VAE's mid attention at 96x96
# is [b, 1, 9216, 512]. So an SD2.1 request launches as an SD1.5 one does
# (sd15_launches: the same blocks, the same levels on each route).
SD21_SIZE, SD21_REQUESTS = 768, (1, 4)
SD21_TRAIN_IMAGES = ((768, 768),) * 4
SD21_TRAIN_STEPS, SD21_TRAIN_BATCH = 6, 2
SD21_V_CFG = """_base_:
  - {base}
new_components:
  scheduler:
    _target_: diffusers.DPMSolverMultistepScheduler
    prediction_type: v_prediction
"""


def sd21_attention(b, size=SD21_SIZE):
    """An SD2.1 request's A launches by q's shape at batch b: five
    self-attentions at each of the two finest levels a UNet call (CFG
    doubles the batch), STEPS calls, then the VAE decode's mid attention."""
    s0, s1 = (size // 8) ** 2, (size // 16) ** 2
    return {(2 * b, 5, s0, 64): 5 * STEPS, (2 * b, 10, s1, 64): 5 * STEPS, (b, 1, s0, 512): 1}


@contextlib.contextmanager
def attention_shapes():
    """A's calls through the attention dispatcher (ops/attention.py), each
    counted by its q's shape, while the block runs."""
    from hcpdiff_tpu_torch.ops import attention as dispatch
    seen, real = collections.Counter(), dispatch.flash_attention

    def recorded(q, k, v, *args, **kw):
        seen[tuple(q.shape)] += 1
        return real(q, k, v, *args, **kw)
    dispatch.flash_attention = recorded
    try:
        yield seen
    finally:
        dispatch.flash_attention = real


@torch.inference_mode()
def _sd21_reference(unet):
    """The SD2.1 UNet at full width (bf16, kernels) against its weights in
    fp32 on the CPU on a [2, 32, 32, 4] latent: S = 1024 at level 0, so A
    runs at D = 64 (five times)."""
    gen = torch.Generator().manual_seed(SEED + 60)
    lat = torch.randn(2, 32, 32, 4, generator=gen)
    ctx = torch.randn(2, 77, unet.cfg.cross_attention_dim, generator=gen)
    t = torch.tensor([801, 301])
    dev = next(unet.parameters()).device
    with attention_shapes() as shapes:
        out = unet(lat.to(dev), t.to(dev), ctx.to(dev))
    unet_cpu = cpu_fp32(unet)
    err = rel_err(out, unet_cpu(lat, t, ctx))
    del unet_cpu
    log(f'reference sd21 unet: card bf16 vs cpu fp32 rel L2 err {err:.3e} (limit '
        f'{MODEL_REL_TOL}); A by shape {dict(shapes)}')
    check(dict(shapes) == {(2, 5, 1024, 64): 5}, f'sd21 reference: A ran at {dict(shapes)}')
    check(err <= MODEL_REL_TOL, f'sd21 unet rel err {err} > {MODEL_REL_TOL}')


def sd21_phase(device, tmp):
    """SD2.1 768-v: the seeded directory (F16, Linear projections), its
    bf16 load against the originals, the UNet against the CPU, 768 px
    v-prediction requests through main() at batch 1 and 4, and
    sd21_vpred.yaml's LoRA training at 768 px through the config loader and
    Trainer. Returns the requests' launches, the training run's and the
    shapes its kernels took."""
    import numpy as np
    from hcpdiff_tpu_torch.config import load
    from hcpdiff_tpu_torch.models.factory import build_models
    from hcpdiff_tpu_torch.models.layers import GroupNorm
    from hcpdiff_tpu_torch.models.unet import UNetConfig
    from hcpdiff_tpu_torch.tools.random_diffusers import write_dir
    from hcpdiff_tpu_torch.tools.random_sd21 import sd21_modules
    from hcpdiff_tpu_torch.trainer.trainer import Trainer
    model_dir = os.path.join(tmp, 'sd21')
    t0 = time.perf_counter()
    write_dir(model_dir, 'sd21', SEED, torch.float16, device)
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(model_dir)
               for f in fs)
    with open(os.path.join(model_dir, 'unet', 'config.json')) as f:
        config = json.load(f)
    log(f'diffusers-layout SD2.1 directory (F16, seed {SEED}) written in '
        f'{time.perf_counter() - t0:.2f} s: {size / 2**30:.3f} GiB')
    check(config['use_linear_projection'] is True
          and config['attention_head_dim'] == [5, 10, 20, 20]
          and config['cross_attention_dim'] == 1024, f'the SD2.1 unet config {config}')
    t0 = time.perf_counter()
    world = build_models(model_dir, torch.bfloat16, device)
    log(f'build_models (SD2.1, bf16, cuda): {time.perf_counter() - t0:.2f} s')
    check(world['unet_cfg'] == UNetConfig.sd21(), f'SD2.1 config read as {world["unet_cfg"]}')
    _check_loaded(world, sd21_modules(device, SEED), 'SD2.1')
    _sd21_reference(world['unet'])
    del world
    torch.cuda.empty_cache()

    cfg = os.path.join(tmp, 'sd21_v.yaml')
    with open(cfg, 'w') as f:
        f.write(SD21_V_CFG.format(base=os.path.abspath('cfgs/infer/text2img.yaml')))
    total = dict.fromkeys(TXT2IMG_KERNELS, 0)
    for b in SD21_REQUESTS:
        zero_counters()
        with attention_shapes() as shapes:
            viser, images, seconds = _cli(model_dir, os.path.join(tmp, f'sd21_{b}'), cfg,
                                          f'bs={b}', f'infer_args.width={SD21_SIZE}',
                                          f'infer_args.height={SD21_SIZE}')
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = read_counters(f'the SD2.1 768 px request at batch {b}', TXT2IMG_KERNELS,
                                 absent=FUSED_ONLY)
        _check_launches(launches, sd15_launches(STEPS), f'the SD2.1 request at batch {b}')
        check(dict(shapes) == sd21_attention(b), f'the SD2.1 request at batch {b} ran A at '
              f'{dict(shapes)}, not {sd21_attention(b)}')
        check(viser.schedule.prediction_type == 'v_prediction'
              and viser.cfgs.infer_args.sampler == 'dpm++_2m',
              'the SD2.1 request is v-prediction DPM++ 2M')
        check(images.shape == (b, SD21_SIZE, SD21_SIZE, 3), f'SD2.1 images {images.shape}')
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        c = viser.cfgs
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        again = viser.vis_images(c.prompt, c.neg_prompt, seed=VIS_SEED)
        alone = time.perf_counter() - t0
        check((again == images).all(), 'a second SD2.1 request differs')
        log(f'sd21 768 px v-prediction request, batch {b}, {STEPS} DPM++ 2M steps, guidance '
            f'{GUIDANCE}: main() {seconds:.3f} s (peak {peak:.2f} GiB); alone {alone:.3f} s, '
            f'{alone / b:.3f} s an image (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} '
            f'GiB); A by shape {dict(shapes)}; card: {gpu_name_and_power_limit()}')
        del viser, images, again
        torch.cuda.empty_cache()

    imgs, exp = os.path.join(tmp, 'sd21_imgs'), os.path.join(tmp, 'exp_sd21')
    write_dataset(imgs, SD21_TRAIN_IMAGES, SEED + 61)
    cfgs = load('cfgs/train/examples/sd21_vpred.yaml', train_args(
        'sd21_vpred.yaml', model_dir, exp, imgs, f'train.train_steps={SD21_TRAIN_STEPS}',
        f'train.save_step={SD21_TRAIN_STEPS}', f'data.dataset1.batch_size={SD21_TRAIN_BATCH}',
        f'data.dataset1.bucket.target_area={SD21_SIZE * SD21_SIZE}')[2:])
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    trainer = Trainer(cfgs)
    try:
        trainer.train()
    finally:
        trainer.loggers.close()
    seconds = time.perf_counter() - t0
    launches = read_counters('the SD2.1 trainer run (sd21_vpred.yaml)', TRAINER_KERNELS,
                             absent=FUSED_ONLY)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ds = trainer.datasets[0]
    buckets = sorted({s for shapes in trainer.step_shapes for s in shapes})
    check(trainer.noise_schedule.prediction_type == 'v_prediction'
          and trainer.dtype == torch.bfloat16 and trainer.unet.remat
          and trainer.unet.remat_policy == 'flash',
          'the SD2.1 run is v-prediction, bf16, remat under HCP_REMAT_POLICY=flash')
    check(len(trainer.history) == SD21_TRAIN_STEPS
          and all(math.isfinite(x) for x in trainer.history),
          f'sd21 trainer losses {trainer.history}')
    check(buckets == [(SD21_TRAIN_BATCH, 96, 96, 4)], f'sd21 trainer buckets {buckets}')
    _ups_moved(trainer.state.pack, ('lora_unet', 'lora_te'))
    vae = trainer.vae
    _check_launches(launches, trainer_reckoning(
        trainer.unet.cfg, trainer.step_shapes, ds.encodes,
        2 ** (len(vae.cfg.block_out_channels) - 1),
        sum(isinstance(m, GroupNorm) for m in vae.encoder.modules())), 'the SD2.1 trainer run')
    shapes = _trainer_shapes(trainer)
    want = [(SD21_TRAIN_BATCH, 5, 9216, 64), (SD21_TRAIN_BATCH, 10, 2304, 64)]
    check(shapes['attn'] == want, f'the SD2.1 run\'s A/E/F shapes {shapes["attn"]}')
    steps = np.diff(trainer.step_ends)
    med = float(np.median(steps))
    log(f'sd21 trainer (sd21_vpred.yaml, v-prediction, 768 px, batch {SD21_TRAIN_BATCH}, LoRA '
        f'UNet r8 + CLIP r4, bf16, remat): build and train {seconds:.3f} s, latent cache '
        f'{trainer.seconds["latent cache"]:.3f} s; steps 2-{SD21_TRAIN_STEPS} median '
        f'{med:.4f} s/step, min {steps.min():.4f}, max {steps.max():.4f}, all '
        f'{[round(float(x), 4) for x in steps]}; {SD21_TRAIN_BATCH / med:.3f} samples/s; peak '
        f'{peak:.2f} GiB; losses {[round(x, 5) for x in trainer.history]}; A/E/F at {want}; '
        f'card: {gpu_name_and_power_limit()}')
    shapes = {'attn': shapes['attn'], 'enc_attn': [], 'ffn': [],
              'gn': [g for g in shapes['gn'] if g[1] == 9216]}
    del trainer, ds
    torch.cuda.empty_cache()
    return total, launches, shapes


# phase 4i, DeepCache: a reuse call of the SD1.5 UNet runs down level 0 (2
# resblocks, 2 transformers) and up level 3 (3 resblocks, 3 transformers),
# all at 64x64 (S = 4096: A), and the output norm
DC_REUSE = {'flash_attention': 5, 'geglu_dense': 5, 'fused_dense': 5, 'group_norm_silu': 16}
DC_INTERVALS, DC_REF_STEPS = (3, 2), 6


def deepcache_launches(steps, interval):
    """A DeepCache request's launches: a full UNet call at every
    ``interval``th step from step 0 (sd15_launches' counts, the decode
    included), a reuse call (DC_REUSE) at the others."""
    full = len(range(0, steps, interval))
    return {k: n + (steps - full) * DC_REUSE[k] for k, n in sd15_launches(full).items()}


@torch.inference_mode()
def _deepcache_reference(pipe, device):
    """The card's DeepCache loop (bf16, kernels) against the same loop in
    fp32 on the CPU: a [1, 32, 32, 4] latent (S = 1024 at level 0, A runs),
    DC_REF_STEPS DPM++ 2M steps at interval 2."""
    from hcpdiff_tpu_torch.diffusion.samplers import make_sampler
    from hcpdiff_tpu_torch.infer.pipeline import DenoiseLoop
    gen = torch.Generator().manual_seed(SEED + 62)
    lat = torch.randn(1, 32, 32, 4, generator=gen)
    ctx, _ = pipe.te.encode([NEGATIVE, PROMPT])
    out = {}
    for side, unet, dev in (('card', pipe.unet, device),
                            ('cpu', cpu_fp32(pipe.unet), torch.device('cpu'))):
        loop = DenoiseLoop(unet, make_sampler('dpm++_2m', pipe.schedule, DC_REF_STEPS),
                           deep_cache_interval=2)
        out[side], _ = loop(lat.to(dev), ctx.float().to(dev), GUIDANCE)
    err = rel_err(out['card'], out['cpu'])
    log(f'reference DeepCache loop (interval 2, {DC_REF_STEPS} steps): card bf16 vs cpu fp32 '
        f'final latents rel L2 err {err:.3e} (limit {MODEL_REL_TOL})')
    check(err <= MODEL_REL_TOL, f'DeepCache loop rel err {err} > {MODEL_REL_TOL}')


def deepcache_phase(device, model_dir, tmp):
    """text2img.yaml through main() with infer_args.deep_cache_interval 3,
    then 2 (SD1.5 directory, 512 px, batch 4), launches as reckoned; the
    seconds of exact and DeepCache requests on one loaded Visualizer, in
    turns; one request with encoder_attention_mask: true; the DeepCache
    loop against the CPU. Returns the phase's launches."""
    total = dict.fromkeys(TXT2IMG_KERNELS, 0)
    for n in DC_INTERVALS:
        zero_counters()
        viser, images, seconds = _cli(model_dir, os.path.join(tmp, f'deepcache_{n}'),
                                      'text2img.yaml', f'infer_args.deep_cache_interval={n}')
        launches = read_counters(f'the DeepCache request at interval {n}', TXT2IMG_KERNELS,
                                 absent=FUSED_ONLY)
        _check_launches(launches, deepcache_launches(STEPS, n),
                        f'the DeepCache request at interval {n}')
        check(images.shape == (4, SIZE, SIZE, 3), f'DeepCache images {images.shape}')
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    c, alone, outs = viser.cfgs, {}, {}
    for n in (0,) + DC_INTERVALS + (0,) + DC_INTERVALS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[n] = viser.vis_images(c.prompt, c.neg_prompt, seed=VIS_SEED, deep_cache_interval=n)
        alone.setdefault(n, []).append(round(time.perf_counter() - t0, 4))
    diffs = {n: float(abs(outs[n] - outs[0]).max()) for n in DC_INTERVALS}
    log(f'DeepCache requests alone (vis_images, 512 px, batch 4, {STEPS} steps; interval 0 '
        f'is the exact loop), seconds in turns: {alone}; max abs image difference from the '
        f'exact request {diffs}; card: {gpu_name_and_power_limit()}')
    check(all(d > 0 for d in diffs.values()), 'a DeepCache request equals the exact one')
    _deepcache_reference(viser.pipe, device)
    del viser
    zero_counters()
    viser, images, seconds = _cli(model_dir, os.path.join(tmp, 'masked'), 'text2img.yaml',
                                  'encoder_attention_mask=true')
    launches = read_counters('the masked request', TXT2IMG_KERNELS, absent=FUSED_ONLY)
    _check_launches(launches, sd15_launches(STEPS), 'the masked request')
    diff = float(abs(images - outs[0]).max())
    log(f'masked request (encoder_attention_mask: true): max abs image difference from the '
        f'unmasked request {diff}')
    check(viser.pipe.use_encoder_attention_mask and diff > 0,
          'the masked request ran without the mask')
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    del viser
    torch.cuda.empty_cache()
    return total


def sd21_kernel_phase(train_shapes):
    """A at the batch-4 SD2.1 request's shapes (sd21_attention(4)), and A
    with its lse, E, F and D at the SD2.1 training run's (D: its GroupNorms
    at S = 9216), labelled sd21: {wrapper name: per-shape records}."""
    from hcpdiff_tpu_torch.ops import flash_attention as fa
    F = torch.nn.functional
    per = trainer_kernel_phase(train_shapes, 'sd21')
    rn = _rn_on(torch.Generator(device='cuda').manual_seed(SEED + 63))
    for shape in sd21_attention(SD21_REQUESTS[-1]):
        with torch.inference_mode():
            q, k, v = rn(*shape), rn(*shape), rn(*shape)
        per['flash_attention'].append(_measure(
            f'sd21 q/k/v {list(shape)}', fa.flash_attention, fa.attention_plain, [q, k, v],
            _within_rel, 'flash_attention', attention_work(*shape),
            lambda: F.scaled_dot_product_attention(q, k, v)))
        del q, k, v
        torch.cuda.empty_cache()
    return per


def _leaf_kinds(pack):
    """The factor name ('down', 'up', 'alpha') of each leaf, in pack_leaves order."""
    out = []
    for key in sorted(pack):
        for path in sorted(pack[key]):
            out += sorted(pack[key][path])
    return out


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
    sdxl_launches, sdxl_pipe = sdxl_phase(device)
    sdxl_reference_phase(sdxl_pipe, device)
    del sdxl_pipe
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix='hcp_smoke_')
    try:
        model_dir = write_model_dir(device, tmp)
        visualizer_launches = visualizer_phase(device, model_dir, tmp)
        trainer_launches, trainer_shapes = trainer_phase(device, model_dir, tmp)
        server_launches = server_phase(device, model_dir, tmp)
        sdxl_train_launches, sdxl_step, sdxl_train_shapes = sdxl_trainer_phase(device, tmp)
        da_launches = dreamartist_phase(device, model_dir, tmp)
        sd21_launches, sd21_train_launches, sd21_train_shapes = sd21_phase(device, tmp)
        dc_launches = deepcache_phase(device, model_dir, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
    sdxl_gradient_phase(device)
    records = kernel_phase({'txt2img': launches, 'train': train_launches,
                            'fused': fused_launches, 'sdxl': sdxl_launches,
                            'visualizer': visualizer_launches, 'server': server_launches})
    records += train_kernel_phase(train_launches)
    records = add_classic_shapes(records, classic_kernel_phase())
    records += fused_kernel_phase(fused_launches)
    records = add_trainer_shapes(records, trainer_kernel_phase(trainer_shapes),
                                 trainer_launches)
    records = add_trainer_shapes(records, trainer_kernel_phase(sdxl_train_shapes, 'trainer_sdxl'),
                                 sdxl_train_launches, 'trainer_sdxl',
                                 launches_trainer_sdxl_step_1024=sdxl_step,
                                 launches_trainer_da=da_launches)
    records = add_trainer_shapes(records, sd21_kernel_phase(sd21_train_shapes),
                                 sd21_train_launches, 'sd21',
                                 launches_sd21_requests=sd21_launches,
                                 launches_deepcache=dc_launches)
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
