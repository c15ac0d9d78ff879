"""Kernel D's launch plan (``hcpdiff_tpu_torch/ops/groupnorm.py:gn_plan``),
on the CPU: the plan is plain Python, and the kernel (``csrc/groupnorm.cu``)
takes its grid, spans, chunks and slots as given, so they are checked here
for every GroupNorm the txt2img path runs.

The kernel's limits are data in the CUDA source: its HCP_GN_LIMITS table,
read here and held to the plan's GN_LIMITS and to the card's shared memory.

Shapes: every GroupNorm of SD1.5's UNet (batch 2, 4 and 8: a 512 px request
of batch 1, 2 and 4 under CFG), VAE decoder (batch 1, 2 and 4) and VAE
encoder (batch 1), in bf16 and fp32, and those of the tiny UNet and VAE,
recorded by running them.
The kernel's chunk and slot schedule (pass 1 fills the slots in order,
pass 2 takes the chunks still held first and reloads the others) is
replayed here for every plan. Also the plans ``tools/time_plans.py`` times
beside the chosen one.
"""
import re
from pathlib import Path

import pytest
import torch

from hcpdiff_tpu_torch.models.layers import GroupNorm
from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from hcpdiff_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from hcpdiff_tpu_torch.ops import _plan
from hcpdiff_tpu_torch.ops import groupnorm as gn
from hcpdiff_tpu_torch.tools import gn_phases
from hcpdiff_tpu_torch.tools import time_kernels as tk
from hcpdiff_tpu_torch.tools import time_plans as tp

CSRC = Path(gn.__file__).resolve().parent.parent / 'csrc'
SM_SMEM = 233472                 # 228 KB an SM, of which each block takes 1 KB more
LIM = gn.GN_LIMITS

# (S, C) of the SD1.5 UNet's GroupNorms at 512 px (64x64 latent) and of the
# VAE decoder's (64x64 up to 512x512), each with the regime a batch-4
# request gives it in bf16 (UNet batch 8, VAE batch 4)
UNET_SHAPES = {(4096, 320): 'resident', (4096, 640): 're-read', (4096, 960): 're-read',
               (1024, 320): 'resident', (1024, 640): 'resident', (1024, 960): 'resident',
               (1024, 1280): 'resident', (1024, 1920): 're-read', (256, 640): 'resident',
               (256, 1280): 'resident', (256, 1920): 'resident', (256, 2560): 'resident',
               (64, 1280): 'resident', (64, 2560): 'resident'}
VAE_SHAPES = {(4096, 512): 'resident', (16384, 512): 're-read', (65536, 512): 're-read',
              (65536, 256): 're-read', (262144, 256): 're-read', (262144, 128): 're-read'}
# the same for SDXL at 1024 px (128x128 latent; UNet channels 320, 640,
# 1280 and their skip concatenations) and its VAE decoder (128x128 up to
# 1024x1024): x up to 2^30 elements, 33 blocks a sample at batch 4
SDXL_UNET_SHAPES = ((16384, 320), (16384, 640), (16384, 960), (4096, 320), (4096, 640),
                    (4096, 960), (4096, 1280), (4096, 1920), (1024, 640), (1024, 1280),
                    (1024, 1920), (1024, 2560))
SDXL_VAE_SHAPES = ((16384, 512), (65536, 512), (262144, 512), (262144, 256), (1048576, 256),
                   (1048576, 128))
BATCHES = (1, 2, 4)


def _source_limits():
    src = (CSRC / 'groupnorm.cu').read_text()
    table = src[src.index('#define HCP_GN_LIMITS('):]
    table = table[:table.index('\n\n')]
    return {k: int(v) for k, v in re.findall(r'X\((\w+), (\d+)\)', table)}


def test_plan_limits_are_the_sources():
    assert _source_limits() == LIM


def test_limits_fit_the_card():
    assert LIM['MAX_SMEM'] <= 232448
    assert LIM['BLOCKS_PER_SM'] * (LIM['MAX_SMEM'] + 1024) <= SM_SMEM
    assert LIM['MAX_THREADS'] % 32 == 0 and LIM['MAX_THREADS'] * 102 <= 65536
    assert 1 <= LIM['MAX_SLOTS'] <= 32            # a phase bit a slot in one 32-bit word
    assert LIM['CHUNK_BYTES'] % 16 == 0 and LIM['CHUNK_BYTES'] <= gn.MAX_TX_BYTES


def _tiny_shapes():
    """(B, S, C, groups) of every GroupNorm call of the tiny UNet and VAE."""
    shapes = set()

    def hook(mod, args, _):
        x = args[0]
        shapes.add((x.shape[0], x.shape[2] * x.shape[3], x.shape[1], mod.num_groups))
    torch.manual_seed(0)
    unet, vae = UNet2DCondition(UNetConfig.tiny()), AutoencoderKL(VAEConfig.tiny())
    for m in (*unet.modules(), *vae.modules()):
        if isinstance(m, GroupNorm):
            m.register_forward_hook(hook)
    with torch.no_grad():
        unet(torch.randn(2, 16, 16, 4), torch.tensor([10, 500]), torch.randn(2, 77, 32))
        vae.decode(torch.randn(1, 8, 8, 4))
    return sorted(shapes)


TINY_SHAPES = _tiny_shapes()


def _cases():
    cases = []
    for table, factor in ((UNET_SHAPES, 2), (VAE_SHAPES, 1)):
        for (S, C), regime in table.items():
            for b in BATCHES:
                cases.append((factor * b, S, C, 32, regime if b == 4 else None))
    cases += [(B, S, C, G, None) for B, S, C, G in TINY_SHAPES]
    for shapes, factor in ((SDXL_UNET_SHAPES, 2), (SDXL_VAE_SHAPES, 1)):
        cases += [(factor * b, S, C, 32, None) for S, C in shapes for b in BATCHES]
    # the VAE encoder's, on the one image of an img2img or inpaint request
    cases += [(B, S, C, 32, None) for B, S, C in dict.fromkeys(s[:3] for s in tk.ENC_GN_SHAPES)]
    return cases


CASES = _cases()


def _replay(plan, k):
    """The kernel's schedule for block k: pass 1 loads chunk c into slot
    c % K (refilling a slot once its chunk is summed) and sums it; pass 2
    position t takes chunk nchunks - K + t (still held) for t < K, else
    chunk t - K, reloaded into slot (nchunks + t) % K after position t - K
    freed it. Returns (chunks summed, chunks written, chunks loaded)."""
    start, stop = plan.span(k)
    nchunks = -(-(stop - start) // plan.chunk_rows)
    K = min(plan.slots, nchunks)
    held = {s: s for s in range(K)}              # slot -> chunk
    loads, summed, written = K, [], []
    for c in range(nchunks):
        assert held[c % K] == c
        summed.append(c)
        if c + K < nchunks:
            held[c % K] = c + K
            loads += 1
    for t in range(nchunks):
        c = nchunks - K + t if t < K else t - K
        slot = (nchunks + t) % K
        assert held[slot] == c, (plan, k, t)
        written.append(c)
        if t + K < nchunks:
            held[slot] = t
            loads += 1
    return summed, written, loads


@pytest.mark.parametrize('itemsize', [2, 4])
@pytest.mark.parametrize('B,S,C,G,regime', CASES)
def test_plan(B, S, C, G, regime, itemsize):
    plan = gn.gn_plan(B, S, C, itemsize, G)
    vr = C // 8
    if regime is not None and itemsize == 2:
        assert plan.regime == regime
    # the block: whole warps, C / 8 * rpp threads reading, within the limits
    assert plan.threads % 32 == 0 and plan.threads <= LIM['MAX_THREADS']
    assert vr * plan.rpp <= plan.threads < vr * plan.rpp + 32
    assert plan.smem == gn.gn_smem(plan.threads, G, plan.slots, plan.chunk_rows * C * itemsize)
    assert plan.smem <= LIM['MAX_SMEM']
    assert 1 <= plan.slots <= min(LIM['MAX_SLOTS'], plan.chunks)
    assert plan.chunk_rows * C * itemsize <= gn.MAX_TX_BYTES
    # the grid is resident at once, and its spans tile S with none empty
    assert plan.grid <= _plan.SMS * plan.per_sm and plan.per_sm == LIM['BLOCKS_PER_SM']
    spans = [plan.span(k) for k in range(plan.blocks)]
    assert spans[0][0] == 0 and spans[-1][1] == S
    assert all(a < b for a, b in spans) and all(spans[i][1] == spans[i + 1][0]
                                                for i in range(len(spans) - 1))
    # each block sums and writes every chunk of its span once; the
    # resident regime loads each once, the re-read regime K fewer than twice
    for k in {0, plan.blocks - 1}:
        start, stop = plan.span(k)
        nchunks = -(-(stop - start) // plan.chunk_rows)
        summed, written, loads = _replay(plan, k)
        assert summed == list(range(nchunks)) and sorted(written) == summed
        assert loads == 2 * nchunks - min(plan.slots, nchunks)
        if plan.regime == 'resident':
            assert loads == nchunks


def test_shapes_are_the_timed_ones():
    """The shapes here are those tools/time_kernels.py and chip_smoke.py
    time D at."""
    assert set(UNET_SHAPES) == set(tk.GN_UNET) and set(VAE_SHAPES) == set(tk.GN_VAE)


def test_plan_uses_the_card():
    """A batch-4 request's UNet norms take 128 of the 132 SMs (16 blocks a
    sample), the VAE's all 132; one sample of 4096 rows takes 128 spans
    of 32 rows (132 blocks would leave spans of 31 and 32 rows)."""
    assert gn.gn_plan(8, 4096, 320, 2).grid == 128
    assert gn.gn_plan(4, 262144, 128, 2).grid == 132
    assert gn.gn_plan(1, 4096, 512, 2).grid == 128


@pytest.mark.parametrize('B,S,C,G', [(2, 16, 30, 3), (2, 16, 64, 7), (2, 16, 8 * 641, 1),
                                     (133, 16, 64, 32), (2, 0, 64, 32)])
def test_plan_rejects_what_the_kernel_does_not_take(B, S, C, G):
    with pytest.raises(ValueError):
        gn.gn_plan(B, S, C, 2, G)


def test_timed_shapes_cover_the_sdxl_request():
    """chip_smoke.py and tools/time_kernels.py hold D at every GroupNorm
    shape of a batch-4 SDXL request: GN_SHAPES where a 512 px request has
    the shape, SDXL_GN_SHAPES (no shape twice) where it has not."""
    timed = set(tk.GN_SHAPES) | set(tk.SDXL_GN_SHAPES)
    needed = ({(8, S, C, True) for S, C in SDXL_UNET_SHAPES}
              | {(4, S, C, True) for S, C in SDXL_VAE_SHAPES}
              | {(8, 4096, 640, False), (8, 1024, 1280, False), (4, 16384, 512, False)})
    assert needed <= timed
    assert not set(tk.SDXL_GN_SHAPES) & set(tk.GN_SHAPES)
    assert set(tk.SDXL_GN_SHAPES) <= needed


@pytest.mark.parametrize('B,S,C,silu', tk.GN_SHAPES)
def test_time_plans_candidates(B, S, C, silu):
    """The plans tools/time_plans.py times beside D's chosen one at each
    shape it times: the chosen among them, each a valid plan of the shape."""
    chosen = gn.gn_plan(B, S, C, 2)
    plans = tp.candidates(chosen)
    assert chosen in plans and len(plans) >= 2 and len(set(map(tp.plan_name, plans))) == len(plans)
    for plan in plans:
        assert (plan.B, plan.S, plan.C, plan.itemsize) == (B, S, C, 2)
        assert plan.smem <= LIM['MAX_SMEM'] and plan.grid <= _plan.SMS * LIM['BLOCKS_PER_SM']
        assert plan.span(plan.blocks - 1)[1] == S and plan.span(plan.blocks - 1)[0] < S


def test_gn_phases_instruments_the_kernel():
    """tools/gn_phases.py finds every line it stamps in the kernel's source."""
    src = gn_phases.instrument((CSRC / 'groupnorm.cu').read_text())
    assert all(f'STAMP({k})' in src for k in gn_phases.ORDER)
    assert all(src.count(f'STAMP({k})') == 1 for k in gn_phases.ORDER)
    assert 'hcp_gn_stamps' in src
