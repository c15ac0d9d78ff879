"""Kernels B and C's launch plan (``hcpdiff_tpu_torch/ops/matmul.py:
gemm_plan``), on the CPU: the plan is plain Python, and the kernel
(``csrc/gemm_wgmma.cu``) takes its tile, K ranges and workspace as given,
so they are checked here for every feed-forward GEMM the UNets run.

The tiles are data in the CUDA source: its HCP_GEMM_TILES table, read here
and held to the plan's GEMM_TILES and to the card's shared memory and
wgmma's N.

Shapes: the SD1.5 transformer blocks' B (x [M, C], w [8C, C]) and C with
the block residual (x [M, 4C], w [C, 4C]) at every level (64x64, 32x32,
16x16 latents with C = 320, 640, 1280, and the 8x8 mid block with 1280) at
batch 1, 2 and 4 of a 512 px request under CFG (M = 2 * batch * S); the
fused path's other C shapes (proj_in, proj_out and to_out: x [M, C],
w [C, C]) at batch 4; and the tiny UNet's feed-forward GEMMs at ragged M.
Also the plans ``tools/time_plans.py`` times on the card at its shapes.
"""
import re
from pathlib import Path

import pytest
import torch

from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.ops import _plan
from hcpdiff_tpu_torch.ops import conv as cv
from hcpdiff_tpu_torch.ops import matmul as mm
from hcpdiff_tpu_torch.tools import time_plans as tp

CSRC = Path(mm.__file__).resolve().parent.parent / 'csrc'
MAX_SMEM = 232448                # 227 KB: the most shared memory a block may use
SM_SMEM = 233472                 # 228 KB an SM, of which each block takes 1 KB more
WGMMA_SS_N = (32, 48, 64, 128, 160)   # csrc/wgmma.cuh's Wgmma<N> (both operands in smem)

# (latent side, channels) of SD1.5's transformer levels; the mid block is 8x8
SD15_LEVELS = ((64, 320), (32, 640), (16, 1280), (8, 1280))
BATCHES = (1, 2, 4)
WAVE = _plan.WAVE_FILL * _plan.SMS    # a grid of this many blocks fills the card


def _source_tiles():
    """{(geglu, BN, blocks an SM): stages} from csrc/gemm_wgmma.cu's rows
    X(GEGLU, BN, STAGES, MINB)."""
    src = (CSRC / 'gemm_wgmma.cu').read_text()
    table = src[src.index('#define HCP_GEMM_TILES('):]
    table = table[:table.index('\n\n')]
    rows = re.findall(r'X\((true|false), (\d+), (\d+), (\d+)\)', table)
    return {(g == 'true', int(bn), int(minb)): int(s) for g, bn, s, minb in rows}


def _smem_bytes(geglu, bn, stages):
    """As csrc/gemm_wgmma.cu's Tile::SMEM: the ring, or the staged fp32
    output tile and C's bias where that is larger, + 1024 bytes of
    alignment."""
    stage = mm.BM * mm.BK * 2 + (2 if geglu else 1) * bn * mm.BK * 2
    out = (mm.BM * (bn + 8) + bn) * 4
    return max(stages * stage, out) + 1024


def test_plan_tiles_are_the_sources():
    assert _source_tiles() == mm.GEMM_TILES


@pytest.mark.parametrize('geglu,bn,per_sm', sorted(mm.GEMM_TILES))
def test_every_tile_fits_the_card(geglu, bn, per_sm):
    stages = mm.GEMM_TILES[(geglu, bn, per_sm)]
    smem = _smem_bytes(geglu, bn, stages)
    assert smem <= MAX_SMEM and per_sm * (smem + 1024) <= SM_SMEM
    assert stages >= 3 and per_sm in (1, 2)   # two stages ahead at one block an SM
    assert bn in WGMMA_SS_N                  # wgmma N: one product per operand and k16
    assert bn % 32 == 0                  # a thread copies weight rows r, r + 32, ..


def _sd15_shapes():
    """(label, geglu, M, N, K) of every SD1.5 B and C the paths run."""
    shapes = []
    for side, C in SD15_LEVELS:
        for b in BATCHES:
            M = 2 * b * side * side
            shapes.append((f'B {side} b{b}', True, M, 4 * C, C))
            shapes.append((f'C {side} b{b}', False, M, C, 4 * C))
        shapes.append((f'C {side} b4 proj', False, 8 * side * side, C, C))
    return shapes


def _tiny_shapes():
    """B and C of every feed-forward of the tiny UNet, at ragged M."""
    with torch.device('meta'):           # shapes only: no weights are made
        unet = tunet.UNet2DCondition(tunet.UNetConfig.tiny())
    dims = sorted({m.proj.in_features for m in unet.modules()
                   if isinstance(m, tunet.GEGLUFeedForward)})
    assert dims
    return [(f'tiny {kind} C={C} M={M}', kind == 'B', M, 4 * C if kind == 'B' else C,
             C if kind == 'B' else 4 * C)
            for C in dims for M in (7, 300, 512, 1000, 2048) for kind in 'BC']


SHAPES = _sd15_shapes() + _tiny_shapes()


@pytest.mark.parametrize('label,geglu,M,N,K', SHAPES, ids=[s[0] for s in SHAPES])
def test_gemm_plan_covers_the_gemm(label, geglu, M, N, K):
    plan = mm.gemm_plan(geglu, M, N, K)
    assert (plan.geglu, plan.m, plan.n, plan.ksteps) == (geglu, M, N, -(-K // mm.BK))
    assert (geglu, plan.bn, plan.per_sm) in mm.GEMM_TILES and 1 <= plan.splits <= mm.MAX_SPLITS
    # the tiles cover M x N once: the last tile of each dim starts inside it
    assert (plan.m_tiles - 1) * mm.BM < M <= plan.m_tiles * mm.BM
    assert (plan.n_tiles - 1) * plan.bn < N <= plan.n_tiles * plan.bn
    # BN divides N where a built tile does; elsewhere the waste is the least
    # any built tile gives
    bns = [bn for g, bn, _ in mm.GEMM_TILES if g == geglu]
    if any(N % bn == 0 for bn in bns):
        assert N % plan.bn == 0
    assert plan.waste == min(-(-N // bn) * bn - N for bn in bns)
    # the K ranges partition [0, ksteps) in whole, non-empty steps, in order
    ranges = [plan.k_range(z) for z in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.ksteps
    assert all(a < b for a, b in ranges)
    assert all(ranges[z][1] == ranges[z + 1][0] for z in range(plan.splits - 1))
    # only a grid short of a wave is split, and a split grid is larger
    if plan.splits > 1:
        assert plan.m_tiles * plan.n_tiles < WAVE and plan.blocks > plan.m_tiles * plan.n_tiles
    ws = mm.split_workspace(plan, 'cpu')
    if plan.splits == 1:
        assert ws is None
    else:
        assert ws.dtype == torch.float32
        assert ws.numel() == plan.splits * M * N * (2 if geglu else 1)


def test_no_batch4_geglu_splits():
    """Every B grid of a batch-4 request fills a wave unsplit."""
    for label, geglu, M, N, K in _sd15_shapes():
        if geglu and label.endswith('b4'):
            plan = mm.gemm_plan(geglu, M, N, K)
            assert plan.splits == 1 and plan.blocks >= WAVE, label


def test_short_grids_split_to_a_wave():
    """C at the mid block (4 row tiles at batch 4, 1 at batch 1) and at
    16x16 / batch 1 (4 row tiles), all with K = 5120, is split toward a
    wave: at batch 4 to one (split 4, the fastest on the card), at batch 1
    to 8-12 splits of its 8 tiles, where the card's times are flat (0.0119
    - 0.0120 ms) and a full wave's 16 was slower (PERF.md)."""
    for M in (512, 128):
        plan = mm.gemm_plan(False, M, 1280, 5120)
        assert plan.splits > 1, plan
        assert plan.blocks >= WAVE if M == 512 else 8 <= plan.splits <= 12, plan


TIMED = [('J',) + s for s in tp.CONV_SHAPES] + list(tp.GEMM_SHAPES)


@pytest.mark.parametrize('shape', TIMED, ids=[' '.join(map(str, s)) for s in TIMED])
def test_time_plans_times_the_chosen_plan(shape):
    """``tools/time_plans.py`` times, for each of its shapes, the plan the
    planner picks among plans the kernel is built for, each once."""
    chosen = tp.conv_chosen(*shape[1:]) if shape[0] == 'J' else tp.gemm_chosen(*shape)
    plans = tp.candidates(chosen)
    names = [tp.plan_name(p) for p in plans]
    assert chosen in plans and len(set(names)) == len(names)
    for p in plans:
        assert (p.m, p.n, p.ksteps) == (chosen.m, chosen.n, chosen.ksteps)
        assert chosen.n % p.bn == 0 and 1 <= p.splits <= p.ksteps
        if shape[0] == 'J':
            assert p.bn in cv.BN_CHOICES
        else:
            assert (p.geglu, p.bn, p.per_sm) in mm.GEMM_TILES and p.splits <= mm.MAX_SPLITS
