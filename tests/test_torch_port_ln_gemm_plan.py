"""Kernels G, H and I's tiles and launch plan (``hcpdiff_tpu_torch/ops/
matmul.py:ln_gemm_plan``), on the CPU: the plan is plain Python, and the
kernel (``csrc/ln_gemm_wgmma.cu``) takes its tile and runs of column tiles
as given, so they are checked here for every LayerNorm GEMM the fused
UNets run.

The tiles are data in the CUDA source: its HCP_LN_GEMM_TILES table, read
here and held to the plan's LN_GEMM_TILES, to the card's shared memory
(the resident rows at the widest K each tile takes, the weight ring, the
staging buffer) and to wgmma's N.

Shapes: the fused SD1.5 transformer blocks' G (x [M, C], three weights
[C, C]), H (x [M, C], w [8C, C]) and I (x [M, C], w [C, C]) at every
level (64x64, 32x32, 16x16 latents with C = 320, 640, 1280, and the 8x8
mid block with 1280) at batch 1, 2 and 4 of a 512 px request under CFG
(M = 2 * batch * S), and the tiny UNet's at ragged M. For each, the
plan's block -> (row tile, column tiles) mapping is replayed as the
kernel computes it. Also the plans ``tools/time_plans.py`` times, and the
lines ``tools/ln_phases.py`` instruments.
"""
import re
from pathlib import Path

import pytest
import torch

from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.ops import _plan
from hcpdiff_tpu_torch.ops import matmul as mm
from hcpdiff_tpu_torch.tools import ln_phases
from hcpdiff_tpu_torch.tools import time_plans as tp

CSRC = Path(mm.__file__).resolve().parent.parent / 'csrc'
MAX_SMEM = 232448                # 227 KB: the most shared memory a block may use
SM_SMEM = 233472                 # 228 KB an SM, of which each block takes 1 KB more
WGMMA_SS_N = (32, 48, 64, 128, 160)   # csrc/wgmma.cuh's Wgmma<N> (both operands in smem)
THREADS = 256

# (latent side, channels) of SD1.5's transformer levels; the mid block is 8x8
SD15_LEVELS = ((64, 320), (32, 640), (16, 1280), (8, 1280))
BATCHES = (1, 2, 4)
WAVE = _plan.WAVE_FILL * _plan.SMS    # a grid of this many blocks fills the card


def _source_tiles():
    """(geglu, R, BN, stages, blocks an SM) of csrc/ln_gemm_wgmma.cu's rows
    X(GEGLU, R, BN, STAGES, MINB)."""
    src = (CSRC / 'ln_gemm_wgmma.cu').read_text()
    table = src[src.index('#define HCP_LN_GEMM_TILES('):]
    table = table[:table.index('\n\n')]
    rows = re.findall(r'X\((true|false), (\d+), (\d+), (\d+), (\d+)\)', table)
    return tuple((g == 'true', int(r), int(bn), int(s), int(m)) for g, r, bn, s, m in rows)


def _max_kpad(geglu, rows, bn, stages, per_sm):
    """The widest K (whole 64-channel steps) whose rows fit, as LnCfg::MAX_KPAD."""
    cap = MAX_SMEM if per_sm == 1 else SM_SMEM // per_sm - 1024
    fixed = mm.ln_gemm_smem(geglu, rows, bn, stages, 0)
    return (cap - fixed) // (2 * rows) // mm.BK * mm.BK


def test_plan_tiles_are_the_sources():
    assert _source_tiles() == mm.LN_GEMM_TILES


@pytest.mark.parametrize('tile', mm.LN_GEMM_TILES, ids=[str(t) for t in mm.LN_GEMM_TILES])
def test_every_tile_fits_the_card(tile):
    geglu, rows, bn, stages, per_sm = tile
    kpad = _max_kpad(*tile)
    assert kpad >= mm.BK
    assert mm.ln_gemm_fits(*tile, kpad // mm.BK) and not mm.ln_gemm_fits(*tile, kpad // mm.BK + 1)
    smem = mm.ln_gemm_smem(geglu, rows, bn, stages, kpad // mm.BK)
    assert smem <= MAX_SMEM and per_sm * (smem + 1024) <= SM_SMEM
    # the LayerNorm scale and shift (4K bytes) pass through the staging buffer
    assert mm.ln_gemm_smem(geglu, rows, bn, stages, 0) - stages * (
        2 * bn if geglu else bn) * mm.BK * 2 - 1024 >= 4 * kpad
    b_rows = 2 * bn if geglu else bn
    assert rows in (64, 128) and stages >= 3 and per_sm in (1, 2)
    # wgmma N: R = 128 multiplies the whole stage (H: value and gate rows in
    # one product), R = 64 gives each warpgroup half the stage's weight rows
    assert (b_rows // 2 if rows == 64 else b_rows) in WGMMA_SS_N
    assert b_rows % 32 == 0              # a thread copies weight rows r, r + 32, ..
    # the epilogue's 16-byte chunks of a staged row (bn bf16, or half of
    # them in fp32, a pass) split evenly over the threads
    assert rows * (bn * 2 // 16) % THREADS == 0 and (bn // 2) % 8 == 0


def test_the_widths_each_tile_serves():
    """R = 128 holds SD1.5's 64x64 rows (K = 320) for all three kernels and
    H's 32x32 rows (K = 640); R = 64 holds every width up to 1280."""
    widest = {t: _max_kpad(*t) for t in mm.LN_GEMM_TILES}
    assert widest[(False, 128, 160, 3, 1)] >= 320 and widest[(True, 128, 64, 3, 1)] >= 640
    assert all(k >= 1280 for (g, r, bn, s, m), k in widest.items() if r == 64)


def _sd15_shapes():
    """(label, geglu, nw, M, N, K) of every G, H and I of the fused SD1.5 UNet."""
    shapes = []
    for side, C in SD15_LEVELS:
        for b in BATCHES:
            M = 2 * b * side * side
            shapes += [(f'G {side} b{b}', False, 3, M, C, C),
                       (f'H {side} b{b}', True, 1, M, 4 * C, C),
                       (f'I {side} b{b}', False, 1, M, C, C)]
    return shapes


def _tiny_shapes():
    """G, H and I of every transformer block of the tiny UNet, at ragged M."""
    with torch.device('meta'):           # shapes only: no weights are made
        unet = tunet.UNet2DCondition(tunet.UNetConfig.tiny())
    dims = sorted({m.proj.in_features for m in unet.modules()
                   if isinstance(m, tunet.GEGLUFeedForward)})
    assert dims
    return [(f'tiny {kind} C={C} M={M}', kind == 'H', 3 if kind == 'G' else 1, M,
             4 * C if kind == 'H' else C, C)
            for C in dims for M in (7, 300, 512, 1000, 2048) for kind in 'GHI']


SHAPES = _sd15_shapes() + _tiny_shapes()


@pytest.mark.parametrize('label,geglu,nw,M,N,K', SHAPES, ids=[s[0] for s in SHAPES])
def test_ln_gemm_plan_covers_the_outputs(label, geglu, nw, M, N, K):
    plan = mm.ln_gemm_plan(geglu, nw, M, N, K)
    assert (plan.geglu, plan.nw, plan.m, plan.n, plan.ksteps) == (geglu, nw, M, N, -(-K // mm.BK))
    assert plan.tile in mm.LN_GEMM_TILES
    assert plan.smem <= MAX_SMEM and plan.ksteps * mm.BK <= _max_kpad(*plan.tile)
    assert 1 <= plan.groups <= plan.tiles
    # replay the grid: block (group, row tile) walks column tiles
    # tile_range(group); tile c is weight c // n_tiles, columns from
    # (c % n_tiles) * bn
    n_tiles = -(-N // plan.bn)
    assert plan.tiles == nw * n_tiles
    covered = {}
    stats = {}
    for my in range(plan.m_tiles):
        for group in range(plan.groups):
            start, stop = plan.tile_range(group)
            assert start < stop               # no block without a tile
            stats[my] = stats.get(my, 0) + 1  # each block normalizes its rows once
            for c in range(start, stop):
                covered[(my, c)] = covered.get((my, c), 0) + 1
    # every output tile of every weight exactly once
    assert covered == {(my, c): 1 for my in range(plan.m_tiles) for c in range(plan.tiles)}
    # the row tiles cover M and the column tiles N, the last of each starting inside it
    assert (plan.m_tiles - 1) * plan.rows < M <= plan.m_tiles * plan.rows
    assert (n_tiles - 1) * plan.bn < N <= n_tiles * plan.bn
    # a row's statistics are computed by at most `groups` blocks
    assert set(stats.values()) == {plan.groups}
    # the grid fills a wave where the shape has the tiles for one
    if plan.m_tiles * plan.tiles >= WAVE:
        assert plan.blocks >= WAVE, plan


def test_one_run_a_row_tile_where_the_rows_fill_the_card():
    """At the 64x64 level of a batch-2 and batch-4 request (256 and 512 row
    tiles of 64, or 128 and 256 of 128) the row tiles alone fill the card,
    so each row's statistics are computed once."""
    for b in (2, 4):
        M = 2 * b * 4096
        for geglu, nw, N in ((False, 3, 320), (True, 1, 1280), (False, 1, 320)):
            plan = mm.ln_gemm_plan(geglu, nw, M, N, 320)
            assert plan.groups == 1 and plan.rows == 128, plan


@pytest.mark.parametrize('shape', tp.LN_SHAPES, ids=[' '.join(map(str, s)) for s in tp.LN_SHAPES])
def test_time_plans_times_the_chosen_ln_plan(shape):
    """``tools/time_plans.py`` times, for each of its G/H/I shapes, the plan
    the planner picks among plans the kernel is built for, each once."""
    chosen = tp.ln_chosen(*shape)
    plans = tp.candidates(chosen)
    names = [tp.plan_name(p) for p in plans]
    assert chosen in plans and len(set(names)) == len(names)
    for p in plans:
        assert (p.geglu, p.nw, p.m, p.n, p.ksteps) == (
            chosen.geglu, chosen.nw, chosen.m, chosen.n, chosen.ksteps)
        assert p.tile in mm.LN_GEMM_TILES and mm.ln_gemm_fits(*p.tile, p.ksteps)
        assert 1 <= p.groups <= p.tiles


def test_ln_phases_instruments_the_kernel():
    """tools/ln_phases.py finds every line it instruments in the kernel's
    source, once, and counts each phase."""
    src = ln_phases.instrument((CSRC / 'ln_gemm_wgmma.cu').read_text())
    for line, before, after in ln_phases.ANCHORS:
        assert src.count(before + line + after) == 1
    assert src.count('ph_wait +=') == src.count('ph_mma +=') == src.count('ph_epi +=') == 1
    assert 'extern "C" int hcp_ln_phases' in src
