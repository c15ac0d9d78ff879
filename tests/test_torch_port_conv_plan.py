"""Kernel J's launch plan (``hcpdiff_tpu_torch/ops/conv.py:conv_plan``), on
the CPU: the plan is plain Python, and the kernel (``csrc/conv.cu``) takes
its tiles, K ranges and workspace as given, so they are checked here for
every conv the fused UNet runs.

Shapes: the 14 (level, Cin, Cout) triples of SD1.5's resblock convs at UNet
batch 8 (a batch-4 request under CFG) at 512 px, and every resblock conv of
the tiny UNet at a 32x32 latent and batch 2.
"""
import pytest
import torch

from hcpdiff_tpu_torch.models import unet as tunet
from hcpdiff_tpu_torch.ops import conv as cv

SD15 = [(64, 320, 320), (64, 640, 320), (64, 960, 320),
        (32, 320, 640), (32, 640, 640), (32, 960, 640), (32, 1280, 640), (32, 1920, 640),
        (16, 640, 1280), (16, 1280, 1280), (16, 1920, 1280), (16, 2560, 1280),
        (8, 1280, 1280), (8, 2560, 1280)]


def _resblock_convs(cfg, latent):
    """(size, Cin, Cout) of each resblock conv of a UNet at a square latent."""
    with torch.device('meta'):           # shapes only: no weights are made
        unet = tunet.UNet2DCondition(cfg)
    n = len(cfg.block_out_channels)
    convs = set()
    for name, m in unet.named_modules():
        if isinstance(m, tunet.ResnetBlock2D):
            part, bi = name.split('_')[:2]
            level = n - 1 if part == 'mid' else int(bi) if part == 'down' else n - 1 - int(bi)
            size = latent >> level
            convs.add((size, m.conv1.in_channels, m.conv1.out_channels))
            convs.add((size, m.conv2.in_channels, m.conv2.out_channels))
    return sorted(convs)


def test_sd15_conv_list_is_the_unets():
    """The SD1.5 triples above are exactly the UNet's resblock convs at a
    64x64 latent."""
    assert set(SD15) == set(_resblock_convs(tunet.UNetConfig.sd15(), 64))


TINY = [(2, *c) for c in _resblock_convs(tunet.UNetConfig.tiny(), 32)]


@pytest.mark.parametrize('B,size,Cin,Cout', [(8, *c) for c in SD15] + TINY)
def test_conv_plan_covers_the_conv(B, size, Cin, Cout):
    plan = cv.conv_plan(B, size, size, Cin, Cout)
    M = B * size * size
    assert (plan.m, plan.n, plan.ksteps) == (M, Cout, 9 * -(-Cin // cv.BK_CHANNELS))
    assert plan.bn in cv.BN_CHOICES and 1 <= plan.splits <= cv.MAX_SPLITS
    # the tiles cover M x N once: the last tile of each dim starts inside it
    assert (plan.m_tiles - 1) * cv.BM < M <= plan.m_tiles * cv.BM
    assert (plan.n_tiles - 1) * plan.bn < Cout <= plan.n_tiles * plan.bn
    # BN divides Cout at every SD1.5 width; elsewhere the waste is the least
    # any built tile gives
    if B == 8:
        assert plan.waste == 0
    assert plan.waste == min(-(-Cout // bn) * bn - Cout for bn in cv.BN_CHOICES)
    # the K ranges partition [0, ksteps) in whole, non-empty steps, in order
    ranges = [plan.k_range(z) for z in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.ksteps
    assert all(a < b for a, b in ranges)
    assert all(ranges[z][1] == ranges[z + 1][0] for z in range(plan.splits - 1))
    # a split grid reaches a wave, and only a grid short of one is split
    if plan.splits > 1:
        assert plan.blocks >= cv.WAVE_FILL * cv.SMS
        assert plan.m_tiles * plan.n_tiles < cv.WAVE_FILL * cv.SMS
    ws = cv.split_workspace(plan, 'cpu')
    if plan.splits == 1:
        assert ws is None
    else:
        assert ws.dtype == torch.float32 and ws.numel() == plan.splits * M * Cout


def test_conv_plan_at_the_unets_small_levels():
    """The 8x8 level (4 row tiles) and the 16x16 level's deep convs are
    split to a wave; level 0 needs no split and takes one 320-wide column
    tile (Cout 320)."""
    for size, Cin in ((8, 1280), (8, 2560), (16, 1280), (16, 2560)):
        plan = cv.conv_plan(8, size, size, Cin, 1280)
        assert plan.splits > 1 and plan.blocks >= cv.WAVE_FILL * cv.SMS
    plan = cv.conv_plan(8, 64, 64, 320, 320)
    assert (plan.bn, plan.splits, plan.blocks) == (320, 1, 256)
