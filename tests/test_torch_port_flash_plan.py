"""The launch plans of kernels A, E and F, E and F's D=512 chunking, and
the plain versions the D=512 kernels are held to, on the CPU.

The plans are data in the CUDA sources: ``csrc/flash_attention.cu``'s
HCP_FLASH_PLANS table, ``csrc/flash_attention_bwd_dq.cu``'s
HCP_FLASH_DQ_PLANS and ``csrc/flash_attention_bwd_dkv.cu``'s
HCP_FLASH_DKV_PLANS (one row per padded head dim; E and F below 512), and
the template arguments of E and F's D-chunked launches, read here from the
source. Each plan must fit the card: shared memory (with the blocks an SM
it asks for), wgmma's N, swizzle blocks that tile the head dim, an output
split that covers it exactly. A plan serves the causal and non-causal
instances (and A's with or without lse, a run-time flag). Then the plain
versions (what
chip_smoke.py and the card tests hold the D=512 kernels against) against
the JAX package's ``_flash_forward_lse`` and ``_flash_backward`` at
[1, 1, 128, 512], causal and not, in Pallas interpret mode, in fp32: 1e-4
on o and the gradients, 1e-5 on lse, as in
tests/test_torch_port_flash_classic.py.
"""
import re
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest

from hcpdiff_tpu_torch.ops import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parent.parent / 'csrc'
WGMMA_N = range(8, 257, 8)       # wgmma m64nNk16 with bf16 operands
# the N each instantiated product has in csrc/wgmma.cuh: Wgmma (both
# operands in shared memory) and WgmmaRS (A from registers)
WGMMA_SS_N = (32, 48, 64, 128, 160)
WGMMA_RS_N = (48, 64, 80, 128, 160, 256)
SWIZZLES = (32, 64, 128)
MAX_SMEM = 232448                # 227 KB: the most shared memory a block may use
SM_SMEM = 233472                 # 228 KB an SM, of which each block takes 1 KB more

BQ = 128                         # query rows a block: two warpgroups of 64

Plan = namedtuple('Plan', 'dp bkv stages dvc swizzle min_blocks')


def _plans(source='flash_attention.cu', table='HCP_FLASH_PLANS'):
    """{DP: Plan} from the rows X(DP, BKV, STAGES, DVC, SW, MINB) of a plan
    table (E and F's: X(DP, BKV or BQ, STAGES, DVC, SW, MINB))."""
    src = (CSRC / source).read_text()
    table = src[src.index('#define ' + table + '('):]
    table = table[:table.index('\n\n')]
    rows = [Plan(*map(int, row)) for row in
            re.findall(r'X\(' + ', '.join([r'(\d+)'] * 6) + r'\)', table)]
    return {p.dp: p for p in rows}


BWD_TABLES = {'E': ('flash_attention_bwd_dq.cu', 'HCP_FLASH_DQ_PLANS'),
              'F': ('flash_attention_bwd_dkv.cu', 'HCP_FLASH_DKV_PLANS')}
BWD_DIMS = tuple(d for d in fa.PADDED_HEAD_DIMS if d < 512)   # 512: the chunked variants


def _smem_bytes(p):
    """As the kernel's Plan::SMEM: Q (BQ rows), the ring (each slot a
    K tile and V's output chunk), and 1024 bytes to align the tiles to the
    swizzle's period."""
    return 2 * (BQ * p.dp + p.stages * p.bkv * (p.dp + p.dvc)) + 1024


def test_every_built_head_dim_has_one_plan():
    assert tuple(sorted(_plans())) == fa.PADDED_HEAD_DIMS
    assert len(re.findall(r'\n    X\(', (CSRC / 'flash_attention.cu').read_text())) == len(
        fa.PADDED_HEAD_DIMS)


@pytest.mark.parametrize('dp', fa.PADDED_HEAD_DIMS)
def test_flash_plan_fits_the_card(dp):
    p = _plans()[dp]
    assert dp % 16 == 0
    assert _smem_bytes(p) <= MAX_SMEM
    assert p.min_blocks in (1, 2) and p.min_blocks * (_smem_bytes(p) + 1024) <= SM_SMEM
    # S = Q K^T is m64n{bkv}k16 (bkv keys, in k16 slices for O += P V);
    # O += P V is m64n{dvc}k16
    assert p.bkv in WGMMA_N and p.bkv % 16 == 0
    assert p.dvc in WGMMA_N
    # the swizzled blocks (swizzle / 2 bf16 columns) tile Q, K and V's chunk
    assert p.swizzle in SWIZZLES
    width = p.swizzle // 2
    assert dp % width == 0 and p.dvc % width == 0
    # the widest swizzle that tiles DP: no column past DP's multiple of 16
    assert all(dp % (s // 2) for s in SWIZZLES if s > p.swizzle)
    # grid.z's dp // dvc output chunks cover DP exactly, once
    assert dp % p.dvc == 0
    # every tile starts on the swizzle's 1024-byte period
    assert all(n % 1024 == 0 for n in (BQ * dp * 2, p.bkv * dp * 2, p.bkv * p.dvc * 2))
    assert p.stages >= 2


def _bwd_smem_bytes(kernel, p):
    """As the kernels' BwdPlan::SMEM: two resident tiles of 128 rows (E: Q
    and dO; F: K and V), the ring (each slot two streamed tiles, E: K and V,
    F: Q and dO, and F's lse and delta, 4 bytes a query each) and 1024
    bytes to align the tiles to the swizzle's period."""
    stat = 2 * p.bkv * 4 if kernel == 'F' else 0
    return 2 * BQ * p.dp * 2 + p.stages * (2 * p.bkv * p.dp * 2 + stat) + 1024


@pytest.mark.parametrize('kernel', ['E', 'F'])
def test_every_backward_head_dim_has_one_plan(kernel):
    source, table = BWD_TABLES[kernel]
    assert tuple(sorted(_plans(source, table))) == BWD_DIMS
    assert len(re.findall(r'\n    X\(', (CSRC / source).read_text())) == len(BWD_DIMS)


@pytest.mark.parametrize('dp', BWD_DIMS)
@pytest.mark.parametrize('kernel', ['E', 'F'])
def test_backward_plan_fits_the_card(kernel, dp):
    """E and F's plan at DP: shared memory, with MINB blocks an SM; the
    streamed tile is the N of the first products (S, dP: Wgmma) and the
    depth of the second (k16 slices); the output chunk DVC is the N of the
    second (WgmmaRS) and divides DP (E: whole rows); the swizzle is the
    widest that tiles DP and DVC; F splits no output at DP <= 80."""
    p = _plans(*BWD_TABLES[kernel])[dp]
    smem = _bwd_smem_bytes(kernel, p)
    assert smem <= MAX_SMEM
    assert p.min_blocks in (1, 2) and p.min_blocks * (smem + 1024) <= SM_SMEM
    assert p.bkv in WGMMA_SS_N and p.bkv % 16 == 0
    assert p.dvc in WGMMA_RS_N and dp % p.dvc == 0
    assert p.dvc == dp if kernel == 'E' or dp <= 80 else p.dvc <= dp
    assert p.swizzle in SWIZZLES
    width = p.swizzle // 2
    assert dp % width == 0 and p.dvc % width == 0
    assert all(dp % (s // 2) or p.dvc % (s // 2) for s in SWIZZLES if s > p.swizzle)
    # every tile (and F's lse/delta after the ring) starts on the swizzle's
    # 1024-byte period
    assert all(n % 1024 == 0 for n in (BQ * dp * 2, p.bkv * dp * 2, 64 * p.swizzle))
    assert p.stages >= 2


def _chunked_launch(name):
    """The template arguments <DP, DC, DVC> of a D-chunked backward launch."""
    src = ''.join(p.read_text() for p in CSRC.glob('flash_attention_bwd_*.cu'))
    return tuple(map(int, re.search(name + r'<(\d+), (\d+), (\d+)>\(', src).groups()))


@pytest.mark.parametrize('name', ['launch_dq_chunked', 'launch_dkv_chunked'])
def test_backward_chunking_covers_512(name):
    """E and F at DP=512: S and dP over D in chunks of DC, outputs in
    chunks of DVC over grid.z; both cover DP exactly, and the four [64][DC
    + 8] shared slots plus the transposed [DVC][72] tiles (E one; F two and
    2 x 64 floats) fit a block."""
    dp, dc, dvc = _chunked_launch(name)
    assert dp == max(fa.PADDED_HEAD_DIMS) == 512
    assert dp % dc == 0 and dp % dvc == 0 and dc % 16 == 0 and dvc % 8 == 0
    tiles = 2 if 'dkv' in name else 1
    smem = (4 * 64 * (dc + 8) + tiles * dvc * 72) * 2 + (2 * 64 * 4 if tiles == 2 else 0)
    assert smem <= MAX_SMEM


@pytest.mark.parametrize('causal', [False, True])
def test_plain_versions_match_jax_at_512(causal):
    import jax.numpy as jnp
    import torch
    from jax.experimental.pallas import tpu as pltpu

    from hcpdiff_tpu.ops import flash_attention as jfa
    B, H, S, D, BLOCK = 1, 1, 128, 512, 128
    rng = np.random.default_rng(70 + causal)
    q, k, v, g = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4))
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_forward_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                        scale, BLOCK, BLOCK)
        ref = jfa._flash_backward(*(jnp.asarray(a) for a in (q, k, v)), o, lse,
                                  jnp.asarray(g), causal, scale, BLOCK, BLOCK)
    o, lse = np.array(o), np.array(lse)[..., 0]
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    np.testing.assert_allclose(fa.attention_plain(t[0], t[1], t[2], scale, causal).numpy(), o,
                               atol=1e-4)
    np.testing.assert_allclose(fa.attention_lse_plain(t[0], t[1], scale, causal).numpy(), lse,
                               atol=1e-5)
    grads = fa.flash_attention_backward_plain(t[0], t[1], t[2], torch.from_numpy(o),
                                              torch.from_numpy(lse), t[3], scale, causal)
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
