"""Projection GEMMs with fused epilogues and LayerNorm prologues: kernels B
(``geglu_dense``), C (``fused_dense``), G (``ln_qkv``), H (``ln_geglu``)
and I (``ln_dense``), their plain PyTorch versions, B and C's launch plan,
and the ``torch.autograd.Function`` of each.

Counterpart of ``hcpdiff_tpu/ops/matmul.py``. Weights follow
``nn.Linear``'s [out, in] layout (the weight bridge transposes the JAX
[in, out] kernels), so ``y = x @ w.T``. B and C live in
``csrc/gemm_wgmma.cu``, G, H and I in ``csrc/ln_gemm_wgmma.cu`` (see their
headers for the designs). The backwards are the JAX ``custom_vjp``s'
(``matmul.py:231-238``, ``:259-266``, ``:369-381``, and the vjps of the
LayerNorm GEMMs' ``_ref``s, ``:458-467``, ``:562-571``, ``:612-619``):
plain torch in fp32, which XLA computes there and cuBLAS here.

The kernels take bf16 or fp32 tensors. An fp32 call rounds x, the weights
and the LayerNorm scale and shift to bf16 (the TPU's default precision for
an fp32 product: bf16 operands, fp32 accumulation); bias, residual and
output stay fp32, so the result is rounded once.

B and C's launch plan (:func:`gemm_plan`, plain Python) picks the column
tile BN and a split of K over ``splits`` blocks for each shape; G, H and
I's (:func:`ln_gemm_plan`) the rows a block holds, the column tile and how
many blocks share a row tile's column tiles; see their docstrings.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import accum_dtype, aligned16, check, library, require, require_cuda, stream_handle
from ._plan import BM, SMS, WAVE_FILL, TilePlan, split_workspace

_DENSE, _DENSE_RES, _GEGLU = 0, 1, 2   # csrc/gemm_wgmma.cu and csrc/ln_gemm_wgmma.cu modes

# csrc/gemm_wgmma.cu: channels per K step (BM rows of x per block), and
# its HCP_GEMM_TILES table, (GEGLU?, BN, blocks an SM) -> ring stages
BK = 64
GEMM_TILES = {(True, 64, 2): 3, (False, 160, 1): 5, (False, 160, 2): 3, (False, 128, 2): 3}
MAX_SPLITS = 16
# the plan's cost model: seconds per output column of one block's K step
# (2 * BM * 64 FLOPs at half of one SM's share of 989 TFLOP/s), the fixed
# per-step share in columns (the x tile's copies and the step's barrier),
# a block's fixed time (filling the ring, the epilogue), which a second
# block on the SM hides, the slowdown of a two-block tile alone on its SM
# (its steps wait for their own products), and the split partial sums'
# cost: the rate at which they are written and read back, and the second
# kernel's launch. Tuned to tools/time_plans.py's times (PERF.md).
_STEP_S = 2 * BM * BK / (0.5 * 989e12 / SMS)
_STEP_FIXED_COLUMNS = 64
_BLOCK_FIXED_S = 2e-6
_ALONE_SLOWDOWN = 1.35
_REDUCE_BYTES_PER_S = 2.5e12
_REDUCE_FIXED_S = 5e-6


@dataclasses.dataclass(frozen=True)
class GemmPlan(TilePlan):
    """How kernel B (``geglu``) or C covers out[M, N] (``TilePlan``), with
    the tile built for `per_sm` blocks an SM (GEMM_TILES); a K step is 64
    channels, zero-padded past K: ``ksteps = ceil(K / 64)``. B's partial
    sums hold the value and the gate columns, 2N a row."""
    geglu: bool
    per_sm: int

    @property
    def partial_columns(self) -> int:
        return 2 * self.n if self.geglu else self.n


@functools.lru_cache(maxsize=None)
def gemm_plan(geglu: bool, M: int, N: int, K: int) -> GemmPlan:
    """BN and the K split of kernel B (``geglu``) or C for out[M, N] with K
    input channels (cached: the UNet asks for the same few shapes at every
    step).

    The tile is one of GEMM_TILES whose BN divides N where one does
    (SD1.5's 320, 640 and 1280 all divide by 160; B's one tile, 64, divides
    1280-5120); where none does, those wasting the fewest columns of the last
    tile. Among those and splits S <= MAX_SPLITS, the plan takes the least
    estimated time: waves of blocks (an SM holds up to the tile's blocks an
    SM) x (K steps a block x (the columns its SM's blocks multiply + a fixed
    share) + a block's fixed time, shared by the blocks an SM), and the
    split partial sums' cost. The model alone decides the split: it pays
    only where the unsplit grid leaves SMs idle."""
    ksteps = -(-K // BK)
    tiles_built = [(bn, per_sm) for g, bn, per_sm in GEMM_TILES if g == geglu]
    waste = {bn: -(-N // bn) * bn - N for bn, _ in tiles_built}
    best = None
    for bn, per_sm in tiles_built:
        if waste[bn] != min(waste.values()):
            continue
        cols = (2 if geglu else 1) * bn
        tiles = -(-M // BM) * -(-N // bn)
        for s in range(1, min(MAX_SPLITS, ksteps) + 1):
            occ = min(per_sm, -(-tiles * s // SMS))      # blocks an SM holds at once
            waves = math.ceil(tiles * s / (SMS * occ))
            step = (occ * cols + _STEP_FIXED_COLUMNS) * _STEP_S
            if occ < per_sm:
                step *= _ALONE_SLOWDOWN
            est = waves * (-(-ksteps // s) * step + _BLOCK_FIXED_S / occ)
            if s > 1:
                est += (2 * 4 * s * M * N * (2 if geglu else 1) / _REDUCE_BYTES_PER_S
                        + _REDUCE_FIXED_S)
            key = (est, -bn, s)
            if best is None or key < best[0]:
                best = (key, bn, per_sm, s)
    return GemmPlan(best[1], best[3], M, N, ksteps, geglu, best[2])


# csrc/ln_gemm_wgmma.cu: its HCP_LN_GEMM_TILES table, (GEGLU?, rows a
# block, BN, ring stages, blocks an SM), and the shared memory a block and
# an SM hold
LN_GEMM_TILES = ((False, 128, 160, 3, 1), (False, 64, 128, 3, 1), (True, 128, 64, 3, 1),
                 (True, 64, 64, 3, 1))
MAX_SMEM, SM_SMEM = 232448, 233472
# the plan's cost model: the tensor cores' share of their peak that a
# block's products reach, the L2's rate for the weight tiles all blocks
# stream, device memory's and one SM's most, a column tile's epilogue (128
# rows; H adds its GELU gate, about 25 fp32 operations an output at 128 a
# cycle), and a block's fixed time (its launch, the statistics)
_LN_MMA_EFF = 0.8
_L2_BYTES_PER_S = 5.5e12
_HBM_BYTES_PER_S = 3.35e12
_SM_BYTES_PER_S = 112e9
_LN_EPI_S = 1e-6
_GELU_S = 25 / (128 * 1.755e9)
_LN_BLOCK_FIXED_S = 2e-6


def ln_gemm_smem(geglu: bool, rows: int, bn: int, stages: int, ksteps: int) -> int:
    """A block's shared memory, as csrc/ln_gemm_wgmma.cu's LnCfg: the
    resident rows (ksteps of 64 channels), the weight ring, the staging
    buffer (a 16-byte-padded row of bn bf16 outputs, or H's fp32 gate rows
    at 64 rows where they are larger), + 1024 bytes of alignment."""
    ring = stages * (2 * bn if geglu else bn) * BK * 2
    staging = rows * (2 * bn + 16)
    if geglu and rows == 64:
        staging = max(staging, rows * (4 * bn + 16))
    return rows * ksteps * BK * 2 + ring + staging + 1024


def ln_gemm_fits(geglu: bool, rows: int, bn: int, stages: int, per_sm: int, ksteps: int) -> bool:
    """Whether per_sm blocks of the tile fit an SM at ksteps K steps."""
    smem = ln_gemm_smem(geglu, rows, bn, stages, ksteps)
    return smem <= MAX_SMEM and per_sm * (smem + 1024) <= SM_SMEM


@dataclasses.dataclass(frozen=True)
class LnGemmPlan:
    """How kernel G, H (``geglu``) or I covers its nw outputs [m, n] with
    K steps of 64 channels: blocks of ``rows`` rows (``per_sm`` an SM),
    each holding its rows normalized in shared memory and walking a run of
    column tiles of ``bn`` columns, a weight's tiles after the previous
    weight's (G: q, k, v); ``groups`` runs a row tile, so a row's
    statistics are computed ``groups`` times. The grid is (groups,
    m_tiles)."""
    geglu: bool
    nw: int
    m: int
    n: int
    ksteps: int
    rows: int
    bn: int
    stages: int
    per_sm: int
    groups: int

    @property
    def tile(self):
        """The tile's row of LN_GEMM_TILES."""
        return self.geglu, self.rows, self.bn, self.stages, self.per_sm

    @property
    def m_tiles(self) -> int:
        return -(-self.m // self.rows)

    @property
    def tiles(self) -> int:
        """Column tiles of all the weights."""
        return self.nw * -(-self.n // self.bn)

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.groups

    def tile_range(self, group: int):
        """The column tiles [start, stop) of run `group`, as the kernel computes them."""
        return group * self.tiles // self.groups, (group + 1) * self.tiles // self.groups

    @property
    def smem(self) -> int:
        return ln_gemm_smem(self.geglu, self.rows, self.bn, self.stages, self.ksteps)


def _ln_gemm_cost(plan: LnGemmPlan) -> float:
    """Estimated seconds: waves of blocks (one an SM, as every built tile
    is), each loading its rows, then per column tile the slowest of its
    products, its weight tiles' L2 reads and its output's write, and its
    epilogue."""
    active = min(plan.blocks, SMS)
    l2 = min(_L2_BYTES_PER_S / active, _SM_BYTES_PER_S)
    hbm = min(_HBM_BYTES_PER_S / active, _SM_BYTES_PER_S)
    b_rows = 2 * plan.bn if plan.geglu else plan.bn
    per_tile = max(plan.ksteps * 2 * plan.rows * b_rows * BK / (_LN_MMA_EFF * 989e12 / SMS),
                   plan.ksteps * b_rows * BK * 2 / l2, plan.rows * plan.bn * 2 / hbm)
    per_tile += (_LN_EPI_S * plan.rows / 128
                 + (plan.rows * plan.bn * _GELU_S if plan.geglu else 0.0))
    run = -(-plan.tiles // plan.groups)
    block = plan.rows * plan.ksteps * BK * 2 / hbm + _LN_BLOCK_FIXED_S + run * per_tile
    return math.ceil(plan.blocks / SMS) * block


@functools.lru_cache(maxsize=None)
def ln_gemm_plan(geglu: bool, nw: int, M: int, N: int, K: int) -> LnGemmPlan:
    """The tile and the runs of kernel G (nw = 3), I (nw = 1) or H
    (``geglu``) for outputs [M, N] with K input channels (cached).

    Among the built tiles whose blocks fit an SM at K, and groups from 1 to
    the column tiles, it takes the least estimated time
    (:func:`_ln_gemm_cost`) among the plans whose grid fills a wave
    (WAVE_FILL of the SMs) where some plan's does; ties go to fewer groups,
    so a row's statistics are computed as few times as the card allows."""
    ksteps = -(-K // BK)
    plans = [LnGemmPlan(geglu, nw, M, N, ksteps, rows, bn, stages, per_sm, groups)
             for g, rows, bn, stages, per_sm in LN_GEMM_TILES
             if g == geglu and ln_gemm_fits(g, rows, bn, stages, per_sm, ksteps)
             for groups in range(1, nw * -(-N // bn) + 1)]
    wave = WAVE_FILL * SMS
    full = [p for p in plans if p.blocks >= wave]
    return min(full or plans, key=lambda p: (_ln_gemm_cost(p), p.groups, -p.rows))


# The plain versions compute in the accumulation dtype and round once, as
# the kernels' fp32 epilogues (and the JAX _refs) do: a bf16 product
# rounded before a cancelling residual is added keeps that rounding's
# error beside a small result.
def fused_dense_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                      res: Optional[torch.Tensor] = None) -> torch.Tensor:
    dt = accum_dtype(x)
    y = F.linear(x.to(dt), w.to(dt), None if b is None else b.to(dt))
    return (y if res is None else y + res.to(dt)).to(x.dtype)


def geglu_dense_plain(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    dt = accum_dtype(x)
    h, gate = F.linear(x.to(dt), w.to(dt), None if b is None else b.to(dt)).chunk(2, dim=-1)
    return (h * F.gelu(gate)).to(x.dtype)


def _launch(name: str, mode: int, x, w, b, res, n_out: int,
            plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """``plan`` defaults to :func:`gemm_plan` of the shape."""
    dt = require_cuda(name, x, w, b, res)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    K = x.shape[-1]
    require(x.is_contiguous() and w.is_contiguous() and aligned16(x) and aligned16(w),
            name, 'x and w must be contiguous and 16-byte aligned')
    require(w.dim() == 2 and w.shape[1] == K, name,
            f'w must be [N, K={K}], got {tuple(w.shape)}')
    require(K % 8 == 0 and n_out % 2 == 0, name,
            f'needs K % 8 == 0 and an even N, got K={K}, N={n_out}')
    if b is not None:
        require(b.shape == (w.shape[0],) and b.is_contiguous(), name,
                f'b must be [{w.shape[0]}]')
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], n_out, dtype=dt, device=x.device)
    if res is not None:
        require(res.shape == out.shape and res.is_contiguous() and aligned16(res), name,
                f'res must be a contiguous {tuple(out.shape)} tensor')
    geglu = mode == _GEGLU
    plan = gemm_plan(geglu, M, n_out, K) if plan is None else plan
    if ((plan.geglu, plan.bn, plan.per_sm) not in GEMM_TILES or not 1 <= plan.splits <= plan.ksteps
            or (plan.geglu, plan.m, plan.n, plan.ksteps) != (geglu, M, n_out, -(-K // BK))):
        require(False, name, f'no kernel instance for {plan}')   # formatted only on failure
    ws = split_workspace(plan, x.device)
    rc = library().hcp_gemm(
        mode, x.data_ptr(), w.data_ptr(), 0 if b is None else b.data_ptr(),
        0 if res is None else res.data_ptr(), out.data_ptr(), 0 if ws is None else ws.data_ptr(),
        M, n_out, K, plan.bn, plan.per_sm, plan.splits, int(dt == torch.float32),
        stream_handle(x.device))
    check(rc, name)
    return out


def _flat(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).to(dt)


def _linear_grads(ctx, x, w, dy2):
    """dx = dy W, dW = dy^T x, db = sum(dy) for the inputs that need them
    (``ctx.needs_input_grad``: frozen weights get no dW); dy2 is [M, N] in
    the accumulation dtype."""
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    dx = (dy2 @ w.to(dy2.dtype)).reshape(ctx.x_shape).to(ctx.x_dtype) if need_x else None
    dw = (dy2.t() @ _flat(x, dy2.dtype)).to(ctx.w_dtype) if need_w else None
    db = dy2.sum(dim=0).to(ctx.b_dtype) if need_b else None
    return dx, dw, db


class _FusedDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, res):
        if x.device.type == 'cpu':
            out = fused_dense_plain(x, w, b, res)
        else:
            out = _launch('fused_dense', _DENSE if res is None else _DENSE_RES,
                          x, w, b, res, w.shape[0])
            fused_dense.launches += 1
        need_x, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(x if need_w else None, w if need_x else None)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        ctx.w_dtype, ctx.b_dtype = w.dtype, None if b is None else b.dtype
        ctx.res_dtype = None if res is None else res.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw, db = _linear_grads(ctx, x, w, _flat(g, accum_dtype(g)))
        dres = g.to(ctx.res_dtype) if ctx.needs_input_grad[3] else None
        return dx, dw, db, dres


class _GegluDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        if x.device.type == 'cpu':
            out = geglu_dense_plain(x, w, b)
        else:
            require(w.shape[0] % 2 == 0, 'geglu_dense', 'w must have an even number of rows')
            out = _launch('geglu_dense', _GEGLU, x, w, b, None, w.shape[0] // 2)
            geglu_dense.launches += 1
        # the backward recomputes [h | gate] = x W^T + b, so it keeps x and W
        ctx.save_for_backward(x, w, b)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        ctx.w_dtype, ctx.b_dtype = w.dtype, None if b is None else b.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        dt = accum_dtype(g)
        y = F.linear(_flat(x, dt), w.to(dt), None if b is None else b.to(dt))
        h, gate = y.chunk(2, dim=-1)
        cdf = 0.5 * (1.0 + torch.erf(gate * math.sqrt(0.5)))
        dgelu = cdf + gate * torch.exp(-0.5 * gate * gate) * (0.5 * math.sqrt(2.0 / math.pi))
        g2 = _flat(g, dt)
        dy = torch.cat([g2 * gate * cdf, g2 * h * dgelu], dim=-1)
        return _linear_grads(ctx, x, w, dy)


def fused_dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T + b (+ res)`` with x [..., K], w [N, K], b [N], res [..., N].
    Differentiable. A CPU tensor takes the plain version; a CUDA tensor
    launches kernel C or raises."""
    return _FusedDense.apply(x, w, b, res)


def geglu_dense(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GEGLU front half, ``(x @ w[:n].T + b[:n]) * gelu(x @ w[n:].T + b[n:])``
    with exact (erf) GELU; x [..., K], w [2n, K] with the value rows first,
    b [2n]; returns [..., n]. Differentiable; the backward recomputes the
    GEMM in fp32 and differentiates it. A CPU tensor takes the plain
    version; a CUDA tensor launches kernel B or raises."""
    return _GegluDense.apply(x, w, b)


fused_dense.launches = 0
geglu_dense.launches = 0


# ------------------------------------------------ LayerNorm-prologue GEMMs ----
# The transformer sublayers each do LayerNorm(x) -> projection(s); kernels
# G, H and I run the LayerNorm in the GEMM's prologue, so the normalized
# activation never reaches device memory and G reads x once for q, k and v.

def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """Row LayerNorm with the TPU kernels' two-pass variance (``_ln_rows``,
    ``matmul.py:404-409``), rounded to x's dtype as the kernels round xn
    before their product; returned in the accumulation dtype."""
    dt = accum_dtype(x)
    xf = x.to(dt)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * g.to(dt) + b.to(dt)).to(x.dtype).to(dt)


def ln_qkv_plain(x, g, b, wq, wk, wv, eps: float = 1e-5):
    xn = _layer_norm(x, g, b, eps)
    return tuple(F.linear(xn, w.to(xn.dtype)).to(x.dtype) for w in (wq, wk, wv))


def ln_dense_plain(x, g, b, w, eps: float = 1e-5):
    xn = _layer_norm(x, g, b, eps)
    return F.linear(xn, w.to(xn.dtype)).to(x.dtype)


def ln_geglu_plain(x, g, b, w, bias=None, eps: float = 1e-5):
    xn = _layer_norm(x, g, b, eps)
    y = F.linear(xn, w.to(xn.dtype), None if bias is None else bias.to(xn.dtype))
    h, gate = y.chunk(2, dim=-1)
    return (h * F.gelu(gate)).to(x.dtype)


def _ln_launch(name: str, mode: int, x, g, b, ws, bias, n_out: int, eps: float,
               plan: Optional[LnGemmPlan] = None):
    """``plan`` defaults to :func:`ln_gemm_plan` of the shape."""
    dt = require_cuda(name, x, g, b, *ws, bias)
    x, g, b = (t.to(torch.bfloat16) for t in (x, g, b))
    ws = [w.to(torch.bfloat16) for w in ws]
    K = x.shape[-1]
    rows = 2 * n_out if mode == _GEGLU else n_out
    for t in (x, g, b, *ws, bias):
        require(t is None or (t.is_contiguous() and aligned16(t)), name,
                'inputs must be contiguous and 16-byte aligned')
    require(g.shape == (K,) and b.shape == (K,), name, f'LayerNorm scale and shift must be [{K}]')
    for w in ws:
        require(w.shape == (rows, K), name, f'w must be [{rows}, {K}], got {tuple(w.shape)}')
    require(bias is None or bias.shape == (rows,), name, f'bias must be [{rows}]')
    require(K % 8 == 0 and n_out % 2 == 0, name,
            f'needs K % 8 == 0 and an even N, got K={K}, N={n_out}')
    M = x.numel() // K
    geglu = mode == _GEGLU
    plan = ln_gemm_plan(geglu, len(ws), M, n_out, K) if plan is None else plan
    if (plan.tile not in LN_GEMM_TILES or not 1 <= plan.groups <= plan.tiles
            or not ln_gemm_fits(*plan.tile, plan.ksteps)
            or (plan.geglu, plan.nw, plan.m, plan.n, plan.ksteps)
            != (geglu, len(ws), M, n_out, -(-K // BK))):
        require(False, name, f'no kernel instance for {plan}')   # formatted only on failure
    outs = [torch.empty(*x.shape[:-1], n_out, dtype=dt, device=x.device) for _ in ws]
    pad = [0] * (3 - len(ws))
    rc = library().hcp_ln_gemm(
        mode, x.data_ptr(), g.data_ptr(), b.data_ptr(), *[w.data_ptr() for w in ws], *pad,
        0 if bias is None else bias.data_ptr(), *[o.data_ptr() for o in outs], *pad,
        len(ws), M, n_out, K, float(eps), plan.rows, plan.bn, plan.stages, plan.per_sm,
        plan.groups, int(dt == torch.float32), stream_handle(x.device))
    check(rc, name)
    return outs


def _ln_qkv_launch(x, g, b, wq, wk, wv, eps):
    return tuple(_ln_launch('ln_qkv', _DENSE, x, g, b, [wq, wk, wv], None, wq.shape[0], eps))


def _ln_dense_launch(x, g, b, w, eps):
    return _ln_launch('ln_dense', _DENSE, x, g, b, [w], None, w.shape[0], eps)[0]


def _ln_geglu_launch(x, g, b, w, bias, eps):
    require(w.shape[0] % 2 == 0, 'ln_geglu', 'w must have an even number of rows')
    return _ln_launch('ln_geglu', _GEGLU, x, g, b, [w], bias, w.shape[0] // 2, eps)[0]


class _LNProjection(torch.autograd.Function):
    """Kernels G, H and I: ``route`` names the function in ``_LN_ROUTES``,
    ``params`` are its weights (and H's bias). The backward is the vjp of
    the plain version recomputed in fp32, as the JAX ``custom_vjp``s take
    ``jax.vjp`` of their ``_ref``s; only the inputs that need a gradient
    get one (frozen weights get no dW)."""

    @staticmethod
    def forward(ctx, route, eps, x, g, b, *params):
        plain, launch, public = _LN_ROUTES[route]
        if x.device.type == 'cpu':
            out = plain(x, g, b, *params, eps=eps)
        else:
            out = launch(x, g, b, *params, eps)
            public.launches += 1
        ctx.save_for_backward(x, g, b, *params)
        ctx.route, ctx.eps = route, eps
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        dt = accum_dtype(grads[0])
        with torch.enable_grad():
            ins = [None if t is None else t.detach().to(dt).requires_grad_(n)
                   for t, n in zip(saved, need)]
            outs = _LN_ROUTES[ctx.route][0](*ins, eps=ctx.eps)
            outs = outs if isinstance(outs, tuple) else (outs,)
            used = [(o, gr.to(dt)) for o, gr in zip(outs, grads) if o.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in used], [t for t in ins if t is not None
                                                                   and t.requires_grad],
                                           [gr for _, gr in used]))
        return (None, None, *(next(got).to(t.dtype) if t is not None and n else None
                              for t, n in zip(saved, need)))


def ln_qkv(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, wq: torch.Tensor,
           wk: torch.Tensor, wv: torch.Tensor, eps: float = 1e-5):
    """LayerNorm(x; g, b, eps) then three bias-free projections of the same
    normalized rows (self-attention q, k, v): x [..., K], g/b [K], each w
    [N, K]; returns (q, k, v), each [..., N]. Differentiable. A CPU tensor
    takes the plain version; a CUDA tensor launches kernel G or raises."""
    return _LNProjection.apply('ln_qkv', float(eps), x, g, b, wq, wk, wv)


def ln_dense(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm then one bias-free projection (cross-attention q): x
    [..., K], w [N, K]; returns [..., N]. Differentiable. A CPU tensor takes
    the plain version; a CUDA tensor launches kernel I or raises."""
    return _LNProjection.apply('ln_dense', float(eps), x, g, b, w)


def ln_geglu(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm then the GEGLU front half, ``(xn @ w[:n].T + bias[:n]) *
    gelu(xn @ w[n:].T + bias[n:])`` with exact (erf) GELU: x [..., K], w
    [2n, K] with the value rows first, bias [2n]; returns [..., n].
    Differentiable. A CPU tensor takes the plain version; a CUDA tensor
    launches kernel H or raises."""
    return _LNProjection.apply('ln_geglu', float(eps), x, g, b, w, bias)


ln_qkv.launches = 0
ln_dense.launches = 0
ln_geglu.launches = 0
_LN_ROUTES = {'ln_qkv': (ln_qkv_plain, _ln_qkv_launch, ln_qkv),
              'ln_dense': (ln_dense_plain, _ln_dense_launch, ln_dense),
              'ln_geglu': (ln_geglu_plain, _ln_geglu_launch, ln_geglu)}
