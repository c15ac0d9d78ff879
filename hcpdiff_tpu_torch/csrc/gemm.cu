// Kernels B (geglu_dense) and C (fused_dense): a bf16 GEMM with an fp32
// epilogue, y = x @ w^T with x [M, K] and w [Nw, K] (nn.Linear layout).
//
// Replaces hcpdiff_tpu/ops/matmul.py:_geglu_kernel (:301, via geglu_dense
// :387) and _dense_kernel_kres / _dense_kernel_kstream (:66 / :87, via
// fused_dense :272).
//
// What bounds it on the H100: at the UNet's feed-forward shapes
// (M = 2b*S up to 32768, K in 320..5120, N in 320..5120) the GEMMs are far
// above the 295 FLOP/byte ridge, so the tensor cores bound them; the
// epilogue work (bias, residual, GELU gate) is memory traffic that a
// separate elementwise pass would add on top. The design keeps that work
// in registers: GEGLU computes the value and the gate tile of the same
// output columns in one block with two accumulators, so the [M, 2n]
// intermediate never reaches device memory, and ff.out adds bias and
// residual before its single store. The TPU kernel's K-resident /
// K-streamed split was a VMEM-size artefact: here every K runs through the
// same K loop over 32-wide slices, double-buffered with cp.async.
//
// Simple first version: mma.sync m16n8k16 (not wgmma/TMA), 128x128 block
// tile, 8 warps of 32x64, two shared-memory stages.
#include "common.cuh"

namespace hcp {
namespace {

constexpr int BM = 128;          // rows of x per block
constexpr int BNS = 128;         // rows of w per block (shared B tile)
constexpr int BK = 32;           // K slice per stage
constexpr int LDS = BK + 8;      // padded row: conflict-free fragment reads
constexpr int THREADS = 256;

enum Mode { DENSE = 0, DENSE_RES = 1, GEGLU = 2 };

// Shared-tile row of this warp's n-tile `ni` (8 columns each, 8 per warp).
// DENSE: the block owns 128 output columns, the warp 64 of them.
// GEGLU: the block owns 64 output columns; shared rows [0, 64) hold their
// value weights and rows [64, 128) their gate weights, so a warp's n-tiles
// 0..3 are 32 value columns and 4..7 the gate columns that pair with them.
template <int MODE>
__device__ __forceinline__ int b_row(int wn, int ni) {
    if (MODE == GEGLU) return ni < 4 ? wn * 32 + ni * 8 : 64 + wn * 32 + (ni - 4) * 8;
    return wn * 64 + ni * 8;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
            const bf16* __restrict__ bias, const bf16* __restrict__ res,
            bf16* __restrict__ out, int M, int N, int K) {
    // N is the number of output columns (for GEGLU, w has 2N rows).
    __shared__ __align__(16) bf16 sA[2][BM * LDS];
    __shared__ __align__(16) bf16 sB[2][BNS * LDS];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * (MODE == GEGLU ? 64 : 128);

    auto load_stage = [&](int stage, int k0) {
        for (int c = tid; c < BM * (BK / 8); c += THREADS) {
            int r = c >> 2, kc = (c & 3) * 8;
            int gm = m0 + r, gk = k0 + kc;
            bool ok = gm < M && gk < K;
            cp_async16(&sA[stage][r * LDS + kc], ok ? x + (size_t)gm * K + gk : x, ok);
        }
        for (int c = tid; c < BNS * (BK / 8); c += THREADS) {
            int r = c >> 2, kc = (c & 3) * 8;
            int gn;
            bool ok;
            if (MODE == GEGLU) {
                int col = n0 + (r & 63);
                ok = col < N;
                gn = r < 64 ? col : N + col;
            } else {
                gn = n0 + r;
                ok = gn < N;
            }
            int gk = k0 + kc;
            ok = ok && gk < K;
            cp_async16(&sB[stage][r * LDS + kc], ok ? w + (size_t)gn * K + gk : w, ok);
        }
    };

    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    const int nk = (K + BK - 1) / BK;
    load_stage(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * BK);
        cp_async_commit();
        cp_async_wait<1>();      // stage kt has landed
        __syncthreads();
        const bf16* a_s = sA[kt & 1];
        const bf16* b_s = sB[kt & 1];
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t af[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) load_a(af[mi], a_s, LDS, wm * 32 + mi * 16, kk, g, t);
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
                uint32_t bfr[2];
                load_b(bfr, b_s, LDS, b_row<MODE>(wn, ni), kk, g, t);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) mma_16816(acc[mi][ni], af[mi], bfr);
            }
        }
        __syncthreads();         // all reads of this stage done before it is refilled
    }

    // Epilogue: fp32 bias (+ residual | GELU gate), one bf16 store.
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int row = m0 + wm * 32 + mi * 16 + g + h * 8;
            if (row >= M) continue;
            if (MODE == GEGLU) {
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) {
                    int col = n0 + wn * 32 + ni * 8 + 2 * t;
                    if (col >= N) continue;
                    float y[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        float v = acc[mi][ni][2 * h + e];
                        float gt = acc[mi][ni + 4][2 * h + e];
                        if (bias) {
                            v += __bfloat162float(bias[col + e]);
                            gt += __bfloat162float(bias[N + col + e]);
                        }
                        y[e] = v * (0.5f * gt * (1.f + erff(gt * 0.70710678118654752f)));
                    }
                    store_bf16x2(out + (size_t)row * N + col, y[0], y[1]);
                }
            } else {
#pragma unroll
                for (int ni = 0; ni < 8; ++ni) {
                    int col = n0 + wn * 64 + ni * 8 + 2 * t;
                    if (col >= N) continue;
                    float y0 = acc[mi][ni][2 * h], y1 = acc[mi][ni][2 * h + 1];
                    if (bias) {
                        y0 += __bfloat162float(bias[col]);
                        y1 += __bfloat162float(bias[col + 1]);
                    }
                    if (MODE == DENSE_RES) {
                        __nv_bfloat162 r2 =
                            *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)row * N + col);
                        y0 += __low2float(r2);
                        y1 += __high2float(r2);
                    }
                    store_bf16x2(out + (size_t)row * N + col, y0, y1);
                }
            }
        }
    }
}

}  // namespace
}  // namespace hcp

// x [M, K], w [N, K] (DENSE / DENSE_RES) or [2N, K] (GEGLU), bias [N] or
// [2N] or null, res [M, N] or null, out [M, N]; all bf16, row-major,
// 16-byte aligned; K % 8 == 0, N % 2 == 0. Returns cudaGetLastError().
extern "C" int hcp_gemm(int mode, const void* x, const void* w, const void* bias,
                        const void* res, void* out, int M, int N, int K, void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int bn = mode == GEGLU ? 64 : 128;
    dim3 grid((N + bn - 1) / bn, (M + BM - 1) / BM);
    const bf16* xp = static_cast<const bf16*>(x);
    const bf16* wp = static_cast<const bf16*>(w);
    const bf16* bp = static_cast<const bf16*>(bias);
    const bf16* rp = static_cast<const bf16*>(res);
    bf16* op = static_cast<bf16*>(out);
    switch (mode) {
        case DENSE: gemm_kernel<DENSE><<<grid, THREADS, 0, s>>>(xp, wp, bp, rp, op, M, N, K); break;
        case DENSE_RES: gemm_kernel<DENSE_RES><<<grid, THREADS, 0, s>>>(xp, wp, bp, rp, op, M, N, K); break;
        case GEGLU: gemm_kernel<GEGLU><<<grid, THREADS, 0, s>>>(xp, wp, bp, rp, op, M, N, K); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
