// The block tile of the LayerNorm GEMM kernels G, H and I (gemm.cu).
//
// A block computes a 128 x 128 tile of A[M, K] x W[N, K]^T with 8 warps of
// 32 x 64 (mma.sync m16n8k16, fp32 accumulators), over K in 32-wide slices
// double-buffered in shared memory with cp.async. What the kernels differ
// in is where the A rows come from (plain rows, rows after a LayerNorm,
// shifted image rows) and the epilogue, so the main loop takes the A-stage
// loader and an A-stage prologue as callables.
#pragma once

#include "common.cuh"

namespace hcp {

constexpr int BM = 128;          // rows of A per block
constexpr int BNS = 128;         // rows of W per block (shared B tile)
constexpr int BK = 32;           // K slice per stage
constexpr int LDS = BK + 8;      // padded row: conflict-free fragment reads
constexpr int THREADS = 256;
// A stage = BM * BK / 8 chunks of 16 bytes. Thread `tid` always copies the
// chunks c = tid + i * THREADS (i < A_CHUNKS): row c / 4, columns
// (c % 4) * 8 .. + 8. A prologue relies on that mapping to touch only the
// chunks whose cp.async the same thread waited for.
constexpr int A_CHUNKS = BM * (BK / 8) / THREADS;

struct TileSmem {
    bf16 a[2][BM * LDS];
    bf16 b[2][BNS * LDS];
};

__device__ __forceinline__ int a_chunk_row(int i) { return (threadIdx.x + i * THREADS) >> 2; }
__device__ __forceinline__ int a_chunk_col(int i) { return ((threadIdx.x + i * THREADS) & 3) * 8; }

// Shared-tile row of this warp's n-tile `ni` (8 columns each, 8 per warp).
// Unpaired: the block owns 128 output columns, the warp 64 of them.
// PAIRED (GEGLU): the block owns 64 output columns; shared rows [0, 64)
// hold their value weights and rows [64, 128) their gate weights, so a
// warp's n-tiles 0..3 are 32 value columns and 4..7 the gate columns that
// pair with them.
template <bool PAIRED>
__device__ __forceinline__ int b_row(int wn, int ni) {
    if (PAIRED) return ni < 4 ? wn * 32 + ni * 8 : 64 + wn * 32 + (ni - 4) * 8;
    return wn * 64 + ni * 8;
}

// One B stage: W rows n0 .. n0 + 128 (PAIRED: value rows n0 .. n0 + 64 and
// gate rows N + n0 .. N + n0 + 64), columns k0 .. k0 + 32; rows past N and
// columns past K are zero-filled.
template <bool PAIRED>
__device__ __forceinline__ void load_b_stage(bf16* s, const bf16* w, int N, int K, int n0,
                                             int k0) {
    for (int c = threadIdx.x; c < BNS * (BK / 8); c += THREADS) {
        int r = c >> 2, kc = (c & 3) * 8;
        int gn;
        bool ok;
        if (PAIRED) {
            int col = n0 + (r & 63);
            ok = col < N;
            gn = r < 64 ? col : N + col;
        } else {
            gn = n0 + r;
            ok = gn < N;
        }
        int gk = k0 + kc;
        ok = ok && gk < K;
        cp_async16(&s[r * LDS + kc], ok ? w + (size_t)gn * K + gk : w, ok);
    }
}

// acc (this warp's 32 x 64 of the tile) = A x W^T over all of K.
// fill_a(stage, k0) issues this thread's cp.async copies of its A chunks;
// prep_a(stage, k0) runs once they have landed, before any thread reads
// the stage, and may rewrite this thread's own chunks in place.
template <bool PAIRED, class LoadA, class PrepA>
__device__ __forceinline__ void mainloop(float (&acc)[2][8][4], TileSmem& sm, const bf16* w,
                                         int N, int K, int n0, LoadA fill_a, PrepA prep_a) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    const int nk = (K + BK - 1) / BK;
    fill_a(sm.a[0], 0);
    load_b_stage<PAIRED>(sm.b[0], w, N, K, n0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) {
            fill_a(sm.a[(kt + 1) & 1], (kt + 1) * BK);
            load_b_stage<PAIRED>(sm.b[(kt + 1) & 1], w, N, K, n0, (kt + 1) * BK);
        }
        cp_async_commit();
        cp_async_wait<1>();      // stage kt has landed
        prep_a(sm.a[kt & 1], kt * BK);
        __syncthreads();
        const bf16* a_s = sm.a[kt & 1];
        const bf16* b_s = sm.b[kt & 1];
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t af[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) load_a(af[mi], a_s, LDS, wm * 32 + mi * 16, kk, g, t);
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
                uint32_t bfr[2];
                load_b(bfr, b_s, LDS, b_row<PAIRED>(wn, ni), kk, g, t);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) mma_16816(acc[mi][ni], af[mi], bfr);
            }
        }
        __syncthreads();         // all reads of this stage done before it is refilled
    }
}

}  // namespace hcp
