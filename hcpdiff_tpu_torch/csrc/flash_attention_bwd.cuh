// Kernels E and F: the attention backward, dQ (E) and dK/dV (F), from bf16
// q, k, v, dO [B, H, S, D] given by strides, the forward's fp32 row
// logsumexp lse [B, H, Sq] (natural log, kernel A writes it) and
// delta = rowsum(dO * O) [B, H, Sq] in fp32 (the wrapper computes it),
// with an optional causal mask (key <= query, top-left aligned; Sq == Sk).
//
// Replace, in hcpdiff_tpu/ops/flash_attention.py:
//   #5 _flash_bwd_dq_kernel_tq (:780) and _flash_bwd_dkv_kernel_tq (:834),
//      driven by _flash_backward_tq (:898): the UNet's D=40/80
//      self-attention gradient under the JAX defaults;
//   #6 _flash_bwd_dq_kernel (:683) and _flash_bwd_dkv_kernel (:733),
//      driven by _flash_backward (:980): the classic layout, for every head
//      dim under HCP_FLASH_NOMAX=0 and for head dims outside the transposed
//      set, with the causal option (:707-710, :755-758).
// The layouts differ only in how the TPU pads lanes; here both read
// [B, H, S, D] through strides, so one pair of kernels serves both.
//
// What bounds them on the H100: the [Sq, Sk] probabilities would be 64 MB
// per head in fp32 at S=4096, so the plain backward is bound by device
// memory traffic; recomputed on chip, each kernel does 3 (E) or 4 (F)
// S*S*D products per head (causal: S(S+1)/2*D, the unmasked pairs only)
// over O(S*D) bytes, far above the ridge, so the tensor cores and the exp
// bound them. Both recompute P = exp(S*scale - lse) in fp32 registers from
// a Q K^T tile, as the TPU kernels do.
//
// Design, as the JAX package splits it: two kernels and no atomics, so the
// gradients are deterministic. E grids over (query block, B*H) and loops
// over key tiles: dP = dO V^T, dS = P * (dP - delta) * scale, dQ += dS K.
// F grids over (key block, B*H, output-dim chunk) and loops over query
// tiles, computing the transposed tiles S^T = K Q^T and dP^T = V dO^T so
// that each warp owns 16 keys: dV += P^T dO and dK += dS^T Q accumulate in
// fp32 registers. P and dS feed the second product straight from the
// accumulator fragments (rounded to bf16), as P does in kernel A. The
// operands of the second products are needed [d][k]-major (K for E, Q and
// dO for F): the loading threads store them transposed into shared memory,
// as A does for V.
//
// Causal: E's key loop stops at the diagonal tile and F's query loop
// starts there, so about half the tiles are skipped; inside the diagonal
// tile P (and so dS) is 0 above the diagonal. The flag is a template
// parameter, so the non-causal kernels carry no mask state.
//
// The TPU forward's no-max clamp has no counterpart: A's running max is
// exact, so P needs no clamp and dS no mask beyond the causal one.
//
// Head dims: D is zero-padded to DP = 48, 64, 80, 128, 160 or 512 inside
// the shared tiles; pad columns are never stored. E holds a 16 x DP fp32
// accumulator per warp (DP/2 registers a thread). F holds two (dK and dV),
// which at DP=128 or 160 would pass 255 registers with the S and dP
// fragments, so F's output dims are split into chunks of DVC <= 80 over
// grid.z; each chunk recomputes S and dP over the whole DP. E at DP=160
// takes ~109 KB of shared memory (dynamic, set by cudaFuncSetAttribute).
//
// DP=512 (causal attention or training at the VAE's head dim, and any D in
// (160, 512], which the wrapper zero-pads to 512): whole-row tiles of Q,
// dO, K and V would be 4 x 64 x 520 x 2 = 266 KB, past the 227 KB a block
// may use. So E and F have a D-chunked variant: S and dP accumulate over
// DC=128 columns at a time through four [64][DC + 8] shared slots
// (chunked_abt2), and the outputs are split over grid.z (E: DVC=128, F:
// DVC=64, so the accumulators stay in registers); each output chunk
// recomputes S and dP, and every tile is re-read per chunk. A simple, slow
// route for head dims no shipped model uses.
//
// Output type: dq, dk and dv are bf16, or fp32 for an fp32 call (whose q,
// k, v and dO the wrapper rounds to bf16); a run-time flag read only in the
// final store, after the loop.
//
// E lives in flash_attention_bwd_dq.cu and F in flash_attention_bwd_dkv.cu,
// so the two compile in parallel; this header holds what they share.
//
// Simple first version: mma.sync m16n8k16, 64 x 64 tiles, single-buffered
// cp.async, no wgmma/TMA.
#pragma once

#include <math.h>

#include "common.cuh"

namespace hcp {

constexpr int BQ = 64;           // query rows per tile
constexpr int BKV = 64;          // keys per tile
constexpr int THREADS = 128;     // 4 warps x 16 rows
constexpr int LDT = 64 + 8;      // padded row of a transposed [DP][64] tile
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == 64 && BKV == 64, "tile_abt, tile_xy and LDT assume 64 x 64 tiles");

// (batch, head, seq) strides of the tensors, passed by value
struct Strides15 { long long v[15]; };
struct Strides18 { long long v[18]; };

// Row-major [rows][DP] tile of rows r0.. of a [S, D] matrix (row stride
// `ss`), zero-filled past S and past D.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, long long ss, int r0,
                                          int S, int D, int rows, int tid) {
    constexpr int LD = DP + 8;
    for (int c = tid; c < rows * (DP / 8); c += THREADS) {
        int r = c / (DP / 8), d = (c % (DP / 8)) * 8;
        bool ok = r0 + r < S && d < D;
        cp_async16(s + r * LD + d, ok ? g + (r0 + r) * ss + d : g, ok);
    }
}

// Columns [d0, d0 + DC) of the same rows stored transposed, [DC][LDT]:
// element (r, d0 + dd) at dd * LDT + r.
template <int DC>
__device__ __forceinline__ void load_rows_t(bf16* s, const bf16* g, long long ss, int r0,
                                            int S, int D, int d0, int rows, int tid) {
    for (int c = tid; c < rows * (DC / 8); c += THREADS) {
        int r = c / (DC / 8), dd = (c % (DC / 8)) * 8, d = d0 + dd;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < S && d < D) raw = *reinterpret_cast<const uint4*>(g + (r0 + r) * ss + d);
        const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[(dd + i) * LDT + r] = e8[i];
    }
}

// acc[16 x 64] += A[16 rows at r0][DP] * B[64 rows][DP]^T, both row-major
// in shared memory with row length LD.
template <int DP>
__device__ __forceinline__ void tile_abt_acc(float (&acc)[8][4], const bf16* a, const bf16* b,
                                             int r0, int g, int t) {
    constexpr int LD = DP + 8;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
        uint32_t af[4];
        load_a(af, a, LD, r0, kk, g, t);
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
            uint32_t bfr[2];
            load_b(bfr, b, LD, ni * 8, kk, g, t);
            mma_16816(acc[ni], af, bfr);
        }
    }
}

// acc[16 x 64] = A[16 rows at r0][DP] * B[64 rows][DP]^T.
template <int DP>
__device__ __forceinline__ void tile_abt(float (&acc)[8][4], const bf16* a, const bf16* b,
                                         int r0, int g, int t) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
    tile_abt_acc<DP>(acc, a, b, r0, g, t);
}

// The DP=512 kernels' S and dP: x = A1 B1^T and y = A2 B2^T for this warp's
// 16 rows, where A1/A2 are 64 rows from ar0 (< aS) and B1/B2 64 rows from
// br0 (< bS) of [S, D] matrices (row strides a1s.., columns >= D read as
// 0), summed over DP columns DC at a time through the four [64][DC + 8]
// shared tiles at sm. Each chunk starts with a barrier, so every thread's
// reads of shared memory before the call are done when sm is rewritten.
template <int DP, int DC>
__device__ __forceinline__ void chunked_abt2(float (&x)[8][4], float (&y)[8][4], bf16* sm,
                                             const bf16* a1, long long a1s, const bf16* a2,
                                             long long a2s, int ar0, int aS, const bf16* b1,
                                             long long b1s, const bf16* b2, long long b2s,
                                             int br0, int bS, int D, int warp, int g, int t,
                                             int tid) {
    constexpr int TILE = 64 * (DC + 8);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[ni][e] = y[ni][e] = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < DP; c0 += DC) {
        __syncthreads();              // the previous chunk's tiles fully consumed
        load_rows<DC>(sm, a1 + c0, a1s, ar0, aS, D - c0, 64, tid);
        load_rows<DC>(sm + TILE, a2 + c0, a2s, ar0, aS, D - c0, 64, tid);
        load_rows<DC>(sm + 2 * TILE, b1 + c0, b1s, br0, bS, D - c0, 64, tid);
        load_rows<DC>(sm + 3 * TILE, b2 + c0, b2s, br0, bS, D - c0, 64, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        tile_abt_acc<DC>(x, sm, sm + 2 * TILE, warp * 16, g, t);
        tile_abt_acc<DC>(y, sm + TILE, sm + 3 * TILE, warp * 16, g, t);
    }
}

// out[16 x DC] += X[16 x 64] * Y[64 x DC], X given as accumulator fragments
// (fragments of n-tiles 2j, 2j+1 are the A fragment of k-block j) and Y
// stored transposed in shared memory, [DC][LDT].
template <int DC>
__device__ __forceinline__ void tile_xy(float (&out)[DC / 8][4], const float (&x)[8][4],
                                        const bf16* yt, int g, int t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        uint32_t xa[4];
        xa[0] = pack_bf16x2(x[2 * j][0], x[2 * j][1]);
        xa[1] = pack_bf16x2(x[2 * j][2], x[2 * j][3]);
        xa[2] = pack_bf16x2(x[2 * j + 1][0], x[2 * j + 1][1]);
        xa[3] = pack_bf16x2(x[2 * j + 1][2], x[2 * j + 1][3]);
#pragma unroll
        for (int nd = 0; nd < DC / 8; ++nd) {
            uint32_t yb[2];
            load_b(yb, yt, LDT, nd * 8, j * 16, g, t);
            mma_16816(out[nd], xa, yb);
        }
    }
}

// Store a warp's [16 x DC] fp32 accumulator as rows r0.. (< S) and columns
// d0.. (< D) of the matrix at element offset `base` of gdst (row stride
// `ss`): bf16, or fp32 when out_f32 != 0.
template <int DC>
__device__ __forceinline__ void store_rows(void* gdst, long long base, long long ss,
                                           const float (&acc)[DC / 8][4], int r0, int S, int D,
                                           int d0, int g, int t, int out_f32) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        int row = r0 + g + r * 8;
        if (row >= S) continue;
#pragma unroll
        for (int nd = 0; nd < DC / 8; ++nd) {
            int d = d0 + nd * 8 + 2 * t;
            if (d >= D) continue;
            const long long off = base + row * ss + d;
            if (out_f32)
                store2(static_cast<float*>(gdst) + off, acc[nd][2 * r], acc[nd][2 * r + 1]);
            else
                store2(static_cast<bf16*>(gdst) + off, acc[nd][2 * r], acc[nd][2 * r + 1]);
        }
    }
}

}  // namespace hcp
