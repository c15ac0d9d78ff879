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
// memory traffic; recomputed on chip, E does 3 and F 4 S*S*D products per
// head (causal: the S(S+1)/2 unmasked pairs only) over O(S*D) bytes, far
// above the ridge, so the tensor cores bound them, and at small D (40, 80)
// the exp2 and the fp32 arithmetic of P and dS (one MUFU op and ~4 FP32 ops
// a pair) compete with them. Only wgmma reaches the tensor cores' full rate.
//
// Design: kernel A's loop (flash_attention.cu) with more products; two
// kernels and no atomics, as the JAX package splits them, so the gradients
// are deterministic. A block is two consumer warpgroups of 64 rows that
// share every streamed tile, so a tile is fetched from L2 once per 128 rows.
//   E: grid (ceil(Sq / 128), B*H). Q and dO stay resident; K and V tiles of
//      BKV keys stream through a ring of STAGES cp.async slots. Per tile and
//      warpgroup: S = Q K^T and dP = dO V^T by wgmma from shared memory,
//      committed as two groups, so that P = exp2(S * scale * log2 e - lse *
//      log2 e) is computed on S's accumulators while dP is; then
//      dS = P * (dP - delta) in fp32; dQ += dS K by wgmma with dS from
//      registers and the same K slot read MN-major with the transpose bit.
//   F: grid (ceil(Sk / 128), B*H[, DP / DVC]), the mirror. K and V stay
//      resident; Q and dO tiles of BQ queries stream through the ring with
//      that tile's lse and delta (BQ floats each); S^T = K Q^T and
//      dP^T = V dO^T by wgmma from shared memory (two groups, as in E),
//      then dV += P^T dO and dK += dS^T Q with P^T and dS^T from registers
//      and the dO and Q slots read MN-major. Each Q and dO slot is read
//      both ways from one copy. F splits its output dims over grid.z only
//      where a plan's DVC < DP (none does now).
// The ring is A's: tile j's slot is read after cp.async.wait_group,
// fence.proxy.async and a barrier, which also frees the slot of tile j - 1
// (each warpgroup waited for its products of j - 1 before it); the loads of
// tile j + STAGES - 1 then refill it while tiles j.. are computed. Tiles
// are stored in wgmma's swizzled layouts (wgmma.cuh): 128-, 64- or 32-byte
// rows by DP, so no head dim pads past its multiple of 16. The scale
// multiplies dQ and dK once, in the final store, not every dS. Launch plans
// per padded head dim are the tables HCP_FLASH_DQ_PLANS
// (flash_attention_bwd_dq.cu) and HCP_FLASH_DKV_PLANS
// (flash_attention_bwd_dkv.cu), which tests/test_torch_port_flash_plan.py
// reads and checks on the CPU. Registers decide F's query tile: dK and dV
// take DVC fp32 a thread and S^T and dP^T BQ, so whole rows of outputs
// (no grid.z split) need BQ = 48 at DP=128 and 32 at 160.
//
// Masks: P is set to 0 only on tiles that need it (the ragged last tile of
// the streamed side and the causal diagonal). Causal: E's key loop stops at
// the tile that holds its last query's key, F's query loop starts at the
// tile that holds its first key, and a warpgroup skips the tiles wholly
// masked for its own 64 rows. Rows and columns past S or D are zero-filled
// in shared memory and never stored.
//
// The TPU forward's no-max clamp has no counterpart: A's running max is
// exact, so P needs no clamp and dS no mask beyond the causal one.
//
// Head dims: the kernels are built for padded DP = 48, 64, 80, 128, 160
// and 512. At 512 (the VAE's head dim; any D in (160, 512] is zero-padded
// to it) the whole-row tiles do not fit a block, so E and F run the
// D-chunked mma.sync variants of flash_attention_bwd_chunked.cu.
//
// Output type: dq, dk and dv are bf16, or fp32 for an fp32 call (whose q,
// k, v and dO the wrapper rounds to bf16); a run-time flag read only in the
// final store.
//
// Not yet: TMA loads, warp specialisation (a producer warp and mbarriers in
// place of the barrier per tile), overlapping one tile's exp with the next
// tile's products inside a warpgroup, and a Hopper design of the DP=512
// variants.
#pragma once

#include <math.h>

#include "wgmma.cuh"

namespace hcp {

constexpr float LOG2E = 1.4426950408889634f;

// (batch, head, seq) strides of the tensors, passed by value
struct Strides15 { long long v[15]; };
struct Strides18 { long long v[18]; };

// A launch plan of E (DKV false) or F (DKV true): padded head dim DP,
// rows BN of a streamed tile (E: keys, F: queries), ring stages, output
// dims per block DVC (DP / DVC blocks over grid.z), swizzle width SW in
// bytes, blocks an SM MINB (2 caps registers at 128 a thread).
template <int DP_, int BN_, int STAGES_, int DVC_, int SW_, int MINB_, bool DKV>
struct BwdPlan {
    static constexpr int DP = DP_, BN = BN_, STAGES = STAGES_, DVC = DVC_, SW = SW_,
                         MINB = MINB_;
    static constexpr int BM = 128, THREADS = 256;    // resident rows: two warpgroups of 64
    static constexpr int W = SW / 2;                 // bf16 columns in a row of one block
    static constexpr int RES_BYTES = BM * DP * 2;    // one resident tile (E: Q, dO; F: K, V)
    static constexpr int TILE_BYTES = BN * DP * 2;   // one streamed tile (E: K, V; F: Q, dO)
    static constexpr int STAT_BYTES = DKV ? 2 * BN * 4 : 0;   // F: the tile's lse and delta
    // + 1024 to align the tiles to the swizzle's period
    static constexpr int SMEM = 2 * RES_BYTES + STAGES * (2 * TILE_BYTES + STAT_BYTES) + 1024;
    static_assert(DP % W == 0 && DVC % W == 0 && DP % DVC == 0, "blocks must tile DP and DVC");
    static_assert(DKV || DVC == DP, "E writes whole rows of dQ");
    static_assert((BN == 32 || BN == 48 || BN == 64 || BN == 128) && DVC % 16 == 0 &&
                  DVC <= 256, "wgmma N");
    static_assert(STAGES >= 2 && SMEM <= 232448 && MINB * (SMEM + 1024) <= 233472,
                  "shared memory");
};

// Store a warpgroup's [64 x DVC] fp32 accumulator, times `mul`, as rows
// r0.. (< S) and columns d0.. (< D) of the matrix at element offset `base`
// of dst (row stride ss): bf16, or fp32 when out_f32 != 0. Thread (warp w,
// g, t) holds rows r0 + 16w + g (+ 8) and columns 8n + 2t (+ 1).
template <int DVC>
__device__ __forceinline__ void store_acc(void* dst, long long base, long long ss,
                                          const float (&acc)[DVC / 2], float mul, int r0, int S,
                                          int d0, int D, int warp, int g, int t, int out_f32) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + warp * 16 + g + r * 8;
        if (row >= S) continue;
#pragma unroll
        for (int nd = 0; nd < DVC / 8; ++nd) {
            const int d = d0 + nd * 8 + 2 * t;
            if (d >= D) continue;
            const long long off = base + row * ss + d;
            const float y0 = acc[nd * 4 + 2 * r] * mul, y1 = acc[nd * 4 + 2 * r + 1] * mul;
            if (out_f32)
                store2(static_cast<float*>(dst) + off, y0, y1);
            else
                store2(static_cast<bf16*>(dst) + off, y0, y1);
        }
    }
}

// The D-chunked DP=512 variants (flash_attention_bwd_chunked.cu).
int flash_bwd_dq_512(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int B, int H, int Sq, int Sk,
                     int D, const long long* strides, float scale, int causal, int out_f32,
                     cudaStream_t s);
int flash_bwd_dkv_512(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                      int Sq, int Sk, int D, const long long* strides, float scale, int causal,
                      int out_f32, cudaStream_t s);

}  // namespace hcp
