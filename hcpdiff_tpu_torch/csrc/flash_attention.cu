// Kernel A: attention forward, O = softmax(Q K^T * scale) V, on bf16
// [B, H, S, D] tensors given by strides, fp32 softmax state, with an
// optional causal mask (key <= query, top-left aligned; Sq == Sk) and an
// optional fp32 row logsumexp.
//
// Replaces, in hcpdiff_tpu/ops/flash_attention.py:
//   #1 _flash_kernel_tq (:379, via _flash_forward_tq :460; the UNet's
//      D=40/80 self-attention under the JAX defaults);
//   #2 _flash_kernel (:54, via _flash_forward :548; the classic layout
//      with K/V resident: every head dim under HCP_FLASH_NOMAX=0 or
//      HCP_FLASH_TQ=0, and head dims outside the transposed set, D=128);
//   #3 _flash_kernel_stream (:226, via _flash_forward_stream :325; the
//      VAE's D=512 mid-block attention);
//   with its lse output, #1's emit_lse variant (:453-457) and #4
//   _flash_kernel_lse (:613, via _flash_forward_lse :634).
// One kernel serves all four: the TPU's transposed layout only fixed lane
// padding, its K/V residency and streaming were VMEM budgeting, and here
// every block streams K/V tiles. The TPU kernels' causal option (:84-89,
// :122-127, loop bound :189-192) is the `causal` template flag.
//
// What bounds it on the H100: kept on chip, QK^T and PV are 4*S*S*D FLOPs
// (causal: the S(S+1)/2 unmasked pairs only) over 4*S*D*2 bytes, far above
// the ridge, so the tensor cores bound it, and at small D (40, 80) the
// softmax's exp2 (one MUFU op a logit, ~1/60 of the tensor rate per SM)
// competes with them. Only wgmma reaches the tensor cores' full rate.
//
// Design (FlashAttention-2's online softmax on Hopper's wgmma; plan per
// padded head dim in HCP_FLASH_PLANS below):
//   - A block is two consumer warpgroups of 64 query rows each; they
//     share every K/V tile, so a tile is fetched from L2 once per 128 rows.
//   - BKV = 64 keys a tile (32 at DP=512). At DP <= 80 that keeps a thread
//     at <= 128 registers, so two blocks share an SM (MINB = 2) and one
//     block's softmax overlaps the other's products: 0.38 against 0.47 ms
//     at [4,8,4096,40] and 0.039 against 0.047 at [4,8,1024,80] for BKV =
//     128 with one block an SM (device-only, tools/time_kernels.py, on an
//     H100 SXM at 700 W; PERF.md). At DP=128, BKV = 128 took
//     255 registers and spilled in the causal instance.
//   - Q is loaded once; K and V tiles of BKV keys stream through a ring of
//     STAGES slots filled by cp.async in the swizzled layout wgmma reads
//     (wgmma.cuh), zero-filled past Sk and past D. Tile j's slot is read
//     after cp.async.wait_group, fence.proxy.async and a barrier; the
//     barrier of step j also frees the slot of step j - 1 (each warpgroup
//     waited for its products of j - 1 before it), which the loads of tile
//     j + STAGES - 1 then refill while tiles j.. are computed.
//   - S = Q K^T: wgmma m64nBKVk16 with both operands in shared memory (Q
//     and the K tile [key][d] are both K-major), DP / 16 products.
//   - Online softmax in base 2 on the accumulators, whose layout is
//     mma.sync's C fragment repeated (row max and sum over the four
//     threads of a row with shfl_xor 1 and 2); the mask (ragged Sk, the
//     causal diagonal) runs only on tiles that need it.
//   - O += P V: wgmma m64nDVCk16 with A from registers (P rounded to bf16
//     and packed from the S accumulators, which are exactly the A
//     fragments) and B the V tile [key][d] read in place, MN-major, with
//     the instruction's transpose bit: no transposed copy of V.
//   - Swizzle: 128-byte rows where DP divides by 64 (64, 128, 512), 64-byte
//     rows at 160 and 32-byte rows at 48 and 80, so no head dim is padded
//     past its multiple of 16 (no QK^T products are wasted).
//   - DP=512: a 64 x 512 fp32 accumulator would be 256 registers a thread,
//     so the output dims are split into DVC=256 chunks over grid.z; each
//     chunk recomputes QK^T (1.5x the products), and BKV=32, two stages,
//     keep Q (128 KB), the ring and V's chunk inside 227 KB.
// Not yet: TMA loads, warp specialisation, overlapping one tile's softmax
// with the next tile's QK^T inside a warpgroup (each warpgroup waits for
// its products; the two warpgroups of a block meet at every tile's
// barrier, so only a second block on the SM fills the tensor cores during
// their softmax).
//
// Causal: a block stops at the tile holding its last query's key, and a
// warpgroup skips the tiles past its own last row. With Sq == Sk, key 0 is
// in every row, so m and lse stay finite.
//
// Training: with an lse buffer the kernel also writes each row's
// natural-log logsumexp of the scaled (and masked) logits (fp32 [B, H,
// Sq]), which the backward kernels (flash_attention_bwd_dq.cu,
// flash_attention_bwd_dkv.cu) use to recompute P. The running max is in
// log2 units, so lse = (m + log2 l) * ln 2; with D split over grid.z only
// the first chunk stores it. Inference passes no buffer.
//
// Output type: o is bf16, or fp32 for an fp32 call (whose q, k and v the
// wrapper rounds to bf16), a run-time flag read only in the final store.
//
// The running max is taken on the unscaled logits, so the scale must be
// >= 0: the wrapper negates k for a negative scale.
#include <math.h>

#include "wgmma.cuh"

namespace hcp {
namespace {

// Launch plan per padded head dim DP (every plan: two warpgroups of 64
// query rows): keys per tile BKV, ring stages, output dims per block DVC (DP / DVC
// blocks over grid.z), swizzle width SW in bytes, and the blocks an SM
// should hold (MINB: 2 caps registers at 128 a thread, so two blocks'
// softmax and products interleave). Read and checked on the CPU by
// tests/test_torch_port_flash_plan.py.
//   X(DP, BKV, STAGES, DVC, SW, MINB)
#define HCP_FLASH_PLANS(X)        \
    X(48, 64, 4, 48, 32, 2)       \
    X(64, 64, 4, 64, 128, 2)      \
    X(80, 64, 4, 80, 32, 2)       \
    X(128, 64, 4, 128, 128, 1)    \
    X(160, 64, 3, 160, 64, 1)     \
    X(512, 32, 2, 256, 128, 1)

constexpr int MAX_SMEM = 232448;     // 227 KB: the most a block may use
constexpr int SM_SMEM = 233472;      // 228 KB an SM, of which each block takes 1 KB more

template <int DP_, int BKV_, int STAGES_, int DVC_, int SW_, int MINB_>
struct Plan {
    static constexpr int DP = DP_, BKV = BKV_, STAGES = STAGES_, DVC = DVC_, SW = SW_,
                         MINB = MINB_;
    static constexpr int BQ = 128, THREADS = 256;    // two warpgroups of 64 rows
    static constexpr int W = SW / 2;                 // bf16 columns in a row of one block
    static constexpr int Q_BYTES = BQ * DP * 2;
    static constexpr int K_BYTES = BKV * DP * 2;
    static constexpr int STAGE_BYTES = K_BYTES + BKV * DVC * 2;
    // + 1024 to align the tiles to the swizzle's period
    static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024;
    static_assert(DP % W == 0 && DVC % W == 0 && DP % DVC == 0, "blocks must tile DP and DVC");
    static_assert(BKV % 16 == 0 && BKV <= 256 && DVC % 8 == 0 && DVC <= 256, "wgmma N");
    static_assert(STAGES >= 2 && SMEM <= MAX_SMEM && MINB * (SMEM + 1024) <= SM_SMEM,
                  "shared memory");
};

template <class P, bool CAUSAL>
__global__ void __launch_bounds__(P::THREADS, P::MINB)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, void* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk, int D, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
                 long long vss, long long osb, long long osh, long long oss, float scale_log2,
                 int out_f32) {
    constexpr int BKV = P::BKV, DVC = P::DVC, SW = P::SW, STAGES = P::STAGES;
    constexpr int KB = P::W / 16;                  // k16 slices in a row of one block
    extern __shared__ unsigned char smem_raw[];
    const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const uint32_t sKV = sQ + P::Q_BYTES;

    const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * P::BQ, dc0 = blockIdx.z * DVC;
    const int row0 = q0 + wg * 64;                 // this warpgroup's first query
    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* kb = k + b * ksb + h * ksh;
    const bf16* vb = v + b * vsb + h * vsh;

    int nkt = (Sk + BKV - 1) / BKV;
    if (CAUSAL) nkt = min(nkt, (q0 + P::BQ - 1) / BKV + 1);   // stop at the diagonal

    auto load_kv = [&](int tile) {
        const uint32_t s = sKV + (tile % STAGES) * P::STAGE_BYTES;
        load_swizzled<SW, P::THREADS, BKV, P::DP>(s, kb, kss, tile * BKV, Sk, 0, D, tid);
        load_swizzled<SW, P::THREADS, BKV, DVC>(s + P::K_BYTES, vb, vss, tile * BKV, Sk, dc0, D,
                                                tid);
    };
    // Q with tile 0's group
    load_swizzled<SW, P::THREADS, P::BQ, P::DP>(sQ, qb, qss, q0, Sq, 0, D, tid);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nkt) load_kv(s);
        cp_async_commit();
    }

    // Q's K-major descriptor (this warpgroup's 64 rows: 64 * SW bytes into
    // each block); K's (N = BKV keys); V's (MN-major, the transpose bit)
    const uint64_t dq = smem_desc<SW>(sQ + wg * 64 * SW, 16, 8 * SW);
    float m_i[2] = {-1e30f, -1e30f};   // running max (log2 units) of rows g, g + 8
    float l_i[2] = {0.f, 0.f};         // this thread's share of the running sums
    float acc[DVC / 2];
#pragma unroll
    for (int i = 0; i < DVC / 2; ++i) acc[i] = 0.f;
    int last_key[2];                   // the last key rows g, g + 8 may see
#pragma unroll
    for (int r = 0; r < 2; ++r)
        last_key[r] = CAUSAL ? min(Sk - 1, row0 + warp * 16 + g + r * 8) : Sk - 1;

    for (int j = 0; j < nkt; ++j) {
        cp_async_wait<STAGES - 2>();   // this thread's copies of tile j have landed
        fence_proxy_async();
        __syncthreads();               // everyone's have; every product of tile j - 1 is done
        if (j + STAGES - 1 < nkt) load_kv(j + STAGES - 1);
        cp_async_commit();
        const int k0 = j * BKV;
        if (CAUSAL && k0 > row0 + 63) continue;   // no key of this tile is visible here

        const uint32_t sK = sKV + (j % STAGES) * P::STAGE_BYTES;
        const uint64_t dk = smem_desc<SW>(sK, 16, 8 * SW);
        const uint64_t dv = smem_desc<SW>(sK + P::K_BYTES, BKV * SW, 8 * SW);

        // S = Q K^T for this warpgroup's 64 rows x BKV keys
        float s[BKV / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < P::DP / 16; ++kk)   // slice kk: block kk / KB, 32 B per slice in it
            Wgmma<BKV>::mma(s, dq + (kk / KB) * (P::BQ * SW / 16) + (kk % KB) * 2,
                            dk + (kk / KB) * (BKV * SW / 16) + (kk % KB) * 2, kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(s);

        // Online softmax in base 2 on the unscaled logits (scale >= 0):
        // elements i with (i / 2) % 2 == 0 are row g, the others row g + 8;
        // the four threads t = 0..3 of a group share each row.
        const bool masked = k0 + BKV > Sk || (CAUSAL && k0 + BKV - 1 > row0);
        float mx[2] = {-INFINITY, -INFINITY};
        if (masked) {
#pragma unroll
            for (int i = 0; i < BKV / 2; ++i) {
                const int key = k0 + (i / 4) * 8 + 2 * t + (i & 1);
                if (key > last_key[(i >> 1) & 1]) s[i] = -INFINITY;
            }
        }
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float alpha[2], neg_m[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_i[r], mx[r] * scale_log2);
            alpha[r] = fast_exp2(m_i[r] - m_new);
            m_i[r] = m_new;
            neg_m[r] = -m_new;
            l_i[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
            const int r = (i >> 1) & 1;
            float p = fast_exp2(fmaf(s[i], scale_log2, neg_m[r]));
            if (masked && s[i] == -INFINITY) p = 0.f;   // exact for scale 0 too
            s[i] = p;
            l_i[r] += p;
        }
#pragma unroll
        for (int i = 0; i < DVC / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

        // O += P V: the S accumulators of column tiles 2jj, 2jj + 1 are the
        // A fragment of keys [16jj, 16jj + 16)
        uint32_t pa[BKV / 16][4];
        pack_a<BKV>(pa, s);
        // the rescaled O and the packed P are written before the fence
        fence_operands(acc);
#pragma unroll
        for (int jj = 0; jj < BKV / 16; ++jj) fence_operands(pa[jj]);
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < BKV / 16; ++jj)   // keys 16jj..: 16 rows of SW bytes further
            WgmmaRS<DVC>::mma(acc, pa[jj], dv + jj * SW);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
#pragma unroll
        for (int jj = 0; jj < BKV / 16; ++jj) fence_operands(pa[jj]);
    }
    cp_async_wait<0>();

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_i[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.f / l;
        const int row = row0 + warp * 16 + g + r * 8;
        if (lse != nullptr && blockIdx.z == 0 && t == 0 && row < Sq)
            lse[static_cast<long long>(blockIdx.y) * Sq + row] =
                (m_i[r] + log2f(l)) * 0.6931471805599453f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + warp * 16 + g + r * 8;
        if (row >= Sq) continue;
#pragma unroll
        for (int nd = 0; nd < DVC / 8; ++nd) {
            const int d = dc0 + nd * 8 + 2 * t;
            if (d >= D) continue;
            const long long off = b * osb + h * osh + row * oss + d;
            const float y0 = acc[nd * 4 + 2 * r] * inv[r], y1 = acc[nd * 4 + 2 * r + 1] * inv[r];
            if (out_f32)
                store2(static_cast<float*>(o) + off, y0, y1);
            else
                store2(static_cast<bf16*>(o) + off, y0, y1);
        }
    }
}

template <class P>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int Sq, int Sk, int D, const long long* st, float scale_log2, int causal, int out_f32,
           cudaStream_t s) {
    auto kern = causal ? flash_fwd_kernel<P, true> : flash_fwd_kernel<P, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((Sq + P::BQ - 1) / P::BQ, B * H, P::DP / P::DVC);
    kern<<<grid, P::THREADS, P::SMEM, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        o, lse, H, Sq, Sk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11], scale_log2, out_f32);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hcp

// q [B,H,Sq,D], k/v [B,H,Sk,D]: bf16; o [B,H,Sq,D]: bf16, or fp32 when
// out_f32 != 0; all with unit stride on D; `strides` holds (batch, head,
// seq) strides in elements for q, k, v, o (12 values). D % 8 == 0, D <=
// 512, and 16-byte aligned rows. `lse` is null, or a contiguous fp32
// [B, H, Sq] buffer for the row logsumexp. `causal` != 0 masks keys past
// each query (top-left aligned; the caller ensures Sq == Sk). scale >= 0.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a D whose
// multiple of 16 has no plan.
extern "C" int hcp_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse_out, int B, int H, int Sq, int Sk, int D,
                                   const long long* strides, float scale, int causal,
                                   int out_f32, void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float sl2 = scale * 1.4426950408889634f;
    float* lse = static_cast<float*>(lse_out);
#define HCP_FWD_CASE(DP, BKV, STAGES, DVC, SW, MINB)                                  \
    case DP:                                                                          \
        return launch<Plan<DP, BKV, STAGES, DVC, SW, MINB>>(                          \
            q, k, v, o, lse, B, H, Sq, Sk, D, strides, sl2, causal, out_f32, s);
    switch ((D + 15) / 16 * 16) {
        HCP_FLASH_PLANS(HCP_FWD_CASE)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef HCP_FWD_CASE
}
