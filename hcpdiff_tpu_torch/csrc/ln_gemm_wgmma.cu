// Kernels G (ln_qkv), H (ln_geglu) and I (ln_dense): bf16 GEMMs with a
// LayerNorm prologue, y = LayerNorm(x) @ w^T with x [M, K] and w [N, K]
// (nn.Linear layout), fp32 accumulation:
//   G  ln_qkv    LayerNorm(x) Wq^T, LayerNorm(x) Wk^T, LayerNorm(x) Wv^T
//   H  ln_geglu  (xn Wv^T + bv) * gelu_erf(xn Wg^T + bg), w = [Wv; Wg] [2N, K]
//   I  ln_dense  LayerNorm(x) W^T
// (B and C, the same GEMMs without the LayerNorm, are gemm_wgmma.cu.)
//
// Replaces hcpdiff_tpu/ops/matmul.py:_ln_qkv_kernel (:412, pallas_call
// :438), _ln_geglu_kernel (:497, :533) and _ln_dense_kernel (:600, :632).
//
// What bounds it on the H100: at the fused UNet's shapes (M = 2b * S up to
// 32768, K = C in 320..1280, N = C, 3C or 4C) H is far above the 295
// FLOP/byte ridge (the tensor cores bound it); G and I at K = 320 are bound
// by their bytes (G writes three [M, 320] outputs from one [M, 320] input),
// above it by their operations. The LayerNorm is work that every column of
// the output shares, so it must be done once a row, not once per product.
//
// Design:
//   - A block owns R rows of x (R = 128: two warpgroups of 64 rows; R =
//     64: both warpgroups on the same rows, splitting the tile's weight
//     rows) and walks a run of column tiles (the host plan's group,
//     ops/matmul.py:ln_gemm_plan). It brings its rows into shared memory
//     once (16-byte cp.async), computes each row's mean and 1/sqrt(var +
//     eps) there in fp32 with the two-pass variance of _ln_rows
//     (matmul.py:404-409: the mean, then the mean of squared deviations;
//     8 lanes a row), and rewrites the rows in place as bf16((x - mean) *
//     rstd * g + b), the rounding the TPU kernels apply before their
//     product, in the 128-byte-swizzled K-major layout wgmma's descriptors
//     read (wgmma.cuh); columns past K are zero. fence.proxy.async hands
//     them to the tensor cores. The normalized rows stay resident while the
//     block walks its column tiles, so x is read once for all of them: for
//     G the walk runs over the q, k and v tiles of the rows (x read once
//     for three outputs, as the TPU kernel does).
//   - Only the weight tiles stream, through a ring of STAGES shared-memory
//     stages filled by cp.async, continuing across column tiles (the next
//     tile's first stages load while this tile's last products run), with
//     gemm_wgmma.cu's barrier discipline: a landed stage passes
//     cp.async.wait_group, fence.proxy.async and a barrier; the step issues
//     its products, then the refill of the slot the step before read (two
//     stages ahead, in three slots: the widest rows leave room for no
//     more), then waits for its products. The ring's first stages are in
//     flight while the prologue computes the statistics. Each row tile
//     starts its walk at another column tile, so the blocks on the card do
//     not all read the same weight tile from L2 at once.
//   - Products: wgmma m64nNk16 from shared memory. R = 128: each
//     warpgroup multiplies its 64 rows by the whole stage (H: the value
//     and the gate rows in one m64n128 product, whose columns 64.. are the
//     gates of columns 0..; an m64n64 product would read as many
//     shared-memory bytes as the SM moves in its time). R = 64: warpgroup
//     w takes weight rows [w * NW, (w + 1) * NW) of the stage: for G and I
//     half the tile's columns, for H the value (w = 0) or the gate (w = 1)
//     rows, whose gelu_erf the gate warpgroup hands to the value
//     warpgroup through shared memory in fp32.
//   - Epilogue: H's bias and exact-erf GELU gate in fp32 registers; the
//     tile then goes through a staging buffer of its own (the ring is busy
//     with the next tile's stages, the rows with the next tile's products)
//     in the output type, and is stored along rows, 16 bytes a thread and
//     a warp over whole rows. The stores are not waited on: they drain
//     while the next tile's products run. fp32 outputs take two passes of
//     half the columns through the same buffer.
//   - The tiles (R, BN, stages, blocks an SM) are the HCP_LN_GEMM_TILES
//     table, which the plan mirrors (LN_GEMM_TILES) and a CPU test checks
//     against this source. The resident rows take R * ceil(K / 64) * 128
//     bytes, so a tile serves K up to what its budget leaves (MAX_KPAD).
//     The plan splits each row tile's column tiles into `groups` runs, one
//     block a run, so that the grid fills the card; a row's statistics are
//     computed once per group. No split-K and no atomics: the output is
//     deterministic.
// Not yet: TMA loads and multicast of the weight tile over a cluster (at
// R = 64 each row tile reads all the weights from L2); a producer warp
// with mbarriers, so that one warpgroup's epilogue runs beside the
// other's products. A second accumulator set, the epilogue cut into
// phases run between the next tile's steps, was slower (H spilled at 255
// registers).
//
// Types: x, the weights and the LayerNorm scale and shift are bf16. H's
// bias and the outputs are OutT: bf16, or fp32 for an fp32 call (whose x,
// weights, scale and shift the wrapper rounds to bf16), so its result is
// rounded once.
#include "wgmma.cuh"

namespace hcp {
namespace {

enum Mode { DENSE = 0, GEGLU = 2 };

constexpr int BK = 64;               // channels per K step: one 128-byte row
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;     // 227 KB: the most a block may use
constexpr int SM_SMEM = 233472;      // 228 KB an SM, of which each block takes 1 KB more

// X(GEGLU, R, BN, STAGES, MINB): the built tiles. R rows of x a block, BN
// output columns a column tile (H: BN value and BN gate rows of the weight
// a stage), STAGES ring slots, MINB blocks an SM (MINB = 2 would cap a
// thread at 128 registers and a block at half the SM's shared memory; R =
// 64 tiles at two blocks an SM, and five-stage rings, were no faster at
// any timed shape: PERF.md). A tile serves K up to its MAX_KPAD: R = 128
// to 448 (G, I: BN = 160 divides SD1.5's 320) and 640 (H), R = 64 to 1280.
#define HCP_LN_GEMM_TILES(X)       \
    X(false, 128, 160, 3, 1)       \
    X(false, 64, 128, 3, 1)        \
    X(true, 128, 64, 3, 1)         \
    X(true, 64, 64, 3, 1)

template <bool GEGLU_, int R_, int BN_, int STAGES_, int MINB_>
struct LnCfg {
    static constexpr bool IS_GEGLU = GEGLU_;
    static constexpr int R = R_, BN = BN_, STAGES = STAGES_, MINB = MINB_;
    // R = 64: both warpgroups multiply the same rows, each its own weight rows
    static constexpr bool SPLIT = R_ == 64;
    static constexpr int B_ROWS = GEGLU_ ? 2 * BN_ : BN_;    // weight rows a stage holds
    static constexpr int STAGE_BYTES = B_ROWS * BK * 2;
    // N of each warpgroup's wgmma: R = 128 multiplies the whole stage (H:
    // its value and gate rows in one product, so A is read once for both),
    // R = 64 half of it
    static constexpr int NW = SPLIT ? B_ROWS / 2 : B_ROWS;
    static constexpr int OW = GEGLU_ ? BN_ : NW;            // output columns a warpgroup holds
    // a step waits for its own products, so the refill takes the slot the
    // step before read and the ring loads STAGES - 1 stages ahead
    static constexpr int AHEAD = STAGES_ - 1;
    static constexpr int RING = STAGES_ * STAGE_BYTES;
    static constexpr int LDS = BN_ * 2 + 16;     // staged output row, bytes
    static constexpr int LDX = BN_ * 4 + 16;     // exchanged fp32 gate row (H at R = 64), bytes
    static constexpr int STAGING = GEGLU_ && SPLIT && R_ * LDX > R_ * LDS ? R_ * LDX : R_ * LDS;
    // everything but the resident rows, + 1024 bytes to align to the swizzle's period
    static constexpr int FIXED = RING + STAGING + 1024;
    static constexpr int BLOCK_CAP = MINB_ > 1 ? SM_SMEM / MINB_ - 1024 : MAX_SMEM;
    // the widest K (in whole 64-channel steps) whose rows fit beside the rest
    static constexpr int MAX_KPAD = (BLOCK_CAP - FIXED) / (2 * R_) / BK * BK;
    static_assert(R_ == 64 || R_ == 128, "a block holds one or two 64-row warpgroups");
    static_assert(B_ROWS % 32 == 0 && STAGES_ >= 3, "a thread copies rows r, r + 32, ..");
    static_assert(NW <= 256 && NW % 8 == 0, "wgmma takes N <= 256, a multiple of 8");
    static_assert(MAX_KPAD >= BK, "the rows of one K step do not fit");
    static_assert(STAGING >= 4 * MAX_KPAD, "the LayerNorm scale and shift pass through staging");
};

struct LnParams {
    const bf16* x;              // [M, K]
    const bf16* w0;             // [N, K] (G: wq, wk, wv) or [2N, K] (H)
    const bf16* w1;
    const bf16* w2;
    const void* bias;           // H: [2N] or null             (output type)
    void* out0;                 // [M, N] each                  (output type)
    void* out1;
    void* out2;
    const bf16* ln_g;           // LayerNorm scale and shift [K]
    const bf16* ln_b;
    float eps;
    int M, N, K;
    int nk;                     // K steps: ceil(K / 64)
    int ntn;                    // column tiles a weight: ceil(N / BN)
    int tiles;                  // column tiles of all weights: nw * ntn
    int groups;                 // runs of column tiles a row tile is split into
};

__device__ __forceinline__ float gelu_erf(float g) {
    return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float* f) {
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 t = __bfloat1622float2(e[j]);
        f[2 * j] = t.x;
        f[2 * j + 1] = t.y;
    }
}

// the sum over the 8 lanes of a row group (lanes 8i .. 8i + 7)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// The epilogue of one column tile (tile index c of the run's weights): acc
// holds this thread's sums of rows m0.. and the tile's columns.
template <class T, typename OutT>
__device__ __forceinline__ void epilogue(const LnParams& p, float (&acc)[T::NW / 2],
                                         unsigned char* stg, int m0, int c) {
    constexpr bool G = T::IS_GEGLU, SPLIT = T::SPLIT;
    constexpr int R = T::R, BN = T::BN, NW = T::NW, OW = T::OW;
    const int tid = threadIdx.x, wg = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int N = p.N, M = p.M;
    const int wi = c / p.ntn, n0 = (c - wi * p.ntn) * BN;
    // accumulator i: tile row trow + 8 * ((i / 2) % 2), column tcol + (i / 4) * 8 + 2q + i % 2
    // (H at R = 128: the gate of column j is column j + BN)
    const int trow = (SPLIT ? 0 : wg * 64) + warp * 16 + g;
    const int tcol = SPLIT && !G ? wg * NW : 0;
    const OutT* bias = static_cast<const OutT*>(p.bias);

    // H's bias of this thread's value (and gate) columns, pairs loaded at once
    float2 bv[G ? OW / 8 : 1], bg[G ? OW / 8 : 1];
    if constexpr (G) {
#pragma unroll
        for (int jn = 0; jn < OW / 8; ++jn) {
            const int col = n0 + jn * 8 + 2 * q;   // N is even, so col + 1 < N too
            const bool ok = bias && col < N;
            bv[jn] = ok && (!SPLIT || wg == 0) ? load2(bias + col) : make_float2(0.f, 0.f);
            bg[jn] = ok && (!SPLIT || wg == 1) ? load2(bias + N + col) : make_float2(0.f, 0.f);
        }
    }
    if constexpr (G && !SPLIT) {         // value and gate (acc[i + OW / 2]) in registers
#pragma unroll
        for (int jn = 0; jn < OW / 8; ++jn)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = jn * 4 + 2 * h;
                acc[i] = (acc[i] + bv[jn].x) * gelu_erf(acc[i + OW / 2] + bg[jn].x);
                acc[i + 1] = (acc[i + 1] + bv[jn].y) * gelu_erf(acc[i + 1 + OW / 2] + bg[jn].y);
            }
    }
    if constexpr (G && SPLIT) {          // the gate warpgroup hands gelu(g + bg) over in fp32
        if (wg == 1) {
#pragma unroll
            for (int jn = 0; jn < NW / 8; ++jn)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int i = jn * 4 + 2 * h;
                    *reinterpret_cast<float2*>(stg + (trow + 8 * h) * T::LDX +
                                               (jn * 8 + 2 * q) * 4) =
                        make_float2(gelu_erf(acc[i] + bg[jn].x),
                                    gelu_erf(acc[i + 1] + bg[jn].y));
                }
        }
        __syncthreads();
        if (wg == 0) {
#pragma unroll
            for (int jn = 0; jn < NW / 8; ++jn)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int i = jn * 4 + 2 * h;
                    const float2 gl = *reinterpret_cast<const float2*>(
                        stg + (trow + 8 * h) * T::LDX + (jn * 8 + 2 * q) * 4);
                    acc[i] = (acc[i] + bv[jn].x) * gl.x;
                    acc[i + 1] = (acc[i + 1] + bv[jn].y) * gl.y;
                }
        }
        __syncthreads();                 // every gate value is read before the buffer is reused
    }

    // The tile through the staging buffer, then along rows: PASSES passes of
    // BNP columns (fp32 outputs take two), 16 bytes a thread.
    OutT* out = static_cast<OutT*>(wi == 0 ? p.out0 : wi == 1 ? p.out1 : p.out2);
    constexpr int PASSES = sizeof(OutT) / 2, BNP = BN / PASSES;
    constexpr int EPC = 16 / sizeof(OutT);            // elements a 16-byte chunk
    constexpr int CPR = BNP / EPC;                    // chunks a staged row
    constexpr int CHUNKS = R * CPR / THREADS;
    static_assert(R * CPR % THREADS == 0 && BNP % 8 == 0, "chunks split evenly");
    const bool holder = !(G && SPLIT) || wg == 0;   // H at R = 64: the value warpgroup
    const bool vec = (N * (int)sizeof(OutT)) % 16 == 0;
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
        if (holder) {
#pragma unroll
            for (int jn = 0; jn < OW / 8; ++jn) {
                const int cc = tcol + jn * 8 - pass * BNP;   // the 8 columns' place in the pass
                if (cc < 0 || cc >= BNP) continue;
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    store2(reinterpret_cast<OutT*>(stg + (trow + 8 * h) * T::LDS) + cc + 2 * q,
                           acc[jn * 4 + 2 * h], acc[jn * 4 + 2 * h + 1]);
            }
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < CHUNKS; ++u) {
            const int ch = tid + u * THREADS, r = ch / CPR, cc = ch - r * CPR;
            const int row = m0 + r, col = n0 + pass * BNP + cc * EPC;
            if (row >= M || col >= N) continue;
            const uint4 v = *reinterpret_cast<const uint4*>(stg + r * T::LDS + cc * 16);
            OutT* dst = out + (size_t)row * N + col;
            if (vec && col + EPC <= N) {
                *reinterpret_cast<uint4*>(dst) = v;
            } else {                     // N * sizeof(OutT) % 16 != 0, or the row's last columns
                const OutT* e = reinterpret_cast<const OutT*>(&v);
#pragma unroll
                for (int k = 0; k < EPC; k += 2) {
                    if (col + k >= N) break;
                    store2(dst + k, as_float(e[k]), as_float(e[k + 1]));
                }
            }
        }
        if (pass + 1 < PASSES) __syncthreads();
    }
}

template <class T, typename OutT>
__global__ void __launch_bounds__(THREADS, T::MINB) ln_proj_kernel(LnParams p) {
    constexpr bool G = T::IS_GEGLU, SPLIT = T::SPLIT;
    constexpr int R = T::R, BN = T::BN, S = T::STAGES, NW = T::NW;
    constexpr int AHEAD = T::AHEAD;
    constexpr uint32_t A_BLOCK = R * 128;     // bytes of the rows' 64 channels of one K step
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t ring = base, rows_s = base + T::RING;
    unsigned char* rows_p = smem_raw + (rows_s - raw);
    unsigned char* stg = rows_p + p.nk * A_BLOCK;

    const int tid = threadIdx.x, wg = tid >> 7;
    const int M = p.M, N = p.N, K = p.K, nk = p.nk;
    const int m0 = blockIdx.y * R;
    const int c0 = (int)((long long)blockIdx.x * p.tiles / p.groups);
    const int run = (int)((long long)(blockIdx.x + 1) * p.tiles / p.groups) - c0;
    const int steps = run * nk;
    // The run's t-th column tile. Each row tile starts its walk at another
    // tile, so that the blocks on the card read different weight tiles at
    // once rather than all the same few L2 lines.
    const int rot = blockIdx.y % run;
    auto tile_of = [&](int t) { return c0 + (t + rot >= run ? t + rot - run : t + rot); };

    // The block's rows of x, once: chunk cc (channels 8cc..) of row r goes
    // to K step cc / 8, swizzled place cc % 8 of the row; the LayerNorm
    // scale and shift into the staging buffer, idle until the first
    // epilogue.
    const int kc = nk * 8;                    // 16-byte chunks a row, padded to whole K steps
    const int kq = K >> 3;                    // chunks of real channels
    for (int ch = tid; ch < R * kc; ch += THREADS) {
        const int r = ch / kc, cc = ch - r * kc;
        const int m = m0 + r, k = cc * 8;
        const bool ok = m < M && k < K;
        cp_async16(rows_s + (cc >> 3) * A_BLOCK + swz_offset<128>(r, cc & 7),
                   ok ? p.x + (size_t)m * K + k : p.x, ok);
    }
    const uint32_t stg_s = rows_s + nk * A_BLOCK;
    for (int ch = tid; ch < 2 * kq; ch += THREADS)
        cp_async16(stg_s + ch * 16, ch < kq ? p.ln_g + ch * 8 : p.ln_b + (ch - kq) * 8, true);
    cp_async_commit();

    // The ring's loads run through the run's steps in order: column tile
    // ld_t, K step ld_ks. This thread copies chunk j of stage rows r0 + 32u
    // (H: rows [0, BN) are value rows n0.., [BN, 2BN) gate rows N + n0..),
    // from sources set once a column tile.
    constexpr int U = T::B_ROWS / 32;
    const int j = tid & 7, r0 = tid >> 3;
    const uint32_t chunk_off = ring + r0 * 128 + ((j ^ (r0 & 7)) << 4);
    const bf16* src[U];
    bool row_ok[U];
    int ld_t = 0, ld_ks = 0, ld_slot = 0;
    auto load_next = [&]() {
        if (ld_ks == 0) {
            const int c = tile_of(ld_t), wi = c / p.ntn, n0 = (c - wi * p.ntn) * BN;
            // selected, not indexed: a runtime index into the parameters
            // would copy them to local memory
            const bf16* w = wi == 0 ? p.w0 : wi == 1 ? p.w1 : p.w2;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const bool gate = G && u >= BN / 32;
                const int n = n0 + r0 + 32 * u - (gate ? BN : 0);
                row_ok[u] = n < N;
                src[u] = w + (size_t)(row_ok[u] ? (gate ? N + n : n) : 0) * K + j * 8;
            }
        }
        const bool k_ok = ld_ks * BK + j * 8 < K;
        const uint32_t sb = chunk_off + ld_slot * T::STAGE_BYTES;
#pragma unroll
        for (int u = 0; u < U; ++u)
            cp_async16(sb + u * 32 * 128, src[u] + (k_ok ? ld_ks * BK : 0), k_ok && row_ok[u]);
        if (++ld_ks == nk) {
            ld_ks = 0;
            ++ld_t;
        }
        if (++ld_slot == S) ld_slot = 0;
    };
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
        if (s < steps) load_next();
        cp_async_commit();
    }
    cp_async_wait<AHEAD>();                   // this thread's copies of the rows have landed
    __syncthreads();                          // everyone's have

    // LayerNorm of the rows in place: 8 lanes a row, each lane on R / 32
    // rows at once (rows warp * 4 + lane / 8 + 32 u); lane s takes the
    // rows' chunks s, s + 8, ..: two passes for the statistics (the mean,
    // then the mean of squared deviations), a third to write the normalized
    // bf16 rows (0 past K).
    {
        constexpr int RW = R / 32;
        const int s = tid & 7, r0w = (tid >> 5) * 4 + ((tid & 31) >> 3);
        const float inv_k = 1.f / (float)K;
        unsigned char* row = rows_p + r0w * 128 + ((s ^ (r0w & 7)) << 4);
        float sum[RW], mean[RW], rstd[RW], f[8];
#pragma unroll
        for (int u = 0; u < RW; ++u) sum[u] = 0.f;
#pragma unroll 4
        for (int cc = s; cc < kq; cc += 8)
#pragma unroll
            for (int u = 0; u < RW; ++u) {
                bf16x8_to_float(
                    *reinterpret_cast<const uint4*>(row + u * 32 * 128 + (cc >> 3) * A_BLOCK), f);
#pragma unroll
                for (int e = 0; e < 8; ++e) sum[u] += f[e];
            }
#pragma unroll
        for (int u = 0; u < RW; ++u) {
            mean[u] = row_sum(sum[u]) * inv_k;
            sum[u] = 0.f;
        }
#pragma unroll 4
        for (int cc = s; cc < kq; cc += 8)
#pragma unroll
            for (int u = 0; u < RW; ++u) {
                bf16x8_to_float(
                    *reinterpret_cast<const uint4*>(row + u * 32 * 128 + (cc >> 3) * A_BLOCK), f);
#pragma unroll
                for (int e = 0; e < 8; ++e) sum[u] += (f[e] - mean[u]) * (f[e] - mean[u]);
            }
#pragma unroll
        for (int u = 0; u < RW; ++u) rstd[u] = rsqrtf(row_sum(sum[u]) * inv_k + p.eps);
#pragma unroll 2
        for (int cc = s; cc < kc; cc += 8) {
            float gv[8], bv[8];
            if (cc < kq) {
                bf16x8_to_float(*reinterpret_cast<const uint4*>(stg + cc * 16), gv);
                bf16x8_to_float(*reinterpret_cast<const uint4*>(stg + (kq + cc) * 16), bv);
            }
#pragma unroll
            for (int u = 0; u < RW; ++u) {
                uint4* chunk = reinterpret_cast<uint4*>(row + u * 32 * 128 + (cc >> 3) * A_BLOCK);
                uint4 y = make_uint4(0u, 0u, 0u, 0u);
                if (cc < kq) {
                    bf16x8_to_float(*chunk, f);
                    uint32_t* yw = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        yw[e] = pack_bf16x2(
                            (f[2 * e] - mean[u]) * rstd[u] * gv[2 * e] + bv[2 * e],
                            (f[2 * e + 1] - mean[u]) * rstd[u] * gv[2 * e + 1] + bv[2 * e + 1]);
                }
                *chunk = y;
            }
        }
    }
    fence_proxy_async();                      // the rows, written by threads, to the tensor cores
    __syncthreads();

    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    const uint32_t a_off = (SPLIT ? 0 : wg * 64) * 128;   // this warpgroup's rows
    const uint32_t b_off = (SPLIT ? wg * NW : 0) * 128;   // and its weight rows of a stage

    for (int i = 0, t = 0, ks = 0, slot = 0; i < steps; ++i) {
        cp_async_wait<AHEAD - 1>();          // this thread's copies of stage i have landed
        fence_proxy_async();
        __syncthreads();                     // everyone's have; every wgmma of step i - 1 is done
        const uint64_t da = smem_desc<128>(rows_s + ks * A_BLOCK + a_off, 16, 1024);
        const uint64_t db = smem_desc<128>(ring + slot * T::STAGE_BYTES + b_off, 16, 1024);
        if (++slot == S) slot = 0;
        wgmma_fence();
        fence_operands(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            Wgmma<NW>::mma(acc, da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
        wgmma_commit();
        fence_operands(acc);
        // the refill takes the slot step i - 1 read, while this step's products run
        if (i + AHEAD < steps) load_next();
        cp_async_commit();
        wgmma_wait<0>();                     // this warpgroup's products are done
        fence_operands(acc);                 // (the epilogue reads acc only after the wait)
        if (++ks == nk) {                    // the column tile is complete
            epilogue<T, OutT>(p, acc, stg, m0, tile_of(t));
            ks = 0;
            ++t;
        }
    }
    cp_async_wait<0>();
}

template <class T, typename OutT>
int launch(const LnParams& p, int smem, cudaStream_t s) {
    auto kern = ln_proj_kernel<T, OutT>;
    // the largest dynamic shared memory size, set once per device for this instance
    static unsigned set_on = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 32 || !((set_on >> dev) & 1u)) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (dev < 32) set_on |= 1u << dev;
    }
    dim3 grid(p.groups, (p.M + T::R - 1) / T::R);
    kern<<<grid, THREADS, smem, s>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hcp

// Kernels G, H and I: LayerNorm(x; ln_g, ln_b, eps) over rows of x [M, K],
// then mode 0 (DENSE: G with nw = 3 weights w0..w2 into out0..out2, I with
// nw = 1; no bias) or mode 2 (GEGLU: H, w0 [2N, K], bias [2N] or null).
// ln_g, ln_b [K] and each w [N, K]: bf16; bias and each out [M, N]: bf16,
// or fp32 when out_f32 != 0. Row-major, 16-byte aligned; K % 8 == 0,
// N % 2 == 0. rows, bn, stages and minb name a tile of HCP_LN_GEMM_TILES
// for the mode, whose rows must hold ceil(K / 64) K steps; groups (1 .. nw *
// ceil(N / bn)) splits each row tile's column tiles into that many runs.
// Returns cudaGetLastError(), or the error of setting the kernel's shared
// memory size, or cudaErrorInvalidValue for another mode, tile, K or
// groups.
extern "C" int hcp_ln_gemm(int mode, const void* x, const void* ln_g, const void* ln_b,
                           const void* w0, const void* w1, const void* w2, const void* bias,
                           void* out0, void* out1, void* out2, int nw, int M, int N, int K,
                           float eps, int rows, int bn, int stages, int minb, int groups,
                           int out_f32, void* stream) {
    using namespace hcp;
    if (nw < 1 || nw > 3 || (mode == GEGLU && nw != 1) || (mode != DENSE && mode != GEGLU) ||
        M < 1 || N < 2 || K < 8 || bn < 8)
        return static_cast<int>(cudaErrorInvalidValue);
    LnParams p = {};
    p.x = static_cast<const bf16*>(x);
    p.w0 = static_cast<const bf16*>(w0);
    p.w1 = static_cast<const bf16*>(nw > 1 ? w1 : w0);
    p.w2 = static_cast<const bf16*>(nw > 2 ? w2 : w0);
    p.bias = mode == GEGLU ? bias : nullptr;
    p.out0 = out0;
    p.out1 = nw > 1 ? out1 : out0;
    p.out2 = nw > 2 ? out2 : out0;
    p.ln_g = static_cast<const bf16*>(ln_g);
    p.ln_b = static_cast<const bf16*>(ln_b);
    p.eps = eps;
    p.M = M;
    p.N = N;
    p.K = K;
    p.nk = (K + BK - 1) / BK;
    p.ntn = (N + bn - 1) / bn;
    p.tiles = nw * p.ntn;
    p.groups = groups;
    if (groups < 1 || groups > p.tiles) return static_cast<int>(cudaErrorInvalidValue);
    const bool geglu = mode == GEGLU;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HCP_LN_GEMM_CASE(G_, R_, BN_, S_, MINB_)                                        \
    if (geglu == G_ && rows == R_ && bn == BN_ && stages == S_ && minb == MINB_) {      \
        using T = LnCfg<G_, R_, BN_, S_, MINB_>;                                        \
        if (p.nk * BK > T::MAX_KPAD) return static_cast<int>(cudaErrorInvalidValue);    \
        const int smem = T::FIXED + p.nk * R_ * 128;                                     \
        return out_f32 ? launch<T, float>(p, smem, s) : launch<T, bf16>(p, smem, s);   \
    }
    HCP_LN_GEMM_TILES(HCP_LN_GEMM_CASE)
#undef HCP_LN_GEMM_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
