// Kernels B (geglu_dense) and C (fused_dense): the transformer block's
// feed-forward GEMMs, y = x @ w^T with x [M, K] and w [N, K] (nn.Linear
// layout), fp32 accumulation, and a fused epilogue:
//   B  GEGLU      (x Wv^T + bv) * gelu_erf(x Wg^T + bg), w = [Wv; Wg] [2N, K]
//   C  DENSE(_RES) x W^T + b (+ res)
//
// Replaces hcpdiff_tpu/ops/matmul.py:_geglu_kernel (:301, pallas_call
// :334) and _dense_kernel_kres / _dense_kernel_kstream (:66 / :87,
// pallas_calls :168 / :193).
//
// What bounds it on the H100: at the UNet's shapes (M = 2b * S up to
// 32768, K 320..5120, N 320..5120) B is far above the 295 FLOP/byte ridge
// (the tensor cores bound it); C is too, except at the 64x64 level (K =
// 1280, N = 320), where the residual read and the output write make it
// bound by its bytes. Only wgmma reaches the tensor cores' full rate. The
// epilogues are memory traffic that separate passes would add on top, so
// they stay on chip: B computes the value and the gate tile of the same
// output columns in one block, so the [M, 2N] intermediate never reaches
// device memory; C adds bias and residual before its single store.
//
// Design (J's, csrc/conv.cu): both operands are K-major, so a K step of 64
// channels is one 128-byte row of the 128-byte swizzle for both.
//   - A ring of STAGES shared-memory stages filled by 16-byte cp.async:
//     each stage an x tile (128 x 64) and a weight tile of BN rows (C) or
//     2 x BN rows (B: value rows n0.., then gate rows N + n0..), in the
//     K-major layout wgmma's descriptors read (wgmma.cuh). Rows past M or N
//     and columns past K are zero-filled through cp.async's source size.
//     A landed stage passes cp.async.wait_group, fence.proxy.async and a
//     barrier. At one block an SM one wgmma group stays in flight and the
//     refill takes the slot step i - 2 read; at two, a step waits for its
//     products (the other block fills the tensor cores meanwhile) and the
//     refill takes the slot of step i - 1, one stage further ahead.
//   - Two consumer warpgroups, each over one 64-row half: C issues
//     m64nBNk16, B one product into a value and one into a gate
//     accumulator per k16.
//   - Epilogue: B forms (v + bv) * gelu(g + bg) in registers. The fp32
//     tile (and C's bias) then goes through the ring's freed shared memory,
//     so that the residual reads and the output stores run along rows, a
//     warp over 128 contiguous columns, several rows' residuals in flight
//     at once.
//   - Split-K: where the grid is short of a wave, the host plan
//     (ops/matmul.py:gemm_plan) splits the K steps over grid.z. Each block
//     writes its fp32 partial tile (B: value and gate) to a workspace, and
//     a second kernel adds the partials in split order and applies the
//     epilogue: no float atomics, so the output is deterministic.
//   - The tiles (BN, stages, blocks an SM) are the HCP_GEMM_TILES table,
//     which the plan mirrors (GEMM_TILES) and tests check against this
//     source. At one block an SM nothing overlaps a block's prologue and
//     epilogue; two blocks an SM (<= 128 registers a thread) hide them.
// Not yet: TMA loads and multicast of the shared operand. A persistent
// variant whose epilogue warpgroups drained each staged tile while the
// consumers ran the next was right but slower at one block an SM (PERF.md).
//
// Types: x and w are bf16. bias, res and the output are OutT: bf16, or
// fp32 for an fp32 call (whose x and w the wrapper rounds to bf16), so the
// result is rounded once.
#include "wgmma.cuh"

namespace hcp {
namespace {

enum Mode { DENSE = 0, DENSE_RES = 1, GEGLU = 2 };

constexpr int BM = 128;              // rows of x per block: two warpgroups of 64
constexpr int BK = 64;               // channels per K step: one 128-byte row
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * BK * 2;
constexpr int MAX_SMEM = 232448;     // 227 KB: the most a block may use
constexpr int SM_SMEM = 233472;      // 228 KB an SM, of which each block takes 1 KB more

// X(GEGLU, BN, STAGES, MINB): the built tiles. BN output columns a block
// (one wgmma of N = BN per operand and k16), STAGES ring slots, MINB blocks
// an SM (MINB = 2 caps a thread at 128 registers). A tile is chosen by
// (GEGLU, BN, MINB). B's 64 x 2 beats a 128 x 1 tile, and C's 160 x 2 a
// 320-column tile, at every shape they were timed at (tools/time_plans.py;
// PERF.md); C's 160 x 1 with a deeper ring serves grids of one block an SM.
#define HCP_GEMM_TILES(X)          \
    X(true, 64, 3, 2)              \
    X(false, 160, 5, 1)            \
    X(false, 160, 3, 2)            \
    X(false, 128, 3, 2)

template <bool GEGLU_, int BN_, int STAGES_, int MINB_>
struct Tile {
    static constexpr bool IS_GEGLU = GEGLU_;
    static constexpr int BN = BN_, STAGES = STAGES_, MINB = MINB_;
    static constexpr int B_ROWS = GEGLU_ ? 2 * BN_ : BN_;   // weight rows a stage holds
    static constexpr int STAGE_BYTES = A_BYTES + B_ROWS * BK * 2;
    static constexpr int NACC = GEGLU_ ? 2 : 1;             // accumulators (B: value, gate)
    // wgmma groups left in flight at a step's end: at two blocks an SM the
    // other block keeps the tensor cores busy while a step waits for its own
    // products, so the ring loads one stage further ahead instead
    static constexpr int LAG = MINB_ > 1 ? 0 : 1;
    static constexpr int AHEAD = STAGES_ - 1 - LAG;   // stages loaded ahead of the one in use
    static constexpr int LDO = BN_ + 8;   // staged row in floats: float2 writes conflict-free
    static constexpr int RING = STAGES_ * STAGE_BYTES;
    static constexpr int OUT_BYTES = (BM * LDO + BN_) * 4;   // the staged tile and C's bias
    // + 1024 bytes to align the ring to the swizzle's 1024-byte period
    static constexpr int SMEM = (RING > OUT_BYTES ? RING : OUT_BYTES) + 1024;
    static_assert(B_ROWS % 32 == 0 && STAGES_ >= 3, "a thread copies rows r, r + 32, ..");
    static_assert(BN_ <= 256, "wgmma takes N <= 256");
    static_assert(SMEM <= MAX_SMEM, "the ring does not fit a block");
    static_assert(MINB_ * (SMEM + 1024) <= SM_SMEM, "MINB blocks do not fit an SM");
};

struct GemmParams {
    const bf16* x;              // [M, K]
    const bf16* w;              // [N, K] or [2N, K] (GEGLU)
    const void* bias;           // [N] or [2N] (GEGLU) or null   (output type)
    const void* res;            // [M, N] or null                 (output type)
    void* out;                  // [M, N]                         (output type)
    float* ws;                  // [splits, M, N or 2N] partial sums, or null (one split)
    int M, N, K;                // N: output columns
    int ksteps;                 // ceil(K / 64)
    int splits;
};

__device__ __forceinline__ float gelu_erf(float g) {
    return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

__device__ __forceinline__ float4 load4(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

// The epilogue of columns col, col + 1 of output row `row` from their sums
// (B: v = value, g = gate; C: v = x W^T, g unused), one store.
template <bool GEGLU, typename OutT>
__device__ __forceinline__ void epilogue_pair(const GemmParams& p, int row, int col, float2 v,
                                              float2 g) {
    const OutT* bias = static_cast<const OutT*>(p.bias);
    if (GEGLU) {
        if (bias) {
            v.x += as_float(bias[col]);
            v.y += as_float(bias[col + 1]);
            g.x += as_float(bias[p.N + col]);
            g.y += as_float(bias[p.N + col + 1]);
        }
        v.x *= gelu_erf(g.x);
        v.y *= gelu_erf(g.y);
    } else {
        if (bias) {
            v.x += as_float(bias[col]);
            v.y += as_float(bias[col + 1]);
        }
        if (p.res) {
            const float2 r = load2(static_cast<const OutT*>(p.res) + (size_t)row * p.N + col);
            v.x += r.x;
            v.y += r.y;
        }
    }
    store2(static_cast<OutT*>(p.out) + (size_t)row * p.N + col, v.x, v.y);
}

template <class T, typename OutT>
__global__ void __launch_bounds__(THREADS, T::MINB) ffn_gemm_kernel(GemmParams p) {
    constexpr bool G = T::IS_GEGLU;
    constexpr int BN = T::BN, S = T::STAGES, SB = T::STAGE_BYTES;
    constexpr int NACC = T::NACC;
    constexpr int A_ROWS = BM / 32, B_ROWS = T::B_ROWS / 32;   // rows a thread copies
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;

    const int tid = threadIdx.x;
    const int M = p.M, N = p.N, K = p.K;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int ks0 = (int)((long long)blockIdx.z * p.ksteps / p.splits);
    const int nk = (int)((long long)(blockIdx.z + 1) * p.ksteps / p.splits) - ks0;

    // This thread copies the 16-byte chunk j (channels 8j .. 8j + 7 of the
    // step) of tile rows r0 + 32 i; all those rows share r0 % 8, so the
    // chunk's swizzled place in the row is one constant.
    const int j = tid & 7, r0 = tid >> 3;
    const uint32_t chunk_off = r0 * 128 + ((j ^ (r0 & 7)) << 4);
    auto load_stage = [&](int slot, int ks) {
        const int k = ks * BK + j * 8;
        const bool k_ok = k < K;
        const uint32_t sa = base + slot * SB + chunk_off;
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i) {
            const int m = m0 + r0 + 32 * i;
            const bool ok = k_ok && m < M;
            cp_async16(sa + i * 32 * 128, ok ? p.x + (size_t)m * K + k : p.x, ok);
        }
#pragma unroll
        for (int i = 0; i < B_ROWS; ++i) {
            // B: tile rows [0, BN) are value rows n0.., [BN, 2BN) gate rows N + n0..
            const bool gate = G && i >= BN / 32;
            const int n = n0 + r0 + 32 * i - (gate ? BN : 0);
            const bool ok = k_ok && n < N;
            const bf16* src = p.w + (size_t)(gate ? N + n : n) * K + k;
            cp_async16(sa + A_BYTES + i * 32 * 128, ok ? src : p.w, ok);
        }
    };

    float acc[NACC][BN / 2];
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[a][i] = 0.f;
    const int wg = tid >> 7;

    constexpr int AHEAD = T::AHEAD, LAG = T::LAG;
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
        if (s < nk) load_stage(s, ks0 + s);
        cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
        cp_async_wait<AHEAD - 1>();      // this thread's copies of stage i have landed
        fence_proxy_async();
        __syncthreads();                 // everyone's have; every wgmma of step i - 1 - LAG is done
        const uint32_t sa = base + (i % S) * SB;
        const uint64_t da = smem_desc<128>(sa + wg * 64 * 128, 16, 1024);
        const uint64_t db = smem_desc<128>(sa + A_BYTES, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < NACC; ++a) fence_operands(acc[a]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int a = 0; a < NACC; ++a)  // B's gate rows BN.. start BN * 128 bytes on
                Wgmma<BN>::mma(acc[a], da + 2 * kk, db + 2 * kk + a * BN * 8);
        wgmma_commit();
#pragma unroll
        for (int a = 0; a < NACC; ++a) fence_operands(acc[a]);
        wgmma_wait<LAG>();               // this warpgroup's products of step i - LAG are done
        // the refill takes the slot step i - 1 - LAG read
        if (i + AHEAD < nk) load_stage((i + AHEAD) % S, ks0 + i + AHEAD);
        cp_async_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NACC; ++a) fence_operands(acc[a]);

    // Accumulator i of product a: row wg * 64 + warp * 16 + g + 8 * ((i / 2) % 2),
    // column (i / 4) * 8 + 2 * q + i % 2 of the tile (B: a = 0 value, 1 gate).
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int trow = wg * 64 + warp * 16 + g;

    if (p.ws) {                          // split partial sums, from registers
        const int wsn = G ? 2 * N : N;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + trow + 8 * h;
            if (row >= M) continue;
            float* dst = p.ws + ((size_t)blockIdx.z * M + row) * wsn;
#pragma unroll
            for (int a = 0; a < NACC; ++a)
#pragma unroll
                for (int jn = 0; jn < BN / 8; ++jn) {
                    const int col = n0 + jn * 8 + 2 * q;
                    if (col >= N) continue;  // N is even, so col + 1 < N too
                    store2(dst + a * N + col, acc[a][jn * 4 + 2 * h],
                           acc[a][jn * 4 + 2 * h + 1]);
                }
        }
        return;
    }

    const OutT* bias = static_cast<const OutT*>(p.bias);
    if (G) {                             // the GEGLU pair, in registers, into acc[0]
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = n0 + jn * 8 + 2 * q + e;
                const float bv = bias && col < N ? as_float(bias[col]) : 0.f;
                const float bg = bias && col < N ? as_float(bias[N + col]) : 0.f;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int i = jn * 4 + 2 * h + e;
                    acc[0][i] = (acc[0][i] + bv) * gelu_erf(acc[NACC - 1][i] + bg);
                }
            }
    }

    // The fp32 tile (and C's bias) through the ring's shared memory, then
    // along rows: a warp covers 128 contiguous columns, and the residuals of
    // U chunks are loaded before any of them is stored.
    __syncthreads();                     // every warpgroup is done reading the ring
    float* so = reinterpret_cast<float*>(smem_raw + (base - raw));
    float* sbias = so + BM * T::LDO;     // C: the tile's bias, 0 past N
    constexpr int LDO = T::LDO;
    if (!G)
        for (int c = tid; c < BN; c += THREADS)
            sbias[c] = bias && n0 + c < N ? as_float(bias[n0 + c]) : 0.f;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(so + (trow + 8 * h) * LDO + jn * 8 + 2 * q) =
                make_float2(acc[0][jn * 4 + 2 * h], acc[0][jn * 4 + 2 * h + 1]);
    __syncthreads();

    OutT* out = static_cast<OutT*>(p.out);
    const OutT* res = static_cast<const OutT*>(p.res);
    const bool vec = (N & 3) == 0;       // 4 columns of a row start 4-element aligned
    constexpr int CPR = BN / 4;          // 4-column chunks a row
    constexpr int CHUNKS = BM * CPR / THREADS, U = CHUNKS % 8 == 0 ? 8 : 4;
    static_assert(BM * CPR % THREADS == 0 && CHUNKS % U == 0, "chunks split evenly");
    for (int c0 = 0; c0 < CHUNKS; c0 += U) {
        float4 rv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = tid + (c0 + u) * THREADS, r = c / CPR, cc = (c - r * CPR) * 4;
            const int row = m0 + r, col = n0 + cc;
            rv[u] = res && vec && row < M && col + 4 <= N ? load4(res + (size_t)row * N + col)
                                                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = tid + (c0 + u) * THREADS, r = c / CPR, cc = (c - r * CPR) * 4;
            const int row = m0 + r, col = n0 + cc;
            if (row >= M || col >= N) continue;
            float4 v = *reinterpret_cast<const float4*>(so + r * LDO + cc);
            if (vec && col + 4 <= N) {
                if (!G) {
                    const float4 b = *reinterpret_cast<const float4*>(sbias + cc);
                    v.x += b.x + rv[u].x;
                    v.y += b.y + rv[u].y;
                    v.z += b.z + rv[u].z;
                    v.w += b.w + rv[u].w;
                }
                store4(out + (size_t)row * N + col, v);
            } else {                     // N % 4 != 0, or the last 2 columns of a row
                const float2 ys[2] = {make_float2(v.x, v.y), make_float2(v.z, v.w)};
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    if (col + 2 * e >= N) break;
                    if (G)
                        store2(out + (size_t)row * N + col + 2 * e, ys[e].x, ys[e].y);
                    else
                        epilogue_pair<false, OutT>(p, row, col + 2 * e, ys[e], ys[e]);
                }
            }
        }
    }
}

// The split partial sums [splits, M, N or 2N], added in split order, then
// the epilogue; one thread per pair of output columns.
template <bool GEGLU, typename OutT>
__global__ void __launch_bounds__(THREADS) ffn_splitk_reduce(GemmParams p) {
    const int N = p.N;
    const size_t wsn = GEGLU ? 2 * (size_t)N : N;
    const size_t plane = (size_t)p.M * wsn, pairs = (size_t)p.M * N / 2;
    for (size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x; idx < pairs;
         idx += (size_t)gridDim.x * THREADS) {
        const int row = (int)(idx * 2 / N), col = (int)(idx * 2 % N);
        const float* src = p.ws + (size_t)row * wsn + col;
        float2 v = make_float2(0.f, 0.f), g = v;
        for (int s = 0; s < p.splits; ++s, src += plane) {
            const float2 a = *reinterpret_cast<const float2*>(src);
            v.x += a.x;
            v.y += a.y;
            if (GEGLU) {
                const float2 b = *reinterpret_cast<const float2*>(src + N);
                g.x += b.x;
                g.y += b.y;
            }
        }
        epilogue_pair<GEGLU, OutT>(p, row, col, v, g);
    }
}

template <class T, typename OutT>
int launch(const GemmParams& p, cudaStream_t s) {
    auto kern = ffn_gemm_kernel<T, OutT>;
    // the dynamic shared memory size, set once per device for this instance
    static unsigned set_on = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 32 || !((set_on >> dev) & 1u)) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (dev < 32) set_on |= 1u << dev;
    }
    dim3 grid((p.N + T::BN - 1) / T::BN, (p.M + BM - 1) / BM, p.splits);
    kern<<<grid, THREADS, T::SMEM, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
    const size_t pairs = (size_t)p.M * p.N / 2, needed = (pairs + THREADS - 1) / THREADS;
    const int blocks = (int)(needed < 132 * 8 ? needed : 132 * 8);
    ffn_splitk_reduce<T::IS_GEGLU, OutT><<<blocks, THREADS, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hcp

// Kernels B and C. mode DENSE or DENSE_RES (C: w [N, K], bias [N] or null,
// res [M, N] under DENSE_RES) or GEGLU (B: w [2N, K], value rows first,
// bias [2N] or null). x and w: bf16; bias, res and out [M, N]: bf16, or
// fp32 when out_f32 != 0. All row-major, 16-byte aligned; K % 8 == 0,
// N % 2 == 0. bn and minb name a tile of HCP_GEMM_TILES for the mode; with
// splits > 1, workspace holds splits * M * N floats (GEGLU: 2N), and
// 1 <= splits <= ceil(K / 64). Returns cudaGetLastError(), or the error of
// setting the kernel's shared memory size, or cudaErrorInvalidValue for
// another mode, tile or splits.
extern "C" int hcp_gemm(int mode, const void* x, const void* w, const void* bias,
                        const void* res, void* out, void* workspace, int M, int N, int K,
                        int bn, int minb, int splits, int out_f32, void* stream) {
    using namespace hcp;
    GemmParams p;
    p.x = static_cast<const bf16*>(x);
    p.w = static_cast<const bf16*>(w);
    p.bias = bias;
    p.res = mode == DENSE_RES ? res : nullptr;
    p.out = out;
    p.M = M;
    p.N = N;
    p.K = K;
    p.ksteps = (K + BK - 1) / BK;
    p.splits = splits;
    p.ws = splits > 1 ? static_cast<float*>(workspace) : nullptr;
    if (mode < DENSE || mode > GEGLU || (mode == DENSE_RES) != (res != nullptr) || splits < 1 ||
        splits > p.ksteps || (splits > 1 && workspace == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const bool geglu = mode == GEGLU;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HCP_GEMM_CASE(G_, BN_, S_, MINB_)                                         \
    if (geglu == G_ && bn == BN_ && minb == MINB_)                                \
        return out_f32 ? launch<Tile<G_, BN_, S_, MINB_>, float>(p, s)            \
                       : launch<Tile<G_, BN_, S_, MINB_>, bf16>(p, s);
    HCP_GEMM_TILES(HCP_GEMM_CASE)
#undef HCP_GEMM_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
