// Kernels K (quantize_rows) and L (int8_dense): dynamic w8a8 int8 dense
// layers, y = dequant(q(x) q(w)^T) (+ bias) (+ res) with x [M, K] and w
// [N, K] (nn.Linear layout).
//   K  per-row symmetric int8: s[m] = max(amax(x[m, :]), 1e-12) / 127 and
//      codes rint(x / s) clipped to +-127, for an activation [M, K] and a
//      weight [N, K] alike (the weight's rows are its output channels)
//   L  acc = codes_x codes_w^T in int32 (wgmma m64nNk32.s32.s8.s8), then
//      out = T(float(acc) * (sx[m] * sw[n])), out = T(out + bias[n]),
//      out = T(out + res[m, n]), T the rounding to the output type
//
// Replaces no Pallas kernel: hcpdiff_tpu/ops/int8.py leaves the int8 dot,
// the quantizers and the dequantizing epilogue to XLA. On Hopper the int8
// product needs a kernel of its own: int8 wgmma runs at twice the bf16 rate
// (1979 dense TOPS), and the dequantizing epilogue stays on chip.
//
// Arithmetic, bit for bit the plain versions' (ops/int8.py): the amax is
// exact in any order; the scale and the codes use IEEE division (the build
// has no --use_fast_math) and rintf (round half to even, as torch.round and
// jnp.round); the int32 sum is exact; cvt.rn.f32.s32 (__int2float_rn)
// rounds it as the plain version's .float() does, and the epilogue's
// products and sums are __fmul_rn / __fadd_rn, never contracted into an FMA.
//
// What bounds them on the H100: K reads its input twice (once for the
// amax, once for the codes; the second read mostly from L1/L2) and writes a
// quarter (bf16: half) of it: bytes. L at the UNet's shapes (M = 2b * S up
// to 32768, K 320..5120, N 320..5120) is mostly bound by its output's bytes
// (ff.proj at level 0 writes 168 MB of bf16 against 0.027 ms of int8
// operations); the large-K products (ff.out) by operations.
//
// Design of K: one warp a row, 16-byte loads of 8 values, a warp-shuffle
// max, then the codes of 8 values as one 8-byte store; the code rows are
// zero-padded from K to Kp = ceil(K / 32) * 32, so L's 16-byte copies of a
// row stay aligned and the zeros leave the amax and the dot unchanged.
//
// Design of L: C's (gemm_wgmma.cu) over int8, at one or two blocks an SM
// (HCP_INT8_TILES; ops/int8.py:l_blocks_per_sm takes two where the grid
// has a block for every SM: at ff.proj level 0, 0.166 against 0.240 ms at
// one, tools/time_int8.py). A K step
// is 128 channels, one 128-byte row of the 128-byte swizzle for both
// operands, both K-major (8-bit wgmma has no transpose bit); a 32-deep
// int8 slice is 32 bytes, as a 16-deep bf16 slice is, so wgmma.cuh's
// descriptors carry over unchanged (Wgmma8).
//   - A ring of STAGES shared-memory stages filled by 16-byte cp.async: the
//     x codes (128 rows) and the w codes (160 rows) of a K step, rows past
//     M or N and columns past Kp zero-filled through cp.async's source size.
//   - Two consumer warpgroups, each over one 64-row half, m64n160k32 int32
//     products; at one block an SM one wgmma group stays in flight at a
//     step's end, at two a step waits for its products while the other
//     block's loads, products or epilogue run.
//   - Epilogue: each int32 accumulator is converted and scaled by sx[m] *
//     sw[n] in registers; the fp32 tile goes through the ring's freed shared
//     memory, then along rows (a warp over 160 contiguous columns), where
//     the roundings, the bias and the residual are applied before one store.
// Not yet: TMA, split-K for short grids, a persistent grid, weight codes
// kept between calls.
//
// Types: the quantizer reads bf16 or fp32 (x_f32); L's bias, res and output
// are OutT: bf16, or fp32 for an fp32 call.
#include "wgmma.cuh"

#include <stdint.h>

namespace hcp {
namespace {

// ------------------------------------------------------------------ K ----
constexpr int Q_THREADS = 256;        // 8 warps: one row each
constexpr int CODE_ALIGN = 32;        // code rows are padded to a multiple of this

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(Q_THREADS) quantize_rows_kernel(const T* __restrict__ x,
                                                                  int8_t* __restrict__ q,
                                                                  float* __restrict__ s, int M,
                                                                  int K, int Kp) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * (Q_THREADS / 32) + (threadIdx.x >> 5);
    if (row >= M) return;
    const T* xr = x + (size_t)row * K;
    const int groups = K / 8;
    float amax = 0.f;
    for (int g = lane; g < groups; g += 32) {
        float v[8];
        load8(xr + g * 8, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float sc = fmaxf(amax, 1e-12f) / 127.0f;    // IEEE division
    if (lane == 0) s[row] = sc;
    int8_t* qr = q + (size_t)row * Kp;
    for (int g = lane; g < Kp / 8; g += 32) {
        uint32_t packed[2] = {0u, 0u};
        if (g < groups) {
            float v[8];
            load8(xr + g * 8, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const float c = fminf(fmaxf(rintf(v[e] / sc), -127.f), 127.f);
                packed[e / 4] |= (static_cast<uint32_t>(static_cast<int>(c)) & 0xffu)
                                 << (8 * (e % 4));
            }
        }
        *reinterpret_cast<uint2*>(qr + g * 8) = make_uint2(packed[0], packed[1]);
    }
}

// ------------------------------------------------------------------ L ----
constexpr int BM = 128;               // rows a block: two warpgroups of 64
constexpr int BN = 160;               // output columns a block (divides 320k)
constexpr int BK = 128;               // channels a K step: one 128-byte row
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * BK;
constexpr int STAGE_BYTES = A_BYTES + BN * BK;
constexpr int LDO = BN + 8;           // staged row in floats: float2 writes conflict-free
constexpr int OUT_BYTES = (BM * LDO + BN) * 4;   // the staged tile and the bias
static_assert(BN % 32 == 0 && BM % 32 == 0, "a thread copies rows r, r + 32, ..");

// X(STAGES, MINB): the built tiles, STAGES ring slots and MINB blocks an SM
// (MINB = 2 caps a thread at 128 registers: 4 bytes spill). ops/int8.py's
// INT8_TILES mirrors this table; tools/time_int8.py times both.
#define HCP_INT8_TILES(X) \
    X(4, 1)               \
    X(3, 2)

template <int STAGES_, int MINB_>
struct Tile {
    static constexpr int STAGES = STAGES_, MINB = MINB_;
    // wgmma groups left in flight at a step's end: at two blocks an SM the
    // other block keeps the tensor cores busy while a step waits for its own
    static constexpr int LAG = MINB_ > 1 ? 0 : 1;
    static constexpr int AHEAD = STAGES_ - 1 - LAG;   // stages loaded ahead of the one in use
    static constexpr int RING = STAGES_ * STAGE_BYTES;
    // + 1024 bytes to align the ring to the swizzle's 1024-byte period
    static constexpr int SMEM = (RING > OUT_BYTES ? RING : OUT_BYTES) + 1024;
    static_assert(STAGES_ >= 3, "the refill takes the slot of step i - 1 - LAG");
    static_assert(SMEM <= 232448, "the ring does not fit a block");
    static_assert(MINB_ * (SMEM + 1024) <= 233472, "MINB blocks do not fit an SM");
};

struct Int8Params {
    const int8_t* xq;       // [M, Kp]
    const int8_t* wq;       // [N, Kp]
    const float* sx;        // [M]
    const float* sw;        // [N]
    const void* bias;       // [N] or null   (output type)
    const void* res;        // [M, N] or null (output type)
    void* out;              // [M, N]         (output type)
    int M, N, Kp, ksteps;
};

template <typename OutT>
__device__ __forceinline__ float round_out(float v) {
    return v;
}
template <>
__device__ __forceinline__ float round_out<bf16>(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// The rounded dequantized value, then + bias, then + residual, each sum
// rounded to OutT (the JAX order).
template <typename OutT>
__device__ __forceinline__ float finish(float v, float b, float r, bool has_b, bool has_r) {
    v = round_out<OutT>(v);
    if (has_b) v = round_out<OutT>(__fadd_rn(v, b));
    if (has_r) v = round_out<OutT>(__fadd_rn(v, r));
    return v;
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
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

template <class T, typename OutT>
__global__ void __launch_bounds__(THREADS, T::MINB) int8_gemm_kernel(Int8Params p) {
    constexpr int STAGES = T::STAGES, AHEAD = T::AHEAD, LAG = T::LAG;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;

    const int tid = threadIdx.x;
    const int M = p.M, N = p.N, Kp = p.Kp, nk = p.ksteps;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

    // This thread copies the 16-byte chunk j (channels 16j .. 16j + 15 of
    // the step) of tile rows r0 + 32 i; those rows share r0 % 8, so the
    // chunk's swizzled place in the row is one constant.
    const int j = tid & 7, r0 = tid >> 3;
    const uint32_t chunk_off = r0 * 128 + ((j ^ (r0 & 7)) << 4);
    auto load_stage = [&](int slot, int ks) {
        const int k = ks * BK + j * 16;
        const bool k_ok = k < Kp;
        const uint32_t sa = base + slot * STAGE_BYTES + chunk_off;
#pragma unroll
        for (int i = 0; i < BM / 32; ++i) {
            const int m = m0 + r0 + 32 * i;
            const bool ok = k_ok && m < M;
            cp_async16(sa + i * 32 * 128, ok ? p.xq + (size_t)m * Kp + k : p.xq, ok);
        }
#pragma unroll
        for (int i = 0; i < BN / 32; ++i) {
            const int n = n0 + r0 + 32 * i;
            const bool ok = k_ok && n < N;
            cp_async16(sa + A_BYTES + i * 32 * 128, ok ? p.wq + (size_t)n * Kp + k : p.wq, ok);
        }
    };

    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const int wg = tid >> 7;

#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
        if (s < nk) load_stage(s, s);
        cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
        cp_async_wait<AHEAD - 1>();      // this thread's copies of stage i have landed
        fence_proxy_async();
        __syncthreads();                 // everyone's have; every wgmma of step i - 1 - LAG is done
        const uint32_t sa = base + (i % STAGES) * STAGE_BYTES;
        const uint64_t da = smem_desc<128>(sa + wg * 64 * 128, 16, 1024);
        const uint64_t db = smem_desc<128>(sa + A_BYTES, 16, 1024);
        wgmma_fence();
        fence_operands(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)   // a 32-byte slice: 2 descriptor units
            Wgmma8<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        fence_operands(acc);
        wgmma_wait<LAG>();               // this warpgroup's products of step i - LAG are done
        // the refill takes the slot step i - 1 - LAG read
        if (i + AHEAD < nk) load_stage((i + AHEAD) % STAGES, i + AHEAD);
        cp_async_commit();
    }
    wgmma_wait<0>();
    fence_operands(acc);

    // Accumulator i: row wg * 64 + warp * 16 + g + 8 * ((i / 2) % 2), column
    // (i / 4) * 8 + 2 * q + i % 2 of the tile. Dequantized in registers,
    // then staged through the ring's shared memory.
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int trow = wg * 64 + warp * 16 + g;
    float sxr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = m0 + trow + 8 * h;
        sxr[h] = row < M ? p.sx[row] : 0.f;
    }
    __syncthreads();                     // every warpgroup is done reading the ring
    float* so = reinterpret_cast<float*>(smem_raw + (base - raw));
    float* sbias = so + BM * LDO;
    const OutT* bias = static_cast<const OutT*>(p.bias);
    for (int c = tid; c < BN; c += THREADS)
        sbias[c] = bias && n0 + c < N ? as_float(bias[n0 + c]) : 0.f;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
        const int col = n0 + jn * 8 + 2 * q;
        const float sw0 = col < N ? p.sw[col] : 0.f;
        const float sw1 = col + 1 < N ? p.sw[col + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float v0 = __fmul_rn(__int2float_rn(acc[jn * 4 + 2 * h]), __fmul_rn(sxr[h], sw0));
            const float v1 =
                __fmul_rn(__int2float_rn(acc[jn * 4 + 2 * h + 1]), __fmul_rn(sxr[h], sw1));
            *reinterpret_cast<float2*>(so + (trow + 8 * h) * LDO + jn * 8 + 2 * q) =
                make_float2(v0, v1);
        }
    }
    __syncthreads();

    // Along rows: a warp covers 128 contiguous columns, and the residuals of
    // U chunks are loaded before any of them is stored.
    OutT* out = static_cast<OutT*>(p.out);
    const OutT* res = static_cast<const OutT*>(p.res);
    const bool has_b = bias != nullptr, has_r = res != nullptr;
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
            rv[u] = has_r && vec && row < M && col + 4 <= N
                        ? load4(res + (size_t)row * N + col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = tid + (c0 + u) * THREADS, r = c / CPR, cc = (c - r * CPR) * 4;
            const int row = m0 + r, col = n0 + cc;
            if (row >= M || col >= N) continue;
            const float4 v = *reinterpret_cast<const float4*>(so + r * LDO + cc);
            const float4 b = *reinterpret_cast<const float4*>(sbias + cc);
            if (vec && col + 4 <= N) {
                store4(out + (size_t)row * N + col,
                       make_float4(finish<OutT>(v.x, b.x, rv[u].x, has_b, has_r),
                                   finish<OutT>(v.y, b.y, rv[u].y, has_b, has_r),
                                   finish<OutT>(v.z, b.z, rv[u].z, has_b, has_r),
                                   finish<OutT>(v.w, b.w, rv[u].w, has_b, has_r)));
            } else {                     // N % 4 != 0: one column at a time
                const float vs[4] = {v.x, v.y, v.z, v.w}, bs[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    if (col + e >= N) break;
                    const size_t at = (size_t)row * N + col + e;
                    store1(out + at,
                           finish<OutT>(vs[e], bs[e], has_r ? as_float(res[at]) : 0.f, has_b,
                                        has_r));
                }
            }
        }
    }
}

template <typename T>
int launch_quantize(const void* x, void* q, void* s, int M, int K, cudaStream_t st) {
    const int Kp = (K + CODE_ALIGN - 1) / CODE_ALIGN * CODE_ALIGN;
    const int blocks = (M + Q_THREADS / 32 - 1) / (Q_THREADS / 32);
    quantize_rows_kernel<T><<<blocks, Q_THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), M, K, Kp);
    return static_cast<int>(cudaGetLastError());
}

template <class T, typename OutT>
int launch_gemm(const Int8Params& p, cudaStream_t s) {
    auto kern = int8_gemm_kernel<T, OutT>;
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
    dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
    kern<<<grid, THREADS, T::SMEM, s>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hcp

// Kernel K: x [M, K] row-major (bf16, or fp32 when x_f32 != 0), 16-byte
// aligned, K % 8 == 0; writes q [M, Kp] int8 (Kp = ceil(K / 32) * 32,
// zeros past K) and s [M] fp32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for M < 1 or such a K.
extern "C" int hcp_quantize_rows(const void* x, void* q, void* s, int M, int K, int x_f32,
                                 void* stream) {
    using namespace hcp;
    if (M < 1 || K < 8 || K % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return x_f32 ? launch_quantize<float>(x, q, s, M, K, st)
                 : launch_quantize<bf16>(x, q, s, M, K, st);
}

// Kernel L: xq [M, Kp] and wq [N, Kp] int8 codes (K's output), sx [M] and
// sw [N] fp32 scales; bias [N] or null, res [M, N] or null and out [M, N]:
// bf16, or fp32 when out_f32 != 0. All row-major, 16-byte aligned; Kp % 32
// == 0, N % 2 == 0; minb names a tile of HCP_INT8_TILES. Returns
// cudaGetLastError(), or the error of setting the kernel's shared memory
// size, or cudaErrorInvalidValue for such arguments or another minb.
extern "C" int hcp_int8_gemm(const void* xq, const void* wq, const void* sx, const void* sw,
                             const void* bias, const void* res, void* out, int M, int N, int Kp,
                             int minb, int out_f32, void* stream) {
    using namespace hcp;
    if (M < 1 || N < 2 || N % 2 != 0 || Kp < CODE_ALIGN || Kp % CODE_ALIGN != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    Int8Params p;
    p.xq = static_cast<const int8_t*>(xq);
    p.wq = static_cast<const int8_t*>(wq);
    p.sx = static_cast<const float*>(sx);
    p.sw = static_cast<const float*>(sw);
    p.bias = bias;
    p.res = res;
    p.out = out;
    p.M = M;
    p.N = N;
    p.Kp = Kp;
    p.ksteps = (Kp + BK - 1) / BK;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HCP_INT8_CASE(S_, MINB_)                                                    \
    if (minb == MINB_)                                                              \
        return out_f32 ? launch_gemm<Tile<S_, MINB_>, float>(p, s)                  \
                       : launch_gemm<Tile<S_, MINB_>, bf16>(p, s);
    HCP_INT8_TILES(HCP_INT8_CASE)
#undef HCP_INT8_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
