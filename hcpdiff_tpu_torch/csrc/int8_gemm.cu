// Kernels K (quantize_rows) and L (int8_dense, int8_geglu_dense): dynamic
// w8a8 int8 dense layers, y = dequant(q(x) q(w)^T) (+ bias) (+ res) with x
// [M, K] and w [N, K] (nn.Linear layout), and the GEGLU layer
// y = v * gelu(g) over the halves [v | g] of such a product.
//   K  per-row symmetric int8: s[m] = max(amax(x[m, :]), 1e-12) / 127 and
//      codes rint(x / s) clipped to +-127, for an activation [M, K] and a
//      weight [N, K] alike (the weight's rows are its output channels)
//   L  acc = codes_x codes_w^T in int32 (wgmma m64n160k32.s32.s8.s8), then
//      out = T(float(acc) * (sx[m] * sw[n])), out = T(out + bias[n]),
//      out = T(out + res[m, n]), T the rounding to the output type. The
//      GEGLU L (geglu != 0, w = [Wv; Wg], N = 2 Nout, no res) forms v and
//      g as the two biased outputs of columns n and Nout + n and writes
//      T(v * T(gelu_erf(g))), gelu_erf(g) = (g * 0.5) * (1 + erf(g / sqrt 2))
//      as PyTorch's exact F.gelu computes it in fp32.
//
// Replaces no Pallas kernel: hcpdiff_tpu/ops/int8.py leaves the int8 dot,
// the quantizers and the dequantizing epilogue to XLA, and the JAX UNet's
// GEGLU gate is an XLA elementwise op fused into that dequantization
// (hcpdiff_tpu/models/unet.py:463). On Hopper the int8 product needs a
// kernel of its own: int8 wgmma runs at twice the bf16 rate (1979 dense
// TOPS), and the dequantizing epilogue and the gate stay on chip.
//
// Arithmetic, bit for bit the plain versions' (ops/int8.py): the amax is
// exact in any order; the scale and the codes use IEEE division (the build
// has no --use_fast_math) and rintf (round half to even, as torch.round and
// jnp.round); the int32 sum is exact; cvt.rn.f32.s32 (__int2float_rn)
// rounds it as the plain version's .float() does, and the epilogue's
// products and sums are __fmul_rn / __fadd_rn, never contracted into an FMA;
// the gate's erff is the CUDA math library's, as PyTorch's gelu kernel's.
//
// What bounds them on the H100: K reads its input twice (once for the
// amax, once for the codes; the second read mostly from L1/L2) and writes a
// quarter (bf16: half) of it: bytes. L at the UNet's shapes (M = 2b * S up
// to 32768, K 320..5120, N 320..10240) is bound by its output's bytes where
// K is small (ff.proj at level 0 writes 168 MB of bf16 unfused, 84 MB through
// the GEGLU L, against 0.027 ms of int8 operations) and by operations where K
// is large (ff.out at levels 1-2). Past those bounds: at K = 320 the tiles'
// operand loads from L2 (each x tile once for every column tile, each w tile
// once for every row tile: 369 MB at ff.proj level 0) take longer than the
// products; the epilogue's conversions and roundings (and the GEGLU L's
// erff, ~30 instructions an output) are issue-bound on the SM's ALUs.
//
// Design of K: one warp a row, 16-byte loads of 8 values, a warp-shuffle
// max, then the codes of 8 values as one 8-byte store; the code rows are
// zero-padded from K to Kp = ceil(K / 32) * 32, so the codes' rows stay
// 16-byte aligned for the tensor maps and the zeros leave the amax and the
// dot unchanged. ops/int8.py:weight_codes keeps a weight's codes between
// calls, so K runs on a weight once per version of its values.
//
// Design of L: one persistent block an SM (512 threads, 227 KB of shared
// memory) walks the output tiles (BM x BN = 128 x 160 products: 160
// columns, or 80 through the GEGLU gate; tile t is row block t / tiles_n,
// column block t % tiles_n) in steps of the grid. Its warps:
//   - the producer (warp 15): one thread issues TMA loads
//     (cp.async.bulk.tensor.2d, 2-D tensor maps over the codes [M, Kp] and
//     [N, Kp] with the 128-byte swizzle wgmma.cuh's descriptors assume) of a
//     K step, 128 channels: the x codes' 128 rows and two 80-row boxes of w
//     codes (unfused: rows n0 and n0 + 80; GEGLU: value rows n0 and gate rows
//     Nout + n0, the layout gemm_wgmma.cu's B has), into a ring of STAGES
//     slots, each with a full and an empty mbarrier. TMA zero-fills rows past
//     M or N and channels past Kp. It runs ahead into the next tile.
//   - two MMA warpgroups (warps 0-7), 64 rows each: m64n160k32 int32
//     products over each slot, one wgmma group kept in flight; a warp
//     releases a slot (lane 0 arrives on its empty barrier, 8 arrivals) once
//     the products that read it are done. At a tile's end they write the
//     int32 accumulators into a shared buffer of their own (apart from the
//     ring; 16-byte chunks XOR-swizzled by row) once the epilogue has
//     released it, signal it on an mbarrier and go on to the next tile.
//   - the epilogue (warps 8-14): while the products of tile t + 1 run, it
//     converts, scales, biases (GEGLU: gates) and rounds tile t's
//     accumulators along rows, a thread owning 8 columns (GEGLU: 4 outputs
//     of value and gate) of every 11th row, and stores them with 16-byte
//     (GEGLU: 8-byte) stores. The tile's scales and biases are staged in
//     shared memory, and a bf16 residual loaded into registers, before the
//     accumulators are ready. Its arithmetic has no branches (a missing
//     bias is 0, which changes nothing), and rounds pairs to bf16 with one
//     cvt.rn.bf16x2.f32, so that the conversions do not bound it.
// The 512 threads leave 128 registers a thread: the MMA warps' 80
// accumulators fit, and setmaxnreg is not needed.
// Not yet: split-K for short grids (the cross-attention's k and v on the
// context, 10-40 tiles for 132 SMs, stay slower than torch._int_mm); TMA
// multicast of a w tile to a cluster's blocks (halves its L2 reads);
// folding the activation's quantization (K) into this launch.
//
// Types: the quantizer reads bf16 or fp32 (x_f32); L's bias, res and output
// are OutT: bf16, or fp32 for an fp32 call. The build links no libcuda:
// cuTensorMapEncodeTiled comes from the runtime's cudaGetDriverEntryPoint.
#include "wgmma.cuh"

#include <cuda.h>   // CUtensorMap and its enums; no driver library is linked
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
constexpr int BM = 128;               // rows a tile: two MMA warpgroups of 64
constexpr int BN = 160;               // weight rows a tile: two boxes of HALF
constexpr int HALF = BN / 2;          // rows of one w box; the GEGLU tile's columns
constexpr int BK = 128;               // channels a K step: one 128-byte swizzled row
constexpr int STAGES = 4;             // ring slots
// warps 0-7: two MMA warpgroups; 8-14: the epilogue; 15: the producer. At 512
// threads ptxas gives each 128 registers (wgmma's 80 accumulators fit).
constexpr int EPI_THREADS = 224;
constexpr int THREADS = 256 + EPI_THREADS + 32;
static_assert(THREADS == 512 && EPI_THREADS >= BN, "one staged parameter a thread");
constexpr int A_BYTES = BM * BK;
constexpr int STAGE_BYTES = A_BYTES + BN * BK;
constexpr int RING = STAGES * STAGE_BYTES;
constexpr int ACC_BYTES = BM * BN * 4;               // a tile's int32 accumulators
constexpr int PARAMS = RING + ACC_BYTES;             // a tile's sx [BM], sw [BN], bias [BN]
constexpr int BARS = PARAMS + (BM + 2 * BN) * 4;     // 2 * STAGES + 2 mbarriers
constexpr int SMEM = BARS + (2 * STAGES + 2) * 8 + 1024;   // + the base's alignment
static_assert(STAGE_BYTES % 1024 == 0 && (HALF * BK) % 1024 == 0,
              "slots and boxes keep the swizzle's 1024-byte period");
static_assert(SMEM <= 232448, "the ring and the accumulator buffer do not fit a block");

struct Int8Params {
    const float* sx;        // [M]
    const float* sw;        // [N]
    const void* bias;       // [N] or null   (output type)
    const void* res;        // [M, Nout] or null (output type; unfused only)
    void* out;              // [M, Nout]      (output type)
    int M, Nout, Kp, ksteps, tiles_n, tiles;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// The box at (c0, c1) (channel, row) of a 2-D tensor map into shared memory
// at dst, counted in bytes on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// The epilogue works on units of W outputs of a row (8, or 4 for the GEGLU
// L, whose gate takes more registers): W / 4 accumulator chunks.

// T, the rounding to OutT, of a unit's values in place. bf16: paired
// conversions (cvt.rn.bf16x2.f32) and bit moves back to fp32, rather than
// a conversion each way per value.
template <typename OutT, int W>
__device__ __forceinline__ void round_unit(float (&v)[W]) {
    if constexpr (sizeof(OutT) == 2) {
#pragma unroll
        for (int i = 0; i < W; i += 2) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(v[i], v[i + 1]);   // .x low, .y high
            const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
            v[i] = __uint_as_float(u << 16);
            v[i + 1] = __uint_as_float(u & 0xffff0000u);
        }
    }
}

// v = T(T(float(acc) * (sx * sw)) + b). Without a bias b is 0, and adding
// it changes nothing: T(acc * s) is never -0 (s > 0), and T of a value of
// type T is the value. So the code has no branch.
template <typename OutT, int W>
__device__ __forceinline__ void dequant_unit(const int4 (&acc)[W / 4], float sx,
                                             const float (&sw)[W], const float (&b)[W],
                                             float (&v)[W]) {
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
        const int a[4] = {acc[h].x, acc[h].y, acc[h].z, acc[h].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
            v[4 * h + e] = __fmul_rn(__int2float_rn(a[e]), __fmul_rn(sx, sw[4 * h + e]));
    }
    round_unit<OutT>(v);
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = __fadd_rn(v[e], b[e]);
    round_unit<OutT>(v);
}

// v = T(v * T(gelu(g))), PyTorch's exact gelu in fp32: (g * 0.5) * (1 + erf(g * (1 / sqrt 2)))
template <typename OutT, int W>
__device__ __forceinline__ void gate_unit(float (&v)[W], const float (&g)[W]) {
    float e[W];
#pragma unroll
    for (int i = 0; i < W; ++i)
        e[i] = __fmul_rn(__fmul_rn(g[i], 0.5f),
                         __fadd_rn(1.0f, erff(__fmul_rn(g[i], 0.707106781186547524f))));
    round_unit<OutT>(e);
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = __fmul_rn(v[i], e[i]);
    round_unit<OutT>(v);
}

// Read-only loads (ld.global.nc) of one value, and of the first n (<= W)
// of a unit's values at p, zeros past them: 16-byte loads where all W are
// there and aligned (16 bytes at least).
__device__ __forceinline__ float ldg1(const bf16* p) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __bfloat162float(__ushort_as_bfloat16(u));
}
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }

template <int W, typename T>
__device__ __forceinline__ bool whole_unit(const T* p, int n) {
    return n >= W && W * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a bf16 value's fp32 bits: its 16 bits in the high half
__device__ __forceinline__ void unpack_bf16x8(const uint4 u, float (&v)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}

template <int W>
__device__ __forceinline__ void ldg_unit(const bf16* p, int n, float (&v)[W]) {
    if constexpr (W == 8) {
        if (whole_unit<W>(p, n)) {
            unpack_bf16x8(__ldg(reinterpret_cast<const uint4*>(p)), v);
            return;
        }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = e < n ? ldg1(p + e) : 0.f;
}
template <int W>
__device__ __forceinline__ void ldg_unit(const float* p, int n, float (&v)[W]) {
    if (whole_unit<W>(p, n)) {
#pragma unroll
        for (int i = 0; i < W; i += 4) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
            v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
        }
    } else {
#pragma unroll
        for (int e = 0; e < W; ++e) v[e] = e < n ? __ldg(p + e) : 0.f;
    }
}

// The first n (<= W) of v to p: one store of W / 2 words (bf16) or 16-byte
// stores (fp32) where all W go and are aligned. (bf16: v holds bf16 values,
// whose bits are the high halves of their fp32 bits.)
template <int W>
__device__ __forceinline__ void store_unit(bf16* p, int n, const float (&v)[W]) {
    if (n >= W && reinterpret_cast<uintptr_t>(p) % (2 * W) == 0) {
        uint32_t w[W / 2];
#pragma unroll
        for (int i = 0; i < W / 2; ++i)
            w[i] = __byte_perm(__float_as_uint(v[2 * i]), __float_as_uint(v[2 * i + 1]), 0x7632);
        if constexpr (W == 8)
            *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
        else
            *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
        for (int e = 0; e < W; ++e)
            if (e < n) p[e] = __float2bfloat16_rn(v[e]);
    }
}
template <int W>
__device__ __forceinline__ void store_unit(float* p, int n, const float (&v)[W]) {
    if (whole_unit<W>(p, n)) {
#pragma unroll
        for (int i = 0; i < W; i += 4)
            *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else {
#pragma unroll
        for (int e = 0; e < W; ++e)
            if (e < n) p[e] = v[e];
    }
}

// The accumulator buffer: row r of the tile's BM x BN int32 products as
// BN / 4 chunks of 16 bytes, chunk c at (c ^ (r % 8)): the MMA warpgroups'
// 8-byte writes (8 rows x 2 chunks a warp) and the epilogue's 16-byte
// reads along a row are both free of bank conflicts.
__device__ __forceinline__ int acc_at(int r, int c) { return r * BN + ((c ^ (r & 7)) << 2); }

// MODE: 0 no residual, 1 a residual, 2 the GEGLU gate
template <typename OutT, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmw, const Int8Params p) {
    constexpr bool GEGLU = MODE == 2, RES = MODE == 1;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t full0 = base + BARS, empty0 = full0 + STAGES * 8;
    const uint32_t acc_full = empty0 + STAGES * 8, acc_empty = acc_full + 8;
    unsigned char* gbase = smem_raw + (base - raw);
    int* accs = reinterpret_cast<int*>(gbase + RING);
    const int tid = threadIdx.x;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);     // the producer's arrival + the boxes' bytes
            mbar_init(empty0 + 8 * s, 8);    // lane 0 of each MMA warp
        }
        mbar_init(acc_full, 256);            // every MMA thread, its accumulators written
        mbar_init(acc_empty, EPI_THREADS);   // every epilogue thread, its reads done
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= 256 + EPI_THREADS) {
        // ---- producer: one thread keeps the ring filled, tile after tile
        if (tid != 256 + EPI_THREADS) return;
        asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tmx))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tmw))
                     : "memory");
        int slot = 0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
            const int mb = t / p.tiles_n, nb = t - mb * p.tiles_n;
            const int r0 = GEGLU ? nb * HALF : nb * BN;
            const int r1 = GEGLU ? p.Nout + nb * HALF : r0 + HALF;
            for (int ks = 0; ks < p.ksteps; ++ks) {
                mbar_wait(empty0 + 8 * slot, phase ^ 1);   // the first pass finds it free
                const uint32_t full = full0 + 8 * slot, sa = base + slot * STAGE_BYTES;
                mbar_expect_tx(full, STAGE_BYTES);
                tma_load(sa, &tmx, ks * BK, mb * BM, full);
                tma_load(sa + A_BYTES, &tmw, ks * BK, r0, full);
                tma_load(sa + A_BYTES + HALF * BK, &tmw, ks * BK, r1, full);
                if (++slot == STAGES) {
                    slot = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    if (tid >= 256) {
        // ---- epilogue: a tile's accumulators, along rows, while the MMA
        // warpgroups run the next tile's products. A unit is W outputs of a
        // row: product columns W c.. (accumulator chunks W / 4 c..; GEGLU:
        // with the gate chunks from HALF / 4 + W / 4 c). Thread et < LANES owns
        // unit c of every RSTEP-th row from r0: its columns' scales and
        // biases sit in registers for the tile, staged first in shared
        // memory (as fp32; GEGLU: the value columns, then the gate columns)
        // with the rows' scales while the products run; a bf16 residual is
        // loaded then too. A row's arithmetic has no branch, so that ptxas
        // interleaves the rows' chains.
        const int et = tid - 256;
        float* sxs = reinterpret_cast<float*>(gbase + PARAMS);
        float* sws = sxs + BM;
        float* bs = sws + BN;
        const OutT* bias = static_cast<const OutT*>(p.bias);
        const OutT* res = static_cast<const OutT*>(p.res);
        OutT* out = static_cast<OutT*>(p.out);
        constexpr int W = GEGLU ? 4 : 8, NCH = W / 4;              // outputs, chunks a unit
        constexpr int CPR = (GEGLU ? HALF : BN) / W;              // units a row
        constexpr int RSTEP = EPI_THREADS / CPR, LANES = RSTEP * CPR;
        constexpr int PASSES = (BM + RSTEP - 1) / RSTEP;          // rows a thread
        constexpr bool KEEP_RES = RES && sizeof(OutT) == 2;      // the residual in registers
        static_assert(!KEEP_RES || W == 8, "a kept residual is 16 bytes a row");
        const int c = et % CPR, r0 = et / CPR;
        int it = 0;
        for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
            const int mb = t / p.tiles_n, nb = t - mb * p.tiles_n;
            const int m0 = mb * BM, n0 = nb * (GEGLU ? HALF : BN);
            const int col = n0 + W * c, n = min(W, p.Nout - col);   // this thread's outputs
            named_sync(1, EPI_THREADS);          // the last tile's parameters are read
            if (et < BM) sxs[et] = m0 + et < p.M ? __ldg(p.sx + m0 + et) : 0.f;
            if (et < BN) {
                // product column et: GEGLU's are value columns, then gate columns
                const int oc = n0 + (GEGLU && et >= HALF ? et - HALF : et);
                const int wn = GEGLU && et >= HALF ? p.Nout + oc : oc;
                const bool ok = oc < p.Nout;
                sws[et] = ok ? __ldg(p.sw + wn) : 0.f;
                bs[et] = ok && bias != nullptr ? ldg1(bias + wn) : 0.f;
            }
            uint4 rraw[KEEP_RES ? PASSES : 1];
            const bool keep =
                KEEP_RES && et < LANES && p.Nout % W == 0 && whole_unit<W>(res + col, n);
            if constexpr (KEEP_RES) {
#pragma unroll
                for (int k = 0; k < PASSES; ++k) {
                    const int r = r0 + k * RSTEP;
                    rraw[k] = keep && r < BM && m0 + r < p.M
                                  ? __ldg(reinterpret_cast<const uint4*>(
                                        res + (size_t)(m0 + r) * p.Nout + col))
                                  : make_uint4(0u, 0u, 0u, 0u);
                }
            }
            named_sync(1, EPI_THREADS);          // this tile's parameters are staged
            float sw[W], b[W], sg[W], bg[W];
#pragma unroll
            for (int e = 0; e < W; ++e) {
                sw[e] = sws[W * c + e];
                b[e] = bs[W * c + e];
                sg[e] = GEGLU ? sws[HALF + W * c + e] : 0.f;
                bg[e] = GEGLU ? bs[HALF + W * c + e] : 0.f;
            }
            mbar_wait(acc_full, it & 1);
            if (et < LANES && n > 0) {
#pragma unroll
                for (int k = 0; k < PASSES; ++k) {
                    // rows past the tile read its last row and store nothing
                    const int r = r0 + k * RSTEP, rr = min(r, BM - 1);
                    int4 av[NCH], gv[NCH];
#pragma unroll
                    for (int h = 0; h < NCH; ++h) {
                        av[h] = *reinterpret_cast<const int4*>(accs + acc_at(rr, NCH * c + h));
                        if (GEGLU)
                            gv[h] = *reinterpret_cast<const int4*>(
                                accs + acc_at(rr, HALF / 4 + NCH * c + h));
                    }
                    float o[W];
                    dequant_unit<OutT>(av, sxs[rr], sw, b, o);
                    if constexpr (GEGLU) {
                        float gate[W];
                        dequant_unit<OutT>(gv, sxs[rr], sg, bg, gate);
                        gate_unit<OutT>(o, gate);
                    } else if constexpr (RES) {
                        float rv[W];
                        if (keep) {
                            if constexpr (KEEP_RES) unpack_bf16x8(rraw[k], rv);
                        } else {
                            ldg_unit(res + (size_t)min(m0 + rr, p.M - 1) * p.Nout + col, n, rv);
                        }
#pragma unroll
                        for (int e = 0; e < W; ++e) o[e] = __fadd_rn(o[e], rv[e]);
                        round_unit<OutT>(o);
                    }
                    if (r < BM && m0 + r < p.M)
                        store_unit(out + (size_t)(m0 + r) * p.Nout + col, n, o);
                }
            }
            mbar_arrive(acc_empty);              // this thread's reads of the buffer are done
        }
        return;
    }

    // ---- MMA warpgroups: 64 rows each of a tile's product. Every K step
    // runs its 4 slices: past Kp the boxes are zeros (TMA's fill), and a
    // conditional wgmma would make ptxas serialize the products.
    const int cw = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    int acc[BN / 2];
    int slot = 0, it = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
        int prev = -1;
        for (int ks = 0; ks < p.ksteps; ++ks) {
            mbar_wait(full0 + 8 * slot, phase);
            const uint32_t sa = base + slot * STAGE_BYTES;
            const uint64_t da = smem_desc<128>(sa + cw * 64 * 128, 16, 1024);
            const uint64_t db = smem_desc<128>(sa + A_BYTES, 16, 1024);
            wgmma_fence();
            fence_operands(acc);
            Wgmma8<BN>::mma(acc, da, db, ks > 0);
#pragma unroll
            for (int kk = 1; kk < BK / 32; ++kk)   // a 32-byte slice: 2 descriptor units
                Wgmma8<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
            wgmma_commit();
            fence_operands(acc);
            wgmma_wait<1>();                     // the products of step ks - 1 are done
            if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
            prev = slot;
            if (++slot == STAGES) {
                slot = 0;
                phase ^= 1;
            }
        }
        wgmma_wait<0>();
        fence_operands(acc);
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);

        // Accumulator i is row warp * 16 + g + 8 * ((i / 2) % 2) of this
        // warpgroup's 64 and column (i / 4) * 8 + 2 * q + i % 2: chunk
        // (i / 4) * 2 + q / 2, 8 bytes at 2 * (q % 2) in it.
        mbar_wait(acc_empty, (it & 1) ^ 1);      // the epilogue is done with the last tile
#pragma unroll
        for (int i = 0; i < BN / 2; i += 2) {
            const int r = cw * 64 + warp * 16 + g + 8 * ((i / 2) % 2);
            *reinterpret_cast<int2*>(accs + acc_at(r, (i / 4) * 2 + q / 2) + 2 * (q & 1)) =
                make_int2(acc[i], acc[i + 1]);
        }
        mbar_arrive(acc_full);
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

// cuTensorMapEncodeTiled through the runtime's driver entry point: the
// build links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* sym = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(sym);
    }
    return fn;
}

// The tensor map of int8 codes [rows, Kp], boxes of BK channels x box_rows
// rows in the 128-byte swizzle, zeros past the edges.
bool code_map(CUtensorMap* map, const void* codes, int rows, int Kp, int box_rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)Kp};
    const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(codes), dims, strides, box,
              elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT, int MODE>
int launch_gemm(const CUtensorMap& tmx, const CUtensorMap& tmw, const Int8Params& p, int blocks,
                cudaStream_t s) {
    auto kern = int8_gemm_kernel<OutT, MODE>;
    // the dynamic shared memory size, set once per device for this instance
    static unsigned set_on = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 32 || !((set_on >> dev) & 1u)) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (dev < 32) set_on |= 1u << dev;
    }
    kern<<<blocks, THREADS, SMEM, s>>>(tmx, tmw, p);
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
// sw [N] fp32 scales; bias [N] or null, res [M, Nout] or null and out [M,
// Nout]: bf16, or fp32 when out_f32 != 0. Nout = N, or N / 2 for the GEGLU
// L (geglu != 0: w = [Wv; Wg], res null). All row-major, 16-byte aligned;
// Kp % 32 == 0, N % 2 == 0. `blocks` persistent blocks (clamped to the
// tiles; ops/int8.py:l_plan gives one an SM). Returns cudaGetLastError(),
// the error of setting the kernel's shared memory size,
// cudaErrorInvalidValue for such arguments, or
// cudaErrorSymbolNotFound when a tensor map cannot be encoded.
extern "C" int hcp_int8_gemm(const void* xq, const void* wq, const void* sx, const void* sw,
                             const void* bias, const void* res, void* out, int M, int N, int Kp,
                             int geglu, int blocks, int out_f32, void* stream) {
    using namespace hcp;
    if (M < 1 || N < 2 || N % 2 != 0 || Kp < CODE_ALIGN || Kp % CODE_ALIGN != 0 || blocks < 1 ||
        (geglu && res != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    Int8Params p;
    p.sx = static_cast<const float*>(sx);
    p.sw = static_cast<const float*>(sw);
    p.bias = bias;
    p.res = res;
    p.out = out;
    p.M = M;
    p.Nout = geglu ? N / 2 : N;
    p.Kp = Kp;
    p.ksteps = (Kp + BK - 1) / BK;
    p.tiles_n = (p.Nout + (geglu ? HALF : BN) - 1) / (geglu ? HALF : BN);
    p.tiles = (M + BM - 1) / BM * p.tiles_n;
    if (blocks > p.tiles) blocks = p.tiles;
    CUtensorMap tmx, tmw;
    if (!code_map(&tmx, xq, M, Kp, BM) || !code_map(&tmw, wq, N, Kp, HALF))
        return static_cast<int>(cudaErrorSymbolNotFound);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (geglu)
        return out_f32 ? launch_gemm<float, 2>(tmx, tmw, p, blocks, s)
                       : launch_gemm<bf16, 2>(tmx, tmw, p, blocks, s);
    if (res != nullptr)
        return out_f32 ? launch_gemm<float, 1>(tmx, tmw, p, blocks, s)
                       : launch_gemm<bf16, 1>(tmx, tmw, p, blocks, s);
    return out_f32 ? launch_gemm<float, 0>(tmx, tmw, p, blocks, s)
                   : launch_gemm<bf16, 0>(tmx, tmw, p, blocks, s);
}
