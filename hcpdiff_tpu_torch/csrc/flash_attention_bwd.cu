// Kernels E and F: the attention backward, dQ (E) and dK/dV (F), from bf16
// q, k, v, dO [B, H, S, D] given by strides, the forward's fp32 row
// logsumexp lse [B, H, Sq] (natural log, kernel A writes it) and
// delta = rowsum(dO * O) [B, H, Sq] in fp32 (the wrapper computes it).
//
// Replace hcpdiff_tpu/ops/flash_attention.py:_flash_bwd_dq_kernel_tq (:780)
// and _flash_bwd_dkv_kernel_tq (:834), driven by _flash_backward_tq (:898):
// the UNet's D=40/80 self-attention gradient under the JAX defaults.
//
// What bounds them on the H100: the [Sq, Sk] probabilities would be 64 MB
// per head in fp32 at S=4096, so the plain backward is bound by device
// memory traffic; recomputed on chip, each kernel does 3 (E) or 4 (F)
// S*S*D products per head over O(S*D) bytes, far above the ridge, so the
// tensor cores and the exp bound them. Both recompute P = exp(S*scale - lse)
// in fp32 registers from a Q K^T tile, as the TPU kernels do.
//
// Design, as the JAX package splits it: two kernels and no atomics, so the
// gradients are deterministic. E grids over (query block, B*H) and loops
// over key tiles: dP = dO V^T, dS = P * (dP - delta) * scale, dQ += dS K.
// F grids over (key block, B*H) and loops over query tiles, computing the
// transposed tiles S^T = K Q^T and dP^T = V dO^T so that each warp owns 16
// keys: dV += P^T dO and dK += dS^T Q accumulate in fp32 registers. P and
// dS feed the second product straight from the accumulator fragments
// (rounded to bf16), as P does in kernel A. The operands of the second
// products are needed [d][k]-major (K for E, Q and dO for F): the loading
// threads store them transposed into shared memory, as A does for V.
//
// The TPU forward's no-max clamp has no counterpart: A's running max is
// exact, so P needs no clamp and dS no mask.
//
// Head dims: D is zero-padded to DP = 48 or 80 inside the shared tiles;
// pad columns are never stored. F holds 2 x 16 x DP fp32 accumulators per
// warp (DP registers a thread), so larger DP is not instantiated.
//
// Simple first version: mma.sync m16n8k16, 64 x 64 tiles, single-buffered
// cp.async, no wgmma/TMA.
#include <math.h>

#include "common.cuh"

namespace hcp {
namespace {

constexpr int BQ = 64;           // query rows per tile
constexpr int BKV = 64;          // keys per tile
constexpr int THREADS = 128;     // 4 warps x 16 rows
constexpr int LDT = 64 + 8;      // padded row of a transposed [DP][64] tile
constexpr float LOG2E = 1.4426950408889634f;

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

// The same rows stored transposed, [DP][LDT]: element (r, d) at d * LDT + r.
template <int DP>
__device__ __forceinline__ void load_rows_t(bf16* s, const bf16* g, long long ss, int r0,
                                            int S, int D, int rows, int tid) {
    for (int c = tid; c < rows * (DP / 8); c += THREADS) {
        int r = c / (DP / 8), d = (c % (DP / 8)) * 8;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < S && d < D) raw = *reinterpret_cast<const uint4*>(g + (r0 + r) * ss + d);
        const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[(d + i) * LDT + r] = e8[i];
    }
}

// acc[16 x 64] = A[16 rows at r0][DP] * B[64 rows][DP]^T, both row-major in
// shared memory with row length LD.
template <int DP>
__device__ __forceinline__ void tile_abt(float (&acc)[8][4], const bf16* a, const bf16* b,
                                         int r0, int g, int t) {
    constexpr int LD = DP + 8;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
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

// out[16 x DP] += X[16 x 64] * Y[64 x DP], X given as accumulator fragments
// (fragments of n-tiles 2j, 2j+1 are the A fragment of k-block j) and Y
// stored transposed in shared memory, [DP][LDT].
template <int DP>
__device__ __forceinline__ void tile_xy(float (&out)[DP / 8][4], const float (&x)[8][4],
                                        const bf16* yt, int g, int t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        uint32_t xa[4];
        xa[0] = pack_bf16x2(x[2 * j][0], x[2 * j][1]);
        xa[1] = pack_bf16x2(x[2 * j][2], x[2 * j][3]);
        xa[2] = pack_bf16x2(x[2 * j + 1][0], x[2 * j + 1][1]);
        xa[3] = pack_bf16x2(x[2 * j + 1][2], x[2 * j + 1][3]);
#pragma unroll
        for (int nd = 0; nd < DP / 8; ++nd) {
            uint32_t yb[2];
            load_b(yb, yt, LDT, nd * 8, j * 16, g, t);
            mma_16816(out[nd], xa, yb);
        }
    }
}

// Store a warp's [16 x DP] fp32 accumulator as bf16 rows r0.. (< S, < D).
template <int DP>
__device__ __forceinline__ void store_rows(bf16* gdst, long long ss, const float (&acc)[DP / 8][4],
                                           int r0, int S, int D, int g, int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        int row = r0 + g + r * 8;
        if (row >= S) continue;
#pragma unroll
        for (int nd = 0; nd < DP / 8; ++nd) {
            int d = nd * 8 + 2 * t;
            if (d < D) store_bf16x2(gdst + row * ss + d, acc[nd][2 * r], acc[nd][2 * r + 1]);
        }
    }
}

template <int DP>
constexpr int dq_smem_bytes() {
    return (4 * 64 * (DP + 8) + DP * LDT) * 2;
}

template <int DP>
constexpr int dkv_smem_bytes() {
    return (4 * 64 * (DP + 8) + 2 * DP * LDT) * 2 + 2 * BQ * 4;
}

// Kernel E. grid (ceil(Sq / BQ), B * H); st holds the (batch, head, seq)
// strides of q, k, v, dO, dQ (15 values).
template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Sq, int Sk, int D, Strides15 st,
                    float scale) {
    constexpr int LD = DP + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sdO = sQ + BQ * LD;
    bf16* sK = sdO + BQ * LD;
    bf16* sV = sK + BKV * LD;
    bf16* sKt = sV + BKV * LD;        // [DP][LDT]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    const int q0 = blockIdx.x * BQ;
    const bf16* qb = q + b * st.v[0] + h * st.v[1];
    const bf16* kb = k + b * st.v[3] + h * st.v[4];
    const bf16* vb = v + b * st.v[6] + h * st.v[7];
    const bf16* ob = dout + b * st.v[9] + h * st.v[10];
    bf16* dqb = dq + b * st.v[12] + h * st.v[13];

    load_rows<DP>(sQ, qb, st.v[2], q0, Sq, D, BQ, tid);
    load_rows<DP>(sdO, ob, st.v[11], q0, Sq, D, BQ, tid);
    cp_async_commit();

    // lse (in log2 units) and delta of this thread's rows g and g+8
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        int row = q0 + warp * 16 + g + r * 8;
        bool ok = row < Sq;
        lse2[r] = ok ? lse[static_cast<long long>(bh) * Sq + row] * LOG2E : 0.f;
        dl[r] = ok ? delta[static_cast<long long>(bh) * Sq + row] : 0.f;
    }
    const float scale_log2 = scale * LOG2E;

    float acc[DP / 8][4];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    const int nkt = (Sk + BKV - 1) / BKV;
    for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * BKV;
        __syncthreads();              // previous tile fully consumed
        load_rows<DP>(sK, kb, st.v[5], k0, Sk, D, BKV, tid);
        load_rows<DP>(sV, vb, st.v[8], k0, Sk, D, BKV, tid);
        cp_async_commit();
        load_rows_t<DP>(sKt, kb, st.v[5], k0, Sk, D, BKV, tid);
        cp_async_wait<0>();
        __syncthreads();

        float s[8][4], dp[8][4];
        tile_abt<DP>(s, sQ, sK, warp * 16, g, t);     // S = Q K^T
        tile_abt<DP>(dp, sdO, sV, warp * 16, g, t);   // dP = dO V^T
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int key = k0 + ni * 8 + 2 * t + (e & 1);
                int r = e >> 1;
                float p = key < Sk ? exp2f(s[ni][e] * scale_log2 - lse2[r]) : 0.f;
                s[ni][e] = p * (dp[ni][e] - dl[r]) * scale;  // dS
            }
        tile_xy<DP>(acc, s, sKt, g, t);                // dQ += dS K
    }
    store_rows<DP>(dqb, st.v[14], acc, q0 + warp * 16, Sq, D, g, t);
}

// Kernel F. grid (ceil(Sk / BKV), B * H); st holds the (batch, head, seq)
// strides of q, k, v, dO, dK, dV (18 values).
template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk,
                     int D, Strides18 st, float scale) {
    constexpr int LD = DP + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sK = reinterpret_cast<bf16*>(smem_raw);
    bf16* sV = sK + BKV * LD;
    bf16* sQ = sV + BKV * LD;
    bf16* sdO = sQ + BQ * LD;
    bf16* sQt = sdO + BQ * LD;        // [DP][LDT]
    bf16* sdOt = sQt + DP * LDT;      // [DP][LDT]
    float* sL = reinterpret_cast<float*>(sdOt + DP * LDT);   // [BQ] lse, log2 units
    float* sDl = sL + BQ;                                      // [BQ] delta

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    const int k0 = blockIdx.x * BKV;
    const bf16* qb = q + b * st.v[0] + h * st.v[1];
    const bf16* kb = k + b * st.v[3] + h * st.v[4];
    const bf16* vb = v + b * st.v[6] + h * st.v[7];
    const bf16* ob = dout + b * st.v[9] + h * st.v[10];
    bf16* dkb = dk + b * st.v[12] + h * st.v[13];
    bf16* dvb = dv + b * st.v[15] + h * st.v[16];
    const float* lseb = lse + static_cast<long long>(bh) * Sq;
    const float* dlb = delta + static_cast<long long>(bh) * Sq;

    load_rows<DP>(sK, kb, st.v[5], k0, Sk, D, BKV, tid);
    load_rows<DP>(sV, vb, st.v[8], k0, Sk, D, BKV, tid);
    cp_async_commit();
    const float scale_log2 = scale * LOG2E;

    float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

    const int nqt = (Sq + BQ - 1) / BQ;
    for (int it = 0; it < nqt; ++it) {
        const int q0 = it * BQ;
        __syncthreads();              // previous tile fully consumed
        load_rows<DP>(sQ, qb, st.v[2], q0, Sq, D, BQ, tid);
        load_rows<DP>(sdO, ob, st.v[11], q0, Sq, D, BQ, tid);
        cp_async_commit();
        load_rows_t<DP>(sQt, qb, st.v[2], q0, Sq, D, BQ, tid);
        load_rows_t<DP>(sdOt, ob, st.v[11], q0, Sq, D, BQ, tid);
        for (int i = tid; i < BQ; i += THREADS) {
            bool ok = q0 + i < Sq;
            sL[i] = ok ? lseb[q0 + i] * LOG2E : 0.f;
            sDl[i] = ok ? dlb[q0 + i] : 0.f;
        }
        cp_async_wait<0>();
        __syncthreads();

        float s[8][4], dp[8][4];
        tile_abt<DP>(s, sK, sQ, warp * 16, g, t);     // S^T = K Q^T
        tile_abt<DP>(dp, sV, sdO, warp * 16, g, t);   // dP^T = V dO^T
        float ds[8][4];
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int qi = ni * 8 + 2 * t + (e & 1);
                float p = q0 + qi < Sq ? exp2f(s[ni][e] * scale_log2 - sL[qi]) : 0.f;
                s[ni][e] = p;                                   // P^T
                ds[ni][e] = p * (dp[ni][e] - sDl[qi]) * scale;  // dS^T
            }
        tile_xy<DP>(dva, s, sdOt, g, t);               // dV += P^T dO
        tile_xy<DP>(dka, ds, sQt, g, t);               // dK += dS^T Q
    }
    store_rows<DP>(dkb, st.v[14], dka, k0 + warp * 16, Sk, D, g, t);
    store_rows<DP>(dvb, st.v[17], dva, k0 + warp * 16, Sk, D, g, t);
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int H, int Sq, int Sk, int D,
              const long long* strides, float scale, cudaStream_t s) {
    constexpr int smem = dq_smem_bytes<DP>();
    auto kern = flash_bwd_dq_kernel<DP>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Strides15 st;
    for (int i = 0; i < 15; ++i) st.v[i] = strides[i];
    dim3 grid((Sq + BQ - 1) / BQ, B * H);
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), H, Sq, Sk, D, st,
        scale);
    return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
               const long long* strides, float scale, cudaStream_t s) {
    constexpr int smem = dkv_smem_bytes<DP>();
    auto kern = flash_bwd_dkv_kernel<DP>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Strides18 st;
    for (int i = 0; i < 18; ++i) st.v[i] = strides[i];
    dim3 grid((Sk + BKV - 1) / BKV, B * H);
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, Sq, Sk, D, st, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hcp

// q [B,H,Sq,D], k/v [B,H,Sk,D], dout and dq [B,H,Sq,D]: bf16 with unit
// stride on D, 16-byte aligned rows; `strides` holds (batch, head, seq)
// strides in elements for q, k, v, dout, dq (15 values). lse and delta are
// contiguous fp32 [B, H, Sq]. D % 8 == 0 and D <= 80. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported D.
extern "C" int hcp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int B, int H,
                                int Sq, int Sk, int D, const long long* strides, float scale,
                                void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    switch ((D + 15) / 16 * 16) {
        case 48: return launch_dq<48>(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D, strides, scale, s);
        case 80: return launch_dq<80>(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D, strides, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// As hcp_flash_bwd_dq, writing dk and dv [B,H,Sk,D]; `strides` holds the
// (batch, head, seq) strides of q, k, v, dout, dk, dv (18 values).
extern "C" int hcp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int B,
                                 int H, int Sq, int Sk, int D, const long long* strides,
                                 float scale, void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    switch ((D + 15) / 16 * 16) {
        case 48:
            return launch_dkv<48>(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, D, strides, scale,
                                  s);
        case 80:
            return launch_dkv<80>(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, D, strides, scale,
                                  s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
