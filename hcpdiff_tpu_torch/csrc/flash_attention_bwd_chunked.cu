// Kernels E and F at DP=512: the D-chunked mma.sync variants (see
// flash_attention_bwd.cuh). Whole-row tiles of Q, dO, K and V would be
// 4 x 64 x 520 x 2 = 266 KB, past the 227 KB a block may use, so S and dP
// accumulate over DC=128 columns at a time through four [64][DC + 8] shared
// slots (chunked_abt2), and the outputs are split over grid.z (E: DVC=128,
// F: DVC=64, so the accumulators stay in registers); each output chunk
// recomputes S and dP, and every tile is re-read per chunk. The operands of
// the second products are stored transposed by the loading threads
// (load_rows_t). A simple, slow route for head dims no shipped model uses.
#include "flash_attention_bwd.cuh"

namespace hcp {
namespace {

constexpr int BQ = 64;           // query rows per tile
constexpr int BKV = 64;          // keys per tile
constexpr int THREADS = 128;     // 4 warps x 16 rows
constexpr int LDT = 64 + 8;      // padded row of a transposed [DP][64] tile
static_assert(BQ == 64 && BKV == 64, "tile_abt, tile_xy and LDT assume 64 x 64 tiles");

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

// Kernel E at DP=512 (see chunked_abt2): grid (ceil(Sq / BQ), B * H,
// DP / DVC); block z writes the dQ columns [z * DVC, (z + 1) * DVC).
template <int DP, int DC, int DVC>
constexpr int dq_chunked_smem_bytes() {
    return (4 * 64 * (DC + 8) + DVC * LDT) * 2;
}

template <int DP, int DC, int DVC, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_chunked_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            void* __restrict__ dq, int H, int Sq, int Sk, int D, Strides15 st,
                            float scale, int out_f32) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sm = reinterpret_cast<bf16*>(smem_raw);
    bf16* sKt = sm + 4 * 64 * (DC + 8);    // [DVC][LDT]: this block's columns of K

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    const int q0 = blockIdx.x * BQ, dc0 = blockIdx.z * DVC;
    const bf16* qb = q + b * st.v[0] + h * st.v[1];
    const bf16* kb = k + b * st.v[3] + h * st.v[4];
    const bf16* vb = v + b * st.v[6] + h * st.v[7];
    const bf16* ob = dout + b * st.v[9] + h * st.v[10];

    float lse2[2], dl[2];
    int last_key[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        int row = q0 + warp * 16 + g + r * 8;
        bool ok = row < Sq;
        lse2[r] = ok ? lse[static_cast<long long>(bh) * Sq + row] * LOG2E : 0.f;
        dl[r] = ok ? delta[static_cast<long long>(bh) * Sq + row] : 0.f;
        last_key[r] = CAUSAL ? min(Sk - 1, row) : Sk - 1;
    }
    const float scale_log2 = scale * LOG2E;

    float acc[DVC / 8][4];
#pragma unroll
    for (int j = 0; j < DVC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    int nkt = (Sk + BKV - 1) / BKV;
    if (CAUSAL) nkt = min(nkt, (q0 + BQ - 1) / BKV + 1);
    for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * BKV;
        float s[8][4], dp[8][4];
        chunked_abt2<DP, DC>(s, dp, sm, qb, st.v[2], ob, st.v[11], q0, Sq, kb, st.v[5], vb,
                             st.v[8], k0, Sk, D, warp, g, t, tid);   // S = Q K^T, dP = dO V^T
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int key = k0 + ni * 8 + 2 * t + (e & 1);
                int r = e >> 1;
                float p = key <= last_key[r] ? exp2f(s[ni][e] * scale_log2 - lse2[r]) : 0.f;
                s[ni][e] = p * (dp[ni][e] - dl[r]) * scale;  // dS
            }
        // sKt's last reads (the previous tile) precede chunked_abt2's barriers
        load_rows_t<DVC>(sKt, kb, st.v[5], k0, Sk, D, dc0, BKV, tid);
        __syncthreads();
        tile_xy<DVC>(acc, s, sKt, g, t);                // dQ += dS K
    }
    store_rows<DVC>(dq, b * st.v[12] + h * st.v[13], st.v[14], acc, q0 + warp * 16, Sq, D, dc0,
                    g, t, out_f32);
}

template <int DP, int DC, int DVC>
int launch_dq_chunked(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B, int H, int Sq, int Sk,
                      int D, const long long* strides, float scale, int causal, int out_f32,
                      cudaStream_t s) {
    constexpr int smem = dq_chunked_smem_bytes<DP, DC, DVC>();
    auto kern = causal ? flash_bwd_dq_chunked_kernel<DP, DC, DVC, true>
                       : flash_bwd_dq_chunked_kernel<DP, DC, DVC, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Strides15 st;
    for (int i = 0; i < 15; ++i) st.v[i] = strides[i];
    dim3 grid((Sq + BQ - 1) / BQ, B * H, DP / DVC);
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, dq, H, Sq, Sk, D, st, scale, out_f32);
    return static_cast<int>(cudaGetLastError());
}

// Kernel F at DP=512 (see chunked_abt2): grid (ceil(Sk / BKV), B * H,
// DP / DVC); block z writes the dK and dV columns [z * DVC, (z + 1) * DVC).
template <int DP, int DC, int DVC>
constexpr int dkv_chunked_smem_bytes() {
    return (4 * 64 * (DC + 8) + 2 * DVC * LDT) * 2 + 2 * BQ * 4;
}

// (min blocks 1 stated: without it ptxas caps the causal instance at 168
// registers and spills)
template <int DP, int DC, int DVC, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_chunked_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             void* __restrict__ dk, void* __restrict__ dv, int H, int Sq, int Sk,
                             int D, Strides18 st, float scale, int out_f32) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sm = reinterpret_cast<bf16*>(smem_raw);
    bf16* sQt = sm + 4 * 64 * (DC + 8);   // [DVC][LDT]: this block's columns of Q
    bf16* sdOt = sQt + DVC * LDT;         // [DVC][LDT]: and of dO
    float* sL = reinterpret_cast<float*>(sdOt + DVC * LDT);  // [BQ] lse, log2 units
    float* sDl = sL + BQ;                                      // [BQ] delta

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    const int k0 = blockIdx.x * BKV, dc0 = blockIdx.z * DVC;
    const bf16* qb = q + b * st.v[0] + h * st.v[1];
    const bf16* kb = k + b * st.v[3] + h * st.v[4];
    const bf16* vb = v + b * st.v[6] + h * st.v[7];
    const bf16* ob = dout + b * st.v[9] + h * st.v[10];
    const float* lseb = lse + static_cast<long long>(bh) * Sq;
    const float* dlb = delta + static_cast<long long>(bh) * Sq;
    const float scale_log2 = scale * LOG2E;

    float dka[DVC / 8][4], dva[DVC / 8][4];
#pragma unroll
    for (int j = 0; j < DVC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
    const int key0 = k0 + warp * 16 + g;   // the key of this thread's row g (g + 8: key0 + 8)
    const int nqt = (Sq + BQ - 1) / BQ;
    for (int it = CAUSAL ? k0 / BQ : 0; it < nqt; ++it) {
        const int q0 = it * BQ;
        float s[8][4], dp[8][4];
        chunked_abt2<DP, DC>(s, dp, sm, kb, st.v[5], vb, st.v[8], k0, Sk, qb, st.v[2], ob,
                             st.v[11], q0, Sq, D, warp, g, t, tid);   // S^T = K Q^T, dP^T = V dO^T
        // sQt, sdOt, sL and sDl's last reads (the previous tile) precede
        // chunked_abt2's barriers
        load_rows_t<DVC>(sQt, qb, st.v[2], q0, Sq, D, dc0, BQ, tid);
        load_rows_t<DVC>(sdOt, ob, st.v[11], q0, Sq, D, dc0, BQ, tid);
        for (int i = tid; i < BQ; i += THREADS) {
            bool ok = q0 + i < Sq;
            sL[i] = ok ? lseb[q0 + i] * LOG2E : 0.f;
            sDl[i] = ok ? dlb[q0 + i] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int qi = ni * 8 + 2 * t + (e & 1);
                bool live = q0 + qi < Sq && (!CAUSAL || q0 + qi >= key0 + (e >> 1) * 8);
                float p = live ? exp2f(s[ni][e] * scale_log2 - sL[qi]) : 0.f;
                s[ni][e] = p;                                   // P^T
                dp[ni][e] = p * (dp[ni][e] - sDl[qi]) * scale;  // dS^T
            }
        tile_xy<DVC>(dva, s, sdOt, g, t);              // dV += P^T dO
        tile_xy<DVC>(dka, dp, sQt, g, t);              // dK += dS^T Q
    }
    store_rows<DVC>(dk, b * st.v[12] + h * st.v[13], st.v[14], dka, k0 + warp * 16, Sk, D, dc0,
                    g, t, out_f32);
    store_rows<DVC>(dv, b * st.v[15] + h * st.v[16], st.v[17], dva, k0 + warp * 16, Sk, D, dc0,
                    g, t, out_f32);
}

template <int DP, int DC, int DVC>
int launch_dkv_chunked(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                       int Sq, int Sk, int D, const long long* strides, float scale, int causal,
                       int out_f32, cudaStream_t s) {
    constexpr int smem = dkv_chunked_smem_bytes<DP, DC, DVC>();
    auto kern = causal ? flash_bwd_dkv_chunked_kernel<DP, DC, DVC, true>
                       : flash_bwd_dkv_chunked_kernel<DP, DC, DVC, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Strides18 st;
    for (int i = 0; i < 18; ++i) st.v[i] = strides[i];
    dim3 grid((Sk + BKV - 1) / BKV, B * H, DP / DVC);
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, dk, dv, H, Sq, Sk, D, st, scale, out_f32);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash_bwd_dq_512(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int B, int H, int Sq, int Sk,
                     int D, const long long* strides, float scale, int causal, int out_f32,
                     cudaStream_t s) {
    return launch_dq_chunked<512, 128, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D,
                                            strides, scale, causal, out_f32, s);
}

int flash_bwd_dkv_512(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                      int Sq, int Sk, int D, const long long* strides, float scale, int causal,
                      int out_f32, cudaStream_t s) {
    return launch_dkv_chunked<512, 128, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk,
                                            D, strides, scale, causal, out_f32, s);
}

}  // namespace hcp
