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
// Head dims: D is zero-padded to DP = 48, 64, 80, 128 or 160 inside the
// shared tiles; pad columns are never stored. E holds a 16 x DP fp32
// accumulator per warp (DP/2 registers a thread). F holds two (dK and dV),
// which at DP=128 or 160 would pass 255 registers with the S and dP
// fragments, so F's output dims are split into chunks of DVC <= 80 over
// grid.z, as A does for D=512; each chunk recomputes S and dP over the
// whole DP. E at DP=160 takes ~109 KB of shared memory (dynamic, set by
// cudaFuncSetAttribute).
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

// Store a warp's [16 x DC] fp32 accumulator as bf16 rows r0.. (< S) and
// columns d0.. (< D).
template <int DC>
__device__ __forceinline__ void store_rows(bf16* gdst, long long ss, const float (&acc)[DC / 8][4],
                                           int r0, int S, int D, int d0, int g, int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        int row = r0 + g + r * 8;
        if (row >= S) continue;
#pragma unroll
        for (int nd = 0; nd < DC / 8; ++nd) {
            int d = d0 + nd * 8 + 2 * t;
            if (d < D) store_bf16x2(gdst + row * ss + d, acc[nd][2 * r], acc[nd][2 * r + 1]);
        }
    }
}

template <int DP>
constexpr int dq_smem_bytes() {
    return (4 * 64 * (DP + 8) + DP * LDT) * 2;
}

template <int DP, int DVC>
constexpr int dkv_smem_bytes() {
    return (4 * 64 * (DP + 8) + 2 * DVC * LDT) * 2 + 2 * BQ * 4;
}

// Kernel E. grid (ceil(Sq / BQ), B * H); st holds the (batch, head, seq)
// strides of q, k, v, dO, dQ (15 values).
template <int DP, bool CAUSAL>
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

    // lse (in log2 units), delta and the last key of this thread's rows
    // g and g+8
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

    float acc[DP / 8][4];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    int nkt = (Sk + BKV - 1) / BKV;
    if (CAUSAL) nkt = min(nkt, (q0 + BQ - 1) / BKV + 1);   // stop at the diagonal tile
    for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * BKV;
        __syncthreads();              // previous tile fully consumed
        load_rows<DP>(sK, kb, st.v[5], k0, Sk, D, BKV, tid);
        load_rows<DP>(sV, vb, st.v[8], k0, Sk, D, BKV, tid);
        cp_async_commit();
        load_rows_t<DP>(sKt, kb, st.v[5], k0, Sk, D, 0, BKV, tid);
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
                float p = key <= last_key[r] ? exp2f(s[ni][e] * scale_log2 - lse2[r]) : 0.f;
                s[ni][e] = p * (dp[ni][e] - dl[r]) * scale;  // dS
            }
        tile_xy<DP>(acc, s, sKt, g, t);                // dQ += dS K
    }
    store_rows<DP>(dqb, st.v[14], acc, q0 + warp * 16, Sq, D, 0, g, t);
}

// Kernel F. grid (ceil(Sk / BKV), B * H, DP / DVC): block z writes the
// output columns [z * DVC, (z + 1) * DVC); st holds the (batch, head, seq)
// strides of q, k, v, dO, dK, dV (18 values).
template <int DP, int DVC, bool CAUSAL>
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
    bf16* sQt = sdO + BQ * LD;        // [DVC][LDT]: this block's columns of Q
    bf16* sdOt = sQt + DVC * LDT;     // [DVC][LDT]: and of dO
    float* sL = reinterpret_cast<float*>(sdOt + DVC * LDT);  // [BQ] lse, log2 units
    float* sDl = sL + BQ;                                      // [BQ] delta

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    const int k0 = blockIdx.x * BKV;
    const int dc0 = blockIdx.z * DVC;
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

    float dka[DVC / 8][4], dva[DVC / 8][4];
#pragma unroll
    for (int j = 0; j < DVC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

    // the keys of this thread's rows g and g+8; a query before a key is
    // masked under causal
    int key[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) key[r] = CAUSAL ? k0 + warp * 16 + g + r * 8 : 0;
    const int nqt = (Sq + BQ - 1) / BQ;
    // causal: start at the query tile that holds query k0, this block's
    // first key (the tiles before it hold only queries < k0)
    for (int it = CAUSAL ? k0 / BQ : 0; it < nqt; ++it) {
        const int q0 = it * BQ;
        __syncthreads();              // previous tile fully consumed
        load_rows<DP>(sQ, qb, st.v[2], q0, Sq, D, BQ, tid);
        load_rows<DP>(sdO, ob, st.v[11], q0, Sq, D, BQ, tid);
        cp_async_commit();
        load_rows_t<DVC>(sQt, qb, st.v[2], q0, Sq, D, dc0, BQ, tid);
        load_rows_t<DVC>(sdOt, ob, st.v[11], q0, Sq, D, dc0, BQ, tid);
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
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int qi = ni * 8 + 2 * t + (e & 1);
                bool live = q0 + qi < Sq && (!CAUSAL || q0 + qi >= key[e >> 1]);
                float p = live ? exp2f(s[ni][e] * scale_log2 - sL[qi]) : 0.f;
                s[ni][e] = p;                                   // P^T
                dp[ni][e] = p * (dp[ni][e] - sDl[qi]) * scale;  // dS^T
            }
        tile_xy<DVC>(dva, s, sdOt, g, t);              // dV += P^T dO
        tile_xy<DVC>(dka, dp, sQt, g, t);              // dK += dS^T Q
    }
    store_rows<DVC>(dkb, st.v[14], dka, k0 + warp * 16, Sk, D, dc0, g, t);
    store_rows<DVC>(dvb, st.v[17], dva, k0 + warp * 16, Sk, D, dc0, g, t);
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int H, int Sq, int Sk, int D,
              const long long* strides, float scale, int causal, cudaStream_t s) {
    constexpr int smem = dq_smem_bytes<DP>();
    auto kern = causal ? flash_bwd_dq_kernel<DP, true> : flash_bwd_dq_kernel<DP, false>;
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

template <int DP, int DVC>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
               const long long* strides, float scale, int causal, cudaStream_t s) {
    constexpr int smem = dkv_smem_bytes<DP, DVC>();
    auto kern = causal ? flash_bwd_dkv_kernel<DP, DVC, true> : flash_bwd_dkv_kernel<DP, DVC, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Strides18 st;
    for (int i = 0; i < 18; ++i) st.v[i] = strides[i];
    dim3 grid((Sk + BKV - 1) / BKV, B * H, DP / DVC);
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
// contiguous fp32 [B, H, Sq]. D % 8 == 0 and D <= 160. `causal` != 0 masks
// keys past each query (top-left aligned; the caller ensures Sq == Sk).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unsupported D.
extern "C" int hcp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int B, int H,
                                int Sq, int Sk, int D, const long long* strides, float scale,
                                int causal, void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
#define HCP_DQ(DP) \
    launch_dq<DP>(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D, strides, scale, causal, s)
    switch ((D + 15) / 16 * 16) {
        case 48: return HCP_DQ(48);
        case 64: return HCP_DQ(64);
        case 80: return HCP_DQ(80);
        case 128: return HCP_DQ(128);
        case 160: return HCP_DQ(160);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef HCP_DQ
}

// As hcp_flash_bwd_dq, writing dk and dv [B,H,Sk,D]; `strides` holds the
// (batch, head, seq) strides of q, k, v, dout, dk, dv (18 values).
extern "C" int hcp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int B,
                                 int H, int Sq, int Sk, int D, const long long* strides,
                                 float scale, int causal, void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
#define HCP_DKV(DP, DVC) \
    launch_dkv<DP, DVC>(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, D, strides, scale, causal, s)
    switch ((D + 15) / 16 * 16) {
        case 48: return HCP_DKV(48, 48);
        case 64: return HCP_DKV(64, 64);
        case 80: return HCP_DKV(80, 80);
        case 128: return HCP_DKV(128, 64);
        case 160: return HCP_DKV(160, 80);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef HCP_DKV
}
