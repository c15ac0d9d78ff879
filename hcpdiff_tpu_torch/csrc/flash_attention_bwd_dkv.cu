// Kernel F: the attention backward's dK and dV (see flash_attention_bwd.cuh
// for what it replaces, what bounds it and its design).
#include "flash_attention_bwd.cuh"

namespace hcp {
namespace {

template <int DP, int DVC>
constexpr int dkv_smem_bytes() {
    return (4 * 64 * (DP + 8) + 2 * DVC * LDT) * 2 + 2 * BQ * 4;
}

// Kernel F. grid (ceil(Sk / BKV), B * H, DP / DVC): block z writes the
// output columns [z * DVC, (z + 1) * DVC); st holds the (batch, head, seq)
// strides of q, k, v, dO, dK, dV (18 values).
template <int DP, int DVC, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     void* __restrict__ dk, void* __restrict__ dv, int H, int Sq, int Sk,
                     int D, Strides18 st, float scale, int out_f32) {
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
    store_rows<DVC>(dk, b * st.v[12] + h * st.v[13], st.v[14], dka, k0 + warp * 16, Sk, D, dc0,
                    g, t, out_f32);
    store_rows<DVC>(dv, b * st.v[15] + h * st.v[16], st.v[17], dva, k0 + warp * 16, Sk, D, dc0,
                    g, t, out_f32);
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

template <int DP, int DVC>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
               const long long* strides, float scale, int causal, int out_f32,
               cudaStream_t s) {
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
        static_cast<const bf16*>(dout), lse, delta, dk, dv, H, Sq, Sk, D, st, scale, out_f32);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hcp

// As hcp_flash_bwd_dq, writing dk and dv [B,H,Sk,D] (bf16, or fp32 when
// out_f32 != 0); `strides` holds the
// (batch, head, seq) strides of q, k, v, dout, dk, dv (18 values).
extern "C" int hcp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int B,
                                 int H, int Sq, int Sk, int D, const long long* strides,
                                 float scale, int causal, int out_f32, void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
#define HCP_DKV(DP, DVC) \
    launch_dkv<DP, DVC>(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, D, strides, scale, causal, out_f32, s)
    switch ((D + 15) / 16 * 16) {
        case 48: return HCP_DKV(48, 48);
        case 64: return HCP_DKV(64, 64);
        case 80: return HCP_DKV(80, 80);
        case 128: return HCP_DKV(128, 64);
        case 160: return HCP_DKV(160, 80);
        case 512:
            return launch_dkv_chunked<512, 128, 64>(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk,
                                                    D, strides, scale, causal, out_f32, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef HCP_DKV
}
