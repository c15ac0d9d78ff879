// Kernel E: the attention backward's dQ (see flash_attention_bwd.cuh for
// what it replaces, what bounds it and its design).
#include "flash_attention_bwd.cuh"

namespace hcp {
namespace {

template <int DP>
constexpr int dq_smem_bytes() {
    return (4 * 64 * (DP + 8) + DP * LDT) * 2;
}

// Kernel E. grid (ceil(Sq / BQ), B * H); st holds the (batch, head, seq)
// strides of q, k, v, dO, dQ (15 values).
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    void* __restrict__ dq, int H, int Sq, int Sk, int D, Strides15 st,
                    float scale, int out_f32) {
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
    store_rows<DP>(dq, b * st.v[12] + h * st.v[13], st.v[14], acc, q0 + warp * 16, Sq, D, 0,
                   g, t, out_f32);
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

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int H, int Sq, int Sk, int D,
              const long long* strides, float scale, int causal, int out_f32,
              cudaStream_t s) {
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
        static_cast<const bf16*>(dout), lse, delta, dq, H, Sq, Sk, D, st, scale, out_f32);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hcp

// q [B,H,Sq,D], k/v [B,H,Sk,D] and dout [B,H,Sq,D]: bf16; dq [B,H,Sq,D]:
// bf16, or fp32 when out_f32 != 0; all with unit stride on D and 16-byte
// aligned rows; `strides` holds (batch, head, seq)
// strides in elements for q, k, v, dout, dq (15 values). lse and delta are
// contiguous fp32 [B, H, Sq]. D % 8 == 0 and D <= 512. `causal` != 0 masks
// keys past each query (top-left aligned; the caller ensures Sq == Sk).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a D whose
// multiple of 16 is not built (48, 64, 80, 128, 160, 512).
extern "C" int hcp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int B, int H,
                                int Sq, int Sk, int D, const long long* strides, float scale,
                                int causal, int out_f32, void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
#define HCP_DQ(DP) \
    launch_dq<DP>(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D, strides, scale, causal, out_f32, s)
    switch ((D + 15) / 16 * 16) {
        case 48: return HCP_DQ(48);
        case 64: return HCP_DQ(64);
        case 80: return HCP_DQ(80);
        case 128: return HCP_DQ(128);
        case 160: return HCP_DQ(160);
        case 512:
            return launch_dq_chunked<512, 128, 128>(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D,
                                                    strides, scale, causal, out_f32, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef HCP_DQ
}

