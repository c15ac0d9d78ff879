// Kernel F: the attention backward's dK and dV (see flash_attention_bwd.cuh
// for what it replaces, what bounds it and its design).
#include "flash_attention_bwd.cuh"

namespace hcp {
namespace {

// F's launch plan per padded head dim DP below 512 (every plan: two
// warpgroups of 64 keys): queries per tile BQ, ring stages, output dims per
// block DVC (DP / DVC blocks over grid.z), swizzle width SW in bytes,
// blocks an SM MINB. dK and dV take DVC fp32 registers a thread, S^T and
// dP^T BQ. Read and checked on the CPU by tests/test_torch_port_flash_plan.py.
//   X(DP, BQ, STAGES, DVC, SW, MINB)
#define HCP_FLASH_DKV_PLANS(X)    \
    X(48, 64, 4, 48, 32, 1)       \
    X(64, 64, 4, 64, 128, 1)      \
    X(80, 64, 4, 80, 32, 1)       \
    X(128, 48, 4, 128, 128, 1)    \
    X(160, 32, 4, 160, 64, 1)

// Kernel F. grid (ceil(Sk / 128), B * H, DP / DVC): block z writes the
// output columns [z * DVC, (z + 1) * DVC); st holds the (batch, head, seq)
// strides of q, k, v, dO, dK, dV (18 values).
template <class P, bool CAUSAL>
__global__ void __launch_bounds__(P::THREADS, P::MINB)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     void* __restrict__ dk, void* __restrict__ dv, int H, int Sq, int Sk,
                     int D, Strides18 st, float scale, int out_f32) {
    constexpr int DP = P::DP, BQ = P::BN, DVC = P::DVC, SW = P::SW, STAGES = P::STAGES;
    constexpr int BM = P::BM, KB = P::W / 16;     // k16 slices in a row of one block
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = smem_addr(smem_raw);
    const uint32_t sK = (base + 1023u) & ~1023u;
    const uint32_t sV = sK + P::RES_BYTES;
    const uint32_t sQO = sV + P::RES_BYTES;       // ring: slot s holds Q, then dO
    const uint32_t sStat = sQO + STAGES * 2 * P::TILE_BYTES;   // [STAGES][lse BQ, delta BQ]
    const float* stat = reinterpret_cast<const float*>(smem_raw + (sStat - base));

    const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    const int k0 = blockIdx.x * BM, key0 = k0 + wg * 64;   // this warpgroup's first key
    const int dc0 = blockIdx.z * DVC;
    const bf16* qb = q + b * st.v[0] + h * st.v[1];
    const bf16* kb = k + b * st.v[3] + h * st.v[4];
    const bf16* vb = v + b * st.v[6] + h * st.v[7];
    const bf16* ob = dout + b * st.v[9] + h * st.v[10];
    const float* lseb = lse + static_cast<long long>(bh) * Sq;
    const float* dlb = delta + static_cast<long long>(bh) * Sq;

    // causal: start at the query tile that holds query k0, this block's
    // first key (the tiles before it hold only queries < k0)
    const int it0 = CAUSAL ? k0 / BQ : 0;
    const int nqt = (Sq + BQ - 1) / BQ - it0;

    auto load_qo = [&](int j) {       // query tile it0 + j, with its lse and delta
        const int slot = j % STAGES, q0 = (it0 + j) * BQ;
        const uint32_t s = sQO + slot * 2 * P::TILE_BYTES;
        load_swizzled<SW, P::THREADS, BQ, DP>(s, qb, st.v[2], q0, Sq, 0, D, tid);
        load_swizzled<SW, P::THREADS, BQ, DP>(s + P::TILE_BYTES, ob, st.v[11], q0, Sq, 0, D,
                                              tid);
        for (int c = tid; c < 2 * BQ; c += P::THREADS) {
            const int i = c % BQ;
            const bool ok = q0 + i < Sq;
            const float* src = c < BQ ? lseb : dlb;
            cp_async4(sStat + (slot * 2 * BQ + c) * 4, ok ? src + q0 + i : src, ok);
        }
    };
    // K and V with tile 0's group
    load_swizzled<SW, P::THREADS, BM, DP>(sK, kb, st.v[5], k0, Sk, 0, D, tid);
    load_swizzled<SW, P::THREADS, BM, DP>(sV, vb, st.v[8], k0, Sk, 0, D, tid);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nqt) load_qo(s);
        cp_async_commit();
    }

    const float scale_log2 = scale * LOG2E;
    int key[2];                        // the keys of rows g, g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) key[r] = key0 + warp * 16 + g + r * 8;

    // this warpgroup's 64 rows of K and V, K-major
    const uint64_t kd = smem_desc<SW>(sK + wg * 64 * SW, 16, 8 * SW);
    const uint64_t vd = smem_desc<SW>(sV + wg * 64 * SW, 16, 8 * SW);
    float dka[DVC / 2], dva[DVC / 2];
#pragma unroll
    for (int i = 0; i < DVC / 2; ++i) dka[i] = dva[i] = 0.f;

    for (int j = 0; j < nqt; ++j) {
        cp_async_wait<STAGES - 2>();   // this thread's copies of tile j have landed
        fence_proxy_async();
        __syncthreads();               // everyone's have; every product of tile j - 1 is done
        if (j + STAGES - 1 < nqt) load_qo(j + STAGES - 1);
        cp_async_commit();
        const int q0 = (it0 + j) * BQ;
        if (CAUSAL && q0 + BQ - 1 < key0) continue;   // every query precedes every key here

        const int slot = j % STAGES;
        const uint32_t sQ = sQO + slot * 2 * P::TILE_BYTES, sdO = sQ + P::TILE_BYTES;
        const uint64_t qd = smem_desc<SW>(sQ, 16, 8 * SW);
        const uint64_t od = smem_desc<SW>(sdO, 16, 8 * SW);
        // Q and dO MN-major (N = this block's DVC output dims, from block dc0 / W)
        const uint64_t qt = smem_desc<SW>(sQ + (dc0 / P::W) * BQ * SW, BQ * SW, 8 * SW);
        const uint64_t ot = smem_desc<SW>(sdO + (dc0 / P::W) * BQ * SW, BQ * SW, 8 * SW);

        // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys x BQ
        // queries, two groups: P^T's exp runs while dP^T is computed
        float s[BQ / 2], dp[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)   // slice kk: block kk / KB, 32 B per slice in it
            Wgmma<BQ>::mma(s, kd + (kk / KB) * (BM * SW / 16) + (kk % KB) * 2,
                           qd + (kk / KB) * (BQ * SW / 16) + (kk % KB) * 2, kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            Wgmma<BQ>::mma(dp, vd + (kk / KB) * (BM * SW / 16) + (kk % KB) * 2,
                           od + (kk / KB) * (BQ * SW / 16) + (kk % KB) * 2, kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_operands(s);

        // P^T, then dS^T / scale, on the accumulators: element i is key row
        // g + 8 * ((i / 2) % 2), query q0 + (i / 4) * 8 + 2t + i % 2
        const float* sl = stat + slot * 2 * BQ;
        const bool masked = q0 + BQ > Sq || (CAUSAL && q0 < key0 + 63);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
            const float2 l2 = *reinterpret_cast<const float2*>(sl + n * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = n * 4 + e, qi = q0 + n * 8 + 2 * t + (e & 1);
                s[i] = fast_exp2(fmaf(s[i], scale_log2, -(e & 1 ? l2.y : l2.x) * LOG2E));
                if (masked && (qi >= Sq || (CAUSAL && qi < key[e >> 1]))) s[i] = 0.f;
            }
        }
        wgmma_wait<0>();
        fence_operands(dp);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
            const float2 d2 = *reinterpret_cast<const float2*>(sl + BQ + n * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = n * 4 + e;
                dp[i] = s[i] * (dp[i] - (e & 1 ? d2.y : d2.x));
            }
        }

        // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers, dO and
        // Q read MN-major (queries 16jj..: 16 rows of SW bytes further)
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        pack_a<BQ>(pa, s);
        pack_a<BQ>(da, dp);
        fence_operands(dva);
        fence_operands(dka);
#pragma unroll
        for (int jj = 0; jj < BQ / 16; ++jj) {
            fence_operands(pa[jj]);
            fence_operands(da[jj]);
        }
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < BQ / 16; ++jj) WgmmaRS<DVC>::mma(dva, pa[jj], ot + jj * SW);
#pragma unroll
        for (int jj = 0; jj < BQ / 16; ++jj) WgmmaRS<DVC>::mma(dka, da[jj], qt + jj * SW);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dva);
        fence_operands(dka);
#pragma unroll
        for (int jj = 0; jj < BQ / 16; ++jj) {
            fence_operands(pa[jj]);
            fence_operands(da[jj]);
        }
    }
    cp_async_wait<0>();
    store_acc<DVC>(dk, b * st.v[12] + h * st.v[13], st.v[14], dka, scale, key0, Sk, dc0, D,
                   warp, g, t, out_f32);
    store_acc<DVC>(dv, b * st.v[15] + h * st.v[16], st.v[17], dva, 1.f, key0, Sk, dc0, D,
                   warp, g, t, out_f32);
}

template <class P>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
           const long long* strides, float scale, int causal, int out_f32, cudaStream_t s) {
    auto kern = causal ? flash_bwd_dkv_kernel<P, true> : flash_bwd_dkv_kernel<P, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    Strides18 st;
    for (int i = 0; i < 18; ++i) st.v[i] = strides[i];
    dim3 grid((Sk + P::BM - 1) / P::BM, B * H, P::DP / P::DVC);
    kern<<<grid, P::THREADS, P::SMEM, s>>>(
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
#define HCP_DKV_CASE(DP, BQ, STAGES, DVC, SW, MINB)                                            \
    case DP:                                                                                   \
        return launch<BwdPlan<DP, BQ, STAGES, DVC, SW, MINB, true>>(                           \
            q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, D, strides, scale, causal, out_f32, s);
    switch ((D + 15) / 16 * 16) {
        HCP_FLASH_DKV_PLANS(HCP_DKV_CASE)
        case 512:
            return flash_bwd_dkv_512(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, D, strides,
                                     scale, causal, out_f32, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef HCP_DKV_CASE
}
