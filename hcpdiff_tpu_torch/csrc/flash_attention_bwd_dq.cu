// Kernel E: the attention backward's dQ (see flash_attention_bwd.cuh for
// what it replaces, what bounds it and its design).
#include "flash_attention_bwd.cuh"

namespace hcp {
namespace {

// E's launch plan per padded head dim DP below 512 (every plan: two
// warpgroups of 64 query rows): keys per tile BKV, ring stages, output dims
// per block DVC (E writes whole rows: DVC = DP), swizzle width SW in bytes,
// blocks an SM MINB. Read and checked on the CPU by
// tests/test_torch_port_flash_plan.py.
//   X(DP, BKV, STAGES, DVC, SW, MINB)
#define HCP_FLASH_DQ_PLANS(X)     \
    X(48, 64, 4, 48, 32, 2)       \
    X(64, 64, 4, 64, 128, 2)      \
    X(80, 32, 4, 80, 32, 2)       \
    X(128, 64, 4, 128, 128, 1)    \
    X(160, 64, 3, 160, 64, 1)

// Kernel E. grid (ceil(Sq / 128), B * H); st holds the (batch, head, seq)
// strides of q, k, v, dO, dQ (15 values).
template <class P, bool CAUSAL>
__global__ void __launch_bounds__(P::THREADS, P::MINB)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    void* __restrict__ dq, int H, int Sq, int Sk, int D, Strides15 st,
                    float scale, int out_f32) {
    constexpr int DP = P::DP, BKV = P::BN, SW = P::SW, STAGES = P::STAGES, BM = P::BM;
    constexpr int KB = P::W / 16;                  // k16 slices in a row of one block
    extern __shared__ unsigned char smem_raw[];
    const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const uint32_t sdO = sQ + P::RES_BYTES;
    const uint32_t sKV = sdO + P::RES_BYTES;       // ring: slot s holds K, then V

    const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    // causal: the last query blocks, which see the most keys, start first
    const int qblock = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int q0 = qblock * BM, row0 = q0 + wg * 64;   // this warpgroup's first query
    const bf16* qb = q + b * st.v[0] + h * st.v[1];
    const bf16* kb = k + b * st.v[3] + h * st.v[4];
    const bf16* vb = v + b * st.v[6] + h * st.v[7];
    const bf16* ob = dout + b * st.v[9] + h * st.v[10];

    int nkt = (Sk + BKV - 1) / BKV;
    if (CAUSAL) nkt = min(nkt, (q0 + BM - 1) / BKV + 1);   // stop at the diagonal

    auto load_kv = [&](int tile) {
        const uint32_t s = sKV + (tile % STAGES) * 2 * P::TILE_BYTES;
        load_swizzled<SW, P::THREADS, BKV, DP>(s, kb, st.v[5], tile * BKV, Sk, 0, D, tid);
        load_swizzled<SW, P::THREADS, BKV, DP>(s + P::TILE_BYTES, vb, st.v[8], tile * BKV, Sk,
                                               0, D, tid);
    };
    // Q and dO with tile 0's group
    load_swizzled<SW, P::THREADS, BM, DP>(sQ, qb, st.v[2], q0, Sq, 0, D, tid);
    load_swizzled<SW, P::THREADS, BM, DP>(sdO, ob, st.v[11], q0, Sq, 0, D, tid);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nkt) load_kv(s);
        cp_async_commit();
    }

    // lse (log2 units) and delta of rows g, g + 8, and the last key row g
    // may see (row g + 8: 8 more under causal). A row past Sq sees keys
    // past Sk under causal, whose zero-filled K and V rows add nothing; its
    // dQ is never stored.
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + warp * 16 + g + r * 8;
        const bool ok = row < Sq;
        lse2[r] = ok ? lse[static_cast<long long>(bh) * Sq + row] * LOG2E : 0.f;
        dl[r] = ok ? delta[static_cast<long long>(bh) * Sq + row] : 0.f;
    }
    const int last_key = CAUSAL ? row0 + warp * 16 + g : Sk - 1;
    const float scale_log2 = scale * LOG2E;

    // this warpgroup's 64 rows of Q and dO, K-major
    const uint64_t qd = smem_desc<SW>(sQ + wg * 64 * SW, 16, 8 * SW);
    const uint64_t od = smem_desc<SW>(sdO + wg * 64 * SW, 16, 8 * SW);
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    for (int j = 0; j < nkt; ++j) {
        cp_async_wait<STAGES - 2>();   // this thread's copies of tile j have landed
        fence_proxy_async();
        __syncthreads();               // everyone's have; every product of tile j - 1 is done
        if (j + STAGES - 1 < nkt) load_kv(j + STAGES - 1);
        cp_async_commit();
        const int k0 = j * BKV;
        if (CAUSAL && k0 > row0 + 63) continue;   // no key of this tile is visible here

        const uint32_t sK = sKV + (j % STAGES) * 2 * P::TILE_BYTES;
        const uint64_t kd = smem_desc<SW>(sK, 16, 8 * SW);
        const uint64_t vd = smem_desc<SW>(sK + P::TILE_BYTES, 16, 8 * SW);
        const uint64_t kt = smem_desc<SW>(sK, BKV * SW, 8 * SW);   // K MN-major: N = DP

        // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows x BKV keys,
        // two groups: P's exp runs while dP is computed
        float s[BKV / 2], dp[BKV / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)   // slice kk: block kk / KB, 32 B per slice in it
            Wgmma<BKV>::mma(s, qd + (kk / KB) * (BM * SW / 16) + (kk % KB) * 2,
                            kd + (kk / KB) * (BKV * SW / 16) + (kk % KB) * 2, kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            Wgmma<BKV>::mma(dp, od + (kk / KB) * (BM * SW / 16) + (kk % KB) * 2,
                            vd + (kk / KB) * (BKV * SW / 16) + (kk % KB) * 2, kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_operands(s);

        // P, then dS / scale, on the accumulators: element i is row g + 8 *
        // ((i / 2) % 2), key k0 + (i / 4) * 8 + 2t + i % 2
        const bool masked = k0 + BKV > Sk || (CAUSAL && k0 + BKV - 1 > row0);
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
            const int r = (i >> 1) & 1;
            s[i] = fast_exp2(fmaf(s[i], scale_log2, -lse2[r]));
            if (masked && k0 + (i / 4) * 8 + 2 * t + (i & 1) > last_key + (CAUSAL ? 8 * r : 0))
                s[i] = 0.f;
        }
        wgmma_wait<0>();
        fence_operands(dp);
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) s[i] *= dp[i] - dl[(i >> 1) & 1];

        // dQ += dS K: dS from registers, K read MN-major (keys 16jj..: 16
        // rows of SW bytes further)
        uint32_t da[BKV / 16][4];
        pack_a<BKV>(da, s);
        fence_operands(acc);
#pragma unroll
        for (int jj = 0; jj < BKV / 16; ++jj) fence_operands(da[jj]);
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < BKV / 16; ++jj) WgmmaRS<DP>::mma(acc, da[jj], kt + jj * SW);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
#pragma unroll
        for (int jj = 0; jj < BKV / 16; ++jj) fence_operands(da[jj]);
    }
    cp_async_wait<0>();
    store_acc<DP>(dq, b * st.v[12] + h * st.v[13], st.v[14], acc, scale, row0, Sq, 0, D, warp,
                  g, t, out_f32);
}

template <class P>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, int B, int H, int Sq, int Sk, int D,
           const long long* strides, float scale, int causal, int out_f32, cudaStream_t s) {
    auto kern = causal ? flash_bwd_dq_kernel<P, true> : flash_bwd_dq_kernel<P, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    Strides15 st;
    for (int i = 0; i < 15; ++i) st.v[i] = strides[i];
    dim3 grid((Sq + P::BM - 1) / P::BM, B * H);
    kern<<<grid, P::THREADS, P::SMEM, s>>>(
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
#define HCP_DQ_CASE(DP, BKV, STAGES, DVC, SW, MINB)                                        \
    case DP:                                                                               \
        return launch<BwdPlan<DP, BKV, STAGES, DVC, SW, MINB, false>>(                     \
            q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D, strides, scale, causal, out_f32, s);
    switch ((D + 15) / 16 * 16) {
        HCP_FLASH_DQ_PLANS(HCP_DQ_CASE)
        case 512:
            return flash_bwd_dq_512(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D, strides, scale,
                                    causal, out_f32, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef HCP_DQ_CASE
}
