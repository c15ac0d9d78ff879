// Kernel A: attention forward, O = softmax(Q K^T * scale) V, on bf16
// [B, H, S, D] tensors given by strides, fp32 softmax state, with an
// optional causal mask (key <= query, top-left aligned; Sq == Sk).
//
// Replaces, in hcpdiff_tpu/ops/flash_attention.py:
//   #1 _flash_kernel_tq (:379, via _flash_forward_tq :460; the UNet's
//      D=40/80 self-attention under the JAX defaults);
//   #2 _flash_kernel (:54, via _flash_forward :548; the classic layout
//      with K/V resident: every head dim under HCP_FLASH_NOMAX=0 or
//      HCP_FLASH_TQ=0, and head dims outside the transposed set, D=128);
//   #3 _flash_kernel_stream (:226, via _flash_forward_stream :325; the
//      VAE's D=512 mid-block attention);
//   with its lse output, #1's emit_lse variant (:453-457) and #4
//   _flash_kernel_lse (:613, via _flash_forward_lse :634).
// One kernel serves all four: the TPU's transposed layout only fixed lane
// padding, its K/V residency and streaming were VMEM budgeting, and here
// every block streams K/V tiles anyway. The TPU kernels' causal option
// (:84-89, :122-127, loop bound :189-192) is the `causal` flag below.
//
// What bounds it on the H100: at S=4096 the [S, S] logits would be 64 MB
// per head in fp32, so materialising them makes attention memory-bound;
// kept on chip, QK^T and PV are 4*S*S*D FLOPs (causal: 4*S(S+1)/2*D, the
// unmasked pairs only) over 4*S*D*2 bytes, far above the ridge, so the
// tensor cores and the softmax's exp bound it. The design streams K/V
// tiles through shared memory with an online softmax (running max m,
// running sum l, fp32 accumulator), as in FlashAttention-2: each warp owns
// 16 query rows, S and P stay in registers, and P feeds the PV product
// straight from the S accumulator fragments. The TPU kernels' no-max
// softmax (clamped at NOMAX_CLAMP, the default there) is not copied: the
// running max is exact for any logit range, which is the classic kernels'
// HCP_FLASH_NOMAX=0 function.
//
// Causal: a block of queries [q0, q0+BQ) loops only over the key tiles
// that start at or before q0+BQ-1, so about half the tiles are skipped;
// inside the diagonal tile the keys past each row are -inf before the
// running max. With Sq == Sk key 0 is in every row, so m and lse stay
// finite. The flag is a template parameter, so the non-causal kernel
// carries no per-row mask state (registers decide how many blocks share
// an SM). The causal kernel is built for DP <= 160 only: D=512 is the
// VAE's attention, which is not causal, and has no backward.
//
// Head dims: D is padded to DP (a multiple of 16: 48, 64, 80, 128, 160,
// 512) inside the shared tiles with zeros, which leaves QK^T unchanged;
// output columns >= D are never stored. DP=160 and DP=512 would need a
// 16xDP fp32 accumulator per warp (DP/2 registers a thread), so their
// output dims are split into chunks of DVC over grid.z; each chunk
// recomputes QK^T.
//
// Training: when given an lse buffer, the kernel also writes each row's
// natural-log logsumexp of the scaled (and masked) logits (fp32
// [B, H, Sq]), which the backward kernels (flash_attention_bwd.cu) use to
// recompute P. The running max is in log2 units, so
// lse = (m + log2 l) * ln 2; with D split over grid.z only the first chunk
// stores it. Inference passes no buffer.
//
// Output type: o is bf16, or fp32 for an fp32 call (whose q, k and v the
// wrapper rounds to bf16). The type is a run-time flag read only in the
// final store, after the key loop, so it costs the loop no registers.
//
// Simple first version: mma.sync m16n8k16, 64 query rows x 64 keys per
// step, K and V single-buffered, V transposed into shared memory by the
// loading threads (no ldmatrix.trans, no wgmma/TMA).
#include <math.h>

#include "common.cuh"

namespace hcp {
namespace {

constexpr int BQ = 64;           // query rows per block (4 warps x 16)
constexpr int BKV = 64;          // keys per step
constexpr int THREADS = 128;
constexpr int LDV = BKV + 8;     // padded row of the transposed V tile

template <int DP, int DVC>
constexpr int smem_bytes() {
    return ((BQ + BKV) * (DP + 8) + DVC * LDV) * 2;
}

// Up to DP=160 four blocks fit an SM's shared memory; ask ptxas for the
// registers to match (<= 128 a thread), or a few registers over 128 leave
// one SM slot in four empty (S=1024, D=80: 3 blocks an SM, two waves).
template <int DP>
constexpr int min_blocks() {
    return DP <= 160 ? 4 : 1;
}

template <int DP, int DVC, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, min_blocks<DP>())
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, void* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk,
                 int D, long long qsb, long long qsh, long long qss, long long ksb,
                 long long ksh, long long kss, long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss, float scale_log2, int out_f32) {
    constexpr int LDQ = DP + 8;
    constexpr int NDT = DVC / 8;     // output n-tiles per warp
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sK = sQ + BQ * LDQ;
    bf16* sVt = sK + BKV * LDQ;      // [DVC][LDV]: V tile transposed, d-major

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BQ;
    const int dc0 = blockIdx.z * DVC;
    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* kb = k + b * ksb + h * ksh;
    const bf16* vb = v + b * vsb + h * vsh;

    for (int c = tid; c < BQ * (DP / 8); c += THREADS) {
        int r = c / (DP / 8), d = (c % (DP / 8)) * 8;
        bool ok = q0 + r < Sq && d < D;
        cp_async16(sQ + r * LDQ + d, ok ? qb + (q0 + r) * qss + d : q, ok);
    }
    cp_async_commit();

    float m_i[2] = {-1e30f, -1e30f};  // running max (log2 units) of rows g, g+8
    float l_i[2] = {0.f, 0.f};        // this thread's share of the running sums
    float acc[NDT][4];
#pragma unroll
    for (int j = 0; j < NDT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    // the last key each of this thread's rows g, g+8 may see
    int last_key[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
        last_key[r] = CAUSAL ? min(Sk - 1, q0 + warp * 16 + g + r * 8) : Sk - 1;
    int nkt = (Sk + BKV - 1) / BKV;
    if (CAUSAL) nkt = min(nkt, (q0 + BQ - 1) / BKV + 1);   // skip tiles past the diagonal
    for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * BKV;
        __syncthreads();             // previous tile fully consumed
        for (int c = tid; c < BKV * (DP / 8); c += THREADS) {
            int r = c / (DP / 8), d = (c % (DP / 8)) * 8;
            bool ok = k0 + r < Sk && d < D;
            cp_async16(sK + r * LDQ + d, ok ? kb + (k0 + r) * kss + d : k, ok);
        }
        cp_async_commit();
        for (int c = tid; c < BKV * (DVC / 8); c += THREADS) {
            int r = c / (DVC / 8), dd = (c % (DVC / 8)) * 8;
            int d = dc0 + dd;
            uint4 raw = make_uint4(0u, 0u, 0u, 0u);
            if (k0 + r < Sk && d < D)
                raw = *reinterpret_cast<const uint4*>(vb + (k0 + r) * vss + d);
            const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
            for (int i = 0; i < 8; ++i) sVt[(dd + i) * LDV + r] = e8[i];
        }
        cp_async_wait<0>();
        __syncthreads();

        // S = Q K^T for this warp's 16 rows x 64 keys.
        float s[8][4];
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DP; kk += 16) {
            uint32_t af[4];
            load_a(af, sQ, LDQ, warp * 16, kk, g, t);
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
                uint32_t bfr[2];
                load_b(bfr, sK, LDQ, ni * 8, kk, g, t);
                mma_16816(s[ni], af, bfr);
            }
        }

        // Online softmax in base 2. Elements e=0,1 belong to row g, e=2,3
        // to row g+8; the four threads t=0..3 of a group share each row.
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int key = k0 + ni * 8 + 2 * t + (e & 1);
                float val = key <= last_key[e >> 1] ? s[ni][e] * scale_log2 : -INFINITY;
                s[ni][e] = val;
                mx[e >> 1] = fmaxf(mx[e >> 1], val);
            }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            float m_new = fmaxf(m_i[r], mx[r]);
            alpha[r] = exp2f(m_i[r] - m_new);
            m_i[r] = m_new;
            l_i[r] *= alpha[r];
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float p = exp2f(s[ni][e] - m_i[e >> 1]);
                s[ni][e] = p;
                l_i[e >> 1] += p;
            }
#pragma unroll
        for (int j = 0; j < NDT; ++j) {
            acc[j][0] *= alpha[0];
            acc[j][1] *= alpha[0];
            acc[j][2] *= alpha[1];
            acc[j][3] *= alpha[1];
        }

        // O += P V: the S fragments of n-tiles 2j, 2j+1 are exactly the A
        // fragment of keys [16j, 16j+16).
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
            uint32_t pa[4];
            pa[0] = pack_bf16x2(s[2 * j][0], s[2 * j][1]);
            pa[1] = pack_bf16x2(s[2 * j][2], s[2 * j][3]);
            pa[2] = pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]);
            pa[3] = pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
            for (int nd = 0; nd < NDT; ++nd) {
                uint32_t bv[2];
                load_b(bv, sVt, LDV, nd * 8, j * 16, g, t);
                mma_16816(acc[nd], pa, bv);
            }
        }
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_i[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.f / l;
        int row = q0 + warp * 16 + g + r * 8;
        if (lse != nullptr && blockIdx.z == 0 && t == 0 && row < Sq)
            lse[static_cast<long long>(blockIdx.y) * Sq + row] =
                (m_i[r] + log2f(l)) * 0.6931471805599453f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        int row = q0 + warp * 16 + g + r * 8;
        if (row >= Sq) continue;
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd) {
            int d = dc0 + nd * 8 + 2 * t;
            if (d >= D) continue;
            const long long off = b * osb + h * osh + row * oss + d;
            const float y0 = acc[nd][2 * r] * inv[r], y1 = acc[nd][2 * r + 1] * inv[r];
            if (out_f32)
                store2(static_cast<float*>(o) + off, y0, y1);
            else
                store2(static_cast<bf16*>(o) + off, y0, y1);
        }
    }
}

template <int DP, int DVC>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int Sq, int Sk, int D, const long long* st, float scale_log2, int causal, int out_f32,
           cudaStream_t s) {
    constexpr int smem = smem_bytes<DP, DVC>();
    auto kern = flash_fwd_kernel<DP, DVC, false>;
    if constexpr (DP <= 160) {
        if (causal) kern = flash_fwd_kernel<DP, DVC, true>;
    } else if (causal) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((Sq + BQ - 1) / BQ, B * H, (DP + DVC - 1) / DVC);
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        o, lse, H, Sq, Sk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11], scale_log2, out_f32);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hcp

// q [B,H,Sq,D], k/v [B,H,Sk,D]: bf16; o [B,H,Sq,D]: bf16, or fp32 when
// out_f32 != 0; all with unit stride on D; `strides` holds (batch, head,
// seq) strides in elements for q, k, v, o (12 values). D % 8 == 0 and
// 16-byte aligned rows. `lse` is null, or a contiguous fp32 [B, H, Sq]
// buffer for the row logsumexp. `causal` != 0 masks keys past each query
// (top-left aligned; the caller ensures Sq == Sk; D <= 160). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported D or
// causal D.
extern "C" int hcp_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse_out, int B, int H, int Sq, int Sk, int D,
                                   const long long* strides, float scale, int causal,
                                   int out_f32, void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float sl2 = scale * 1.4426950408889634f;
    float* lse = static_cast<float*>(lse_out);
#define HCP_FWD(DP, DVC) \
    launch<DP, DVC>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, sl2, causal, out_f32, s)
    switch ((D + 15) / 16 * 16) {
        case 48: return HCP_FWD(48, 48);
        case 64: return HCP_FWD(64, 64);
        case 80: return HCP_FWD(80, 80);
        case 128: return HCP_FWD(128, 128);
        case 160: return HCP_FWD(160, 80);
        case 512: return HCP_FWD(512, 128);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef HCP_FWD
}
