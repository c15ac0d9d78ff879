// Kernel D: GroupNorm with fp32 statistics, affine, optional SiLU, on a
// channels-last bf16 tensor x [B, S, C].
//
// Replaces hcpdiff_tpu/ops/groupnorm.py:_gn_silu_kernel (:22, via
// _gn_silu_pallas_raw :125 and group_norm_silu :281) and computes the same
// function as the streaming pair _gn_stats_kernel / _gn_apply_kernel
// (:177 / :204).
//
// What bounds it on the H100: it reads x twice and writes y once at about
// one FLOP per byte, so device-memory bandwidth bounds it; the way to lose
// is to leave SMs idle. The TPU design (one grid step per sample, the whole
// [S, C] block in VMEM) would give a batch of 8 only 8 of the 132 SMs, and
// the VAE's [b, 512*512, 128] levels do not fit any on-chip memory. So both
// passes split S over many blocks:
//   1. stats: grid (nsplit, B); each block sums x and x*x per channel over
//      its rows (16-byte loads along C, per-thread fp32 registers, one
//      shared-memory atomic per channel per thread at the end), folds the
//      channels into groups and writes [B, nsplit, G, 2] partial sums;
//   2. apply: grid (nsplit, B); each block reduces its sample's partials
//      (in double, all threads), turns mean and 1/sqrt(var + eps) into a per-channel
//      scale and shift, and writes y = silu(x * a + c) for its rows.
// The variance is E[x^2] - E[x]^2 clamped at 0, as _gn_silu_xla_direct
// (:116) computes it.
#include "common.cuh"

namespace hcp {
namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ partial, int S, int C, int G,
                int rows_per_split, int nsplit) {
    extern __shared__ float sh[];            // [2C]: per-channel sum, sum of squares
    float* ssum = sh;
    float* ssq = sh + C;
    const int tid = threadIdx.x, sp = blockIdx.x, b = blockIdx.y;
    for (int i = tid; i < 2 * C; i += THREADS) sh[i] = 0.f;
    __syncthreads();

    const int r0 = sp * rows_per_split;
    const int r1 = min(S, r0 + rows_per_split);
    const bf16* xb = x + (size_t)b * S * C;
    const int vr = C / 8;                    // 8-channel vectors per row
    for (int v0 = 0; v0 < vr; v0 += THREADS) {
        const int strip = min(THREADS, vr - v0);
        const int rpp = THREADS / strip;     // rows read in parallel
        if (tid >= rpp * strip) continue;
        const int v = v0 + tid % strip;
        float s[8], q[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.f;
        for (int r = r0 + tid / strip; r < r1; r += rpp) {
            uint4 raw = *reinterpret_cast<const uint4*>(xb + (size_t)r * C + v * 8);
            const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float2 f = __bfloat1622float2(p2[i]);
                s[2 * i] += f.x;
                s[2 * i + 1] += f.y;
                q[2 * i] += f.x * f.x;
                q[2 * i + 1] += f.y * f.y;
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            atomicAdd(ssum + v * 8 + i, s[i]);
            atomicAdd(ssq + v * 8 + i, q[i]);
        }
    }
    __syncthreads();

    const int cg = C / G;
    for (int gi = tid; gi < G; gi += THREADS) {
        float a = 0.f, a2 = 0.f;
        for (int c = gi * cg; c < (gi + 1) * cg; ++c) {
            a += ssum[c];
            a2 += ssq[c];
        }
        float* out = partial + ((size_t)(b * nsplit + sp) * G + gi) * 2;
        out[0] = a;
        out[1] = a2;
    }
}

__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ partial,
                const float* __restrict__ scale, const float* __restrict__ bias,
                bf16* __restrict__ y, int S, int C, int G, int rows_per_split, int nsplit,
                float eps, int silu) {
    extern __shared__ float sh[];            // [C] scale a, [C] shift c, [G] mean, [G] rstd
    float* sa = sh;
    float* sc = sh + C;
    float* smean = sh + 2 * C;
    float* srstd = smean + G;
    __shared__ double red[2][THREADS];
    const int tid = threadIdx.x, sp = blockIdx.x, b = blockIdx.y;
    const int cg = C / G;
    // Reduce this sample's partial sums: `tpg` threads per group each take
    // every tpg-th split, then one thread per group adds their results.
    const int tpg = THREADS / G;             // G <= THREADS (checked by the wrapper)
    {
        double a = 0.0, a2 = 0.0;
        if (tid < tpg * G) {
            const int gi = tid / tpg;
            for (int p = tid % tpg; p < nsplit; p += tpg) {
                const float* in = partial + ((size_t)(b * nsplit + p) * G + gi) * 2;
                a += in[0];
                a2 += in[1];
            }
        }
        red[0][tid] = a;
        red[1][tid] = a2;
    }
    __syncthreads();
    if (tid < G) {
        double a = 0.0, a2 = 0.0;
        for (int j = 0; j < tpg; ++j) {
            a += red[0][tid * tpg + j];
            a2 += red[1][tid * tpg + j];
        }
        const double n = (double)S * cg;
        double mean = a / n;
        double var = a2 / n - mean * mean;
        smean[tid] = (float)mean;
        srstd[tid] = rsqrtf((float)(var > 0.0 ? var : 0.0) + eps);
    }
    __syncthreads();
    for (int c = tid; c < C; c += THREADS) {
        int gi = c / cg;
        float a = srstd[gi] * scale[c];
        sa[c] = a;
        sc[c] = bias[c] - smean[gi] * a;
    }
    __syncthreads();

    const int r0 = sp * rows_per_split;
    const int r1 = min(S, r0 + rows_per_split);
    const int vr = C / 8;
    const size_t base = ((size_t)b * S + r0) * C;
    const size_t total = (size_t)max(r1 - r0, 0) * vr;
    for (size_t idx = tid; idx < total; idx += THREADS) {
        const int v = (int)(idx % vr);
        const size_t off = base + idx * 8;   // rows are contiguous: idx*8 walks them
        uint4 raw = *reinterpret_cast<const uint4*>(x + off);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        uint4 outv;
        uint32_t* o32 = reinterpret_cast<uint32_t*>(&outv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float2 f = __bfloat1622float2(p2[i]);
            int c = v * 8 + 2 * i;
            float y0 = f.x * sa[c] + sc[c];
            float y1 = f.y * sa[c + 1] + sc[c + 1];
            if (silu) {
                y0 = y0 / (1.f + __expf(-y0));
                y1 = y1 / (1.f + __expf(-y1));
            }
            o32[i] = pack_bf16x2(y0, y1);
        }
        *reinterpret_cast<uint4*>(y + off) = outv;
    }
}

}  // namespace
}  // namespace hcp

// x, y [B, S, C] bf16 contiguous, 16-byte aligned, C % 8 == 0, C % G == 0;
// scale, bias [C] fp32; workspace [B, nsplit, G, 2] fp32 with
// nsplit * rows_per_split >= S. Returns cudaGetLastError().
extern "C" int hcp_group_norm(const void* x, const void* scale, const void* bias, void* y,
                              void* workspace, int B, int S, int C, int G, int nsplit,
                              int rows_per_split, float eps, int silu, void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    dim3 grid(nsplit, B);
    const bf16* xp = static_cast<const bf16*>(x);
    float* ws = static_cast<float*>(workspace);
    gn_stats_kernel<<<grid, THREADS, 2 * C * sizeof(float), s>>>(xp, ws, S, C, G,
                                                                 rows_per_split, nsplit);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gn_apply_kernel<<<grid, THREADS, (2 * C + 2 * G) * sizeof(float), s>>>(
        xp, ws, static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<bf16*>(y), S, C, G, rows_per_split, nsplit, eps, silu);
    return static_cast<int>(cudaGetLastError());
}
