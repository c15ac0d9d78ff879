// Kernel D: GroupNorm with fp32 statistics, affine, optional SiLU, on a
// channels-last tensor x [B, S, C] of type T: bf16, or fp32 (an fp32 model:
// fp32 in, fp32 out, fp32 statistics, as _gn_silu_kernel computes for an
// fp32 x).
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

// 8 consecutive channels as floats, and back
__device__ __forceinline__ void load8(const bf16* p, float* f) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float2 v = __bfloat1622float2(p2[i]);
        f[2 * i] = v.x;
        f[2 * i + 1] = v.y;
    }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
    float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float* f) {
    uint4 v;
    uint32_t* v32 = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) v32[i] = pack_bf16x2(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
}
__device__ __forceinline__ void store8(float* p, const float* f) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int S, int C, int G,
                int rows_per_split, int nsplit) {
    extern __shared__ float sh[];            // [2C]: per-channel sum, sum of squares
    float* ssum = sh;
    float* ssq = sh + C;
    const int tid = threadIdx.x, sp = blockIdx.x, b = blockIdx.y;
    for (int i = tid; i < 2 * C; i += THREADS) sh[i] = 0.f;
    __syncthreads();

    const int r0 = sp * rows_per_split;
    const int r1 = min(S, r0 + rows_per_split);
    const T* xb = x + (size_t)b * S * C;
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
            float f[8];
            load8(xb + (size_t)r * C + v * 8, f);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                s[i] += f[i];
                q[i] += f[i] * f[i];
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                const float* __restrict__ scale, const float* __restrict__ bias,
                T* __restrict__ y, int S, int C, int G, int rows_per_split, int nsplit,
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
        float f[8];
        load8(x + off, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int c = v * 8 + i;
            float yi = f[i] * sa[c] + sc[c];
            if (silu) yi = yi / (1.f + __expf(-yi));
            f[i] = yi;
        }
        store8(y + off, f);
    }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y, void* workspace, int B,
           int S, int C, int G, int nsplit, int rows_per_split, float eps, int silu,
           cudaStream_t s) {
    dim3 grid(nsplit, B);
    const T* xp = static_cast<const T*>(x);
    float* ws = static_cast<float*>(workspace);
    gn_stats_kernel<T><<<grid, THREADS, 2 * C * sizeof(float), s>>>(xp, ws, S, C, G,
                                                                    rows_per_split, nsplit);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gn_apply_kernel<T><<<grid, THREADS, (2 * C + 2 * G) * sizeof(float), s>>>(
        xp, ws, static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<T*>(y), S, C, G, rows_per_split, nsplit, eps, silu);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hcp

// x, y [B, S, C]: bf16, or fp32 when f32 != 0; contiguous, 16-byte aligned,
// C % 8 == 0, C % G == 0; scale, bias [C] fp32; workspace [B, nsplit, G, 2]
// fp32 with nsplit * rows_per_split >= S. Returns cudaGetLastError().
extern "C" int hcp_group_norm(const void* x, const void* scale, const void* bias, void* y,
                              void* workspace, int B, int S, int C, int G, int nsplit,
                              int rows_per_split, float eps, int silu, int f32, void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return f32 ? launch<float>(x, scale, bias, y, workspace, B, S, C, G, nsplit, rows_per_split,
                               eps, silu, s)
               : launch<bf16>(x, scale, bias, y, workspace, B, S, C, G, nsplit, rows_per_split,
                              eps, silu, s);
}
