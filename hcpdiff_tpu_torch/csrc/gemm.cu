// The bf16 GEMMs with a LayerNorm prologue, y = LayerNorm(x) @ w^T with
// x [M, K] and w [N, K] (nn.Linear layout), fp32 accumulation:
//   G  ln_qkv       LayerNorm(x) Wq^T, LayerNorm(x) Wk^T, LayerNorm(x) Wv^T
//   H  ln_geglu     GEGLU of LayerNorm(x)
//   I  ln_dense     LayerNorm(x) W^T
// (B and C, the same GEMMs without the LayerNorm, are gemm_wgmma.cu.)
//
// Replaces hcpdiff_tpu/ops/matmul.py:_ln_qkv_kernel (:412, via ln_qkv
// :489), _ln_geglu_kernel (:497, via ln_geglu :591) and _ln_dense_kernel
// (:600, via ln_dense :669).
//
// What bounds it on the H100: at the UNet's shapes (M = 2b*S up to 32768,
// K in 320..1280, N in 320..10240) the GEMMs are far above the 295
// FLOP/byte ridge, so the tensor cores bound them; the prologue and
// epilogue work (LayerNorm, bias, GELU gate) is memory traffic that
// separate elementwise passes would add on top. The design keeps it on
// chip: the LayerNorm modes normalize each A stage in shared memory, so
// the normalized activation is never written, and G reads x for all three
// projections (a block picks wq, wk or wv by its grid index); GEGLU
// computes the value and the gate tile of the same output columns in one
// block with two accumulators, so the [M, 2n] intermediate never reaches
// device memory. The TPU kernels' K-resident / K-streamed split was a
// VMEM-size artefact: every K runs the same loop over 32-wide slices.
//
// LayerNorm: before the main loop a block computes its 128 rows' mean and
// 1/sqrt(var + eps) in fp32, two passes over the row (the mean of squared
// deviations, as _ln_rows does, matmul.py:404-409); x rows are at most a
// few KB, so the second pass and the main loop read them from cache. Each
// A stage is then rewritten in place as bf16((x - mean) * rstd * g + b),
// the rounding the TPU kernels apply before their product.
//
// Simple first version: mma.sync m16n8k16 (not wgmma/TMA), 128x128 block
// tile, 8 warps of 32x64, two shared-memory stages (gemm_tile.cuh).
//
// Types: x, the weights and the LayerNorm scale and shift are bf16. H's
// bias and the outputs are OutT: bf16, or fp32 for an fp32 call (whose x,
// weights, scale and shift the wrapper rounds to bf16), so its result is
// rounded once.
#include "gemm_tile.cuh"

namespace hcp {
namespace {

enum Mode { DENSE = 0, GEGLU = 2 };

struct Params {
    const bf16* x;
    const bf16* w[3];           // G: wq, wk, wv; otherwise w[0]
    const void* bias;           // [2N] (GEGLU) or null (OutT)
    void* out[3];               // one output per weight (OutT)
    const bf16* ln_g;           // LayerNorm scale and shift [K] (LN modes)
    const bf16* ln_b;
    float eps;
    int M, N, K;
    int ntn;                    // column tiles per weight
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float* f) {
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
}

// mean and 1/sqrt(var + eps) of rows m0 .. m0 + BM of x [M, K] (K % 8 == 0),
// one warp per row; rows past M get 0 and 0.
__device__ void row_stats(const bf16* x, int M, int K, int m0, float eps, float* s_mean,
                          float* s_rstd) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < BM; r += THREADS / 32) {
        const int gm = m0 + r;
        float mean = 0.f, rstd = 0.f;
        if (gm < M) {
            const bf16* row = x + (size_t)gm * K;
            float f[8], s = 0.f;
            for (int k = lane * 8; k < K; k += 256) {
                bf16x8_to_float(*reinterpret_cast<const uint4*>(row + k), f);
#pragma unroll
                for (int j = 0; j < 8; ++j) s += f[j];
            }
            mean = warp_sum(s) / K;
            float q = 0.f;
            for (int k = lane * 8; k < K; k += 256) {
                bf16x8_to_float(*reinterpret_cast<const uint4*>(row + k), f);
#pragma unroll
                for (int j = 0; j < 8; ++j) q += (f[j] - mean) * (f[j] - mean);
            }
            rstd = rsqrtf(warp_sum(q) / K + eps);
        }
        if (lane == 0) {
            s_mean[r] = mean;
            s_rstd[r] = rstd;
        }
    }
}

template <int MODE, typename OutT>
__global__ void __launch_bounds__(THREADS) gemm_kernel(Params p) {
    __shared__ __align__(16) TileSmem sm;
    __shared__ float s_mean[BM], s_rstd[BM];

    constexpr bool PAIRED = MODE == GEGLU;
    const int which = blockIdx.x / p.ntn;
    const int m0 = blockIdx.y * BM;
    const int n0 = (blockIdx.x % p.ntn) * (PAIRED ? 64 : 128);
    // selected, not indexed: a runtime index into the parameter struct
    // would copy it to local memory
    const bf16* w = which == 0 ? p.w[0] : which == 1 ? p.w[1] : p.w[2];
    OutT* out = static_cast<OutT*>(which == 0 ? p.out[0] : which == 1 ? p.out[1] : p.out[2]);
    const OutT* bias = static_cast<const OutT*>(p.bias);

    row_stats(p.x, p.M, p.K, m0, p.eps, s_mean, s_rstd);
    __syncthreads();
    auto fill_a = [&](bf16* s, int k0) {
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
            const int r = a_chunk_row(i), kc = a_chunk_col(i);
            const int gm = m0 + r, gk = k0 + kc;
            const bool ok = gm < p.M && gk < p.K;
            cp_async16(&s[r * LDS + kc], ok ? p.x + (size_t)gm * p.K + gk : p.x, ok);
        }
    };
    auto prep_a = [&](bf16* s, int k0) {
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
            const int r = a_chunk_row(i), kc = a_chunk_col(i);
            const int gk = k0 + kc;
            if (gk >= p.K) continue;         // stays zero: the padding adds nothing
            uint4* chunk = reinterpret_cast<uint4*>(&s[r * LDS + kc]);
            float xv[8], gv[8], bv[8];
            bf16x8_to_float(*chunk, xv);
            bf16x8_to_float(*reinterpret_cast<const uint4*>(p.ln_g + gk), gv);
            bf16x8_to_float(*reinterpret_cast<const uint4*>(p.ln_b + gk), bv);
            const float mean = s_mean[r], rstd = s_rstd[r];
            uint4 y;
            uint32_t* yw = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                yw[j] = pack_bf16x2((xv[2 * j] - mean) * rstd * gv[2 * j] + bv[2 * j],
                                    (xv[2 * j + 1] - mean) * rstd * gv[2 * j + 1] + bv[2 * j + 1]);
            *chunk = y;
        }
    };

    float acc[2][8][4];
    mainloop<PAIRED>(acc, sm, w, p.N, p.K, n0, fill_a, prep_a);

    // Epilogue: fp32 bias and GELU gate (GEGLU), one store.
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
    const int N = p.N;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int row = m0 + wm * 32 + mi * 16 + g + h * 8;
            if (row >= p.M) continue;
            if (PAIRED) {
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) {
                    int col = n0 + wn * 32 + ni * 8 + 2 * t;
                    if (col >= N) continue;
                    float y[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        float v = acc[mi][ni][2 * h + e];
                        float gt = acc[mi][ni + 4][2 * h + e];
                        if (bias) {
                            v += as_float(bias[col + e]);
                            gt += as_float(bias[N + col + e]);
                        }
                        y[e] = v * (0.5f * gt * (1.f + erff(gt * 0.70710678118654752f)));
                    }
                    store2(out + (size_t)row * N + col, y[0], y[1]);
                }
            } else {
#pragma unroll
                for (int ni = 0; ni < 8; ++ni) {
                    int col = n0 + wn * 64 + ni * 8 + 2 * t;
                    if (col >= N) continue;
                    store2(out + (size_t)row * N + col, acc[mi][ni][2 * h],
                           acc[mi][ni][2 * h + 1]);
                }
            }
        }
    }
}

template <int MODE>
int launch(const Params& p, int nw, int out_f32, cudaStream_t s) {
    dim3 grid(nw * p.ntn, (p.M + BM - 1) / BM);
    if (out_f32)
        gemm_kernel<MODE, float><<<grid, THREADS, 0, s>>>(p);
    else
        gemm_kernel<MODE, bf16><<<grid, THREADS, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hcp

// Kernels G, H and I: LayerNorm(x; ln_g, ln_b, eps) over rows of x [M, K],
// then mode 0 (DENSE: G with nw = 3 weights w0..w2 into out0..out2, I with
// nw = 1; no bias) or mode 2 (GEGLU: H, w0 [2N, K], bias [2N] or null).
// ln_g, ln_b [K] and each w [N, K]: bf16; bias and each out [M, N]: bf16,
// or fp32 when out_f32 != 0. Row-major, 16-byte aligned; K % 8 == 0,
// N % 2 == 0. Returns cudaGetLastError().
extern "C" int hcp_ln_gemm(int mode, const void* x, const void* ln_g, const void* ln_b,
                           const void* w0, const void* w1, const void* w2, const void* bias,
                           void* out0, void* out1, void* out2, int nw, int M, int N, int K,
                           float eps, int out_f32, void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (nw < 1 || nw > 3 || (mode == GEGLU && nw != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    Params p = {};
    p.x = static_cast<const bf16*>(x);
    p.bias = mode == GEGLU ? bias : nullptr;
    p.M = M;
    p.N = N;
    p.K = K;
    p.ntn = (N + (mode == GEGLU ? 63 : 127)) / (mode == GEGLU ? 64 : 128);
    const void* ws[3] = {w0, w1, w2};
    void* outs[3] = {out0, out1, out2};
    for (int i = 0; i < nw; ++i) {
        p.w[i] = static_cast<const bf16*>(ws[i]);
        p.out[i] = outs[i];
    }
    p.ln_g = static_cast<const bf16*>(ln_g);
    p.ln_b = static_cast<const bf16*>(ln_b);
    p.eps = eps;
    switch (mode) {
        case DENSE: return launch<DENSE>(p, nw, out_f32, s);
        case GEGLU: return launch<GEGLU>(p, 1, out_f32, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
