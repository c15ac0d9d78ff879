// Kernel J (conv3x3): 3x3 stride-1 SAME convolution of an NHWC bf16 image
// with an OHWI bf16 weight, + bias, + a per-sample row bias, + a residual,
// all added in fp32 and rounded once to the output type (bf16, or fp32 for
// an fp32 call, whose bias, row bias and residual are then fp32 too).
//
// Replaces hcpdiff_tpu/ops/conv.py:_conv3_kernel (:48, via _conv3_pallas
// :80 and conv3x3 :235).
//
// What bounds it on the H100: at the UNet resblocks' shapes (B = 8, 64x64
// .. 8x8 pixels, Cin 320..2560, Cout 320..1280) a conv does 2 * 9 * Cin
// FLOPs per output element for 2 * (Cin + Cout) bytes per pixel, far above
// the 295 FLOP/byte ridge: the tensor cores bound it, and only wgmma
// reaches their full rate. The time-embedding add (after conv1) and the
// skip add (after conv2) are memory traffic that two elementwise passes
// would add on top; the epilogue keeps them.
//
// Design: an implicit GEMM, out[M = B*H*W, N = Cout] = A[M, K] x W[N, K]^T,
// with K ordered tap by tap and each tap's channels padded up to a multiple
// of 64: k = tap * Cin64 + ci. One K step is one tap x 64 channels, so a
// stage's A tile is BM image rows of 64 contiguous channels at one (ky, kx)
// shift (128 bytes a row: one row of a 128-byte swizzle), and the tap and
// channel offset are per-stage constants; each thread's pixel coordinates
// stay fixed over the loop. Out-of-image pixels and channels >= Cin (in
// both operands) are zero-filled through cp.async's source size, so no
// padded copy is made. The weight is read as [Cout, 9, Cin] with the same
// per-tap zero-fill.
//   - A ring of STAGES shared-memory stages filled by cp.async, each stage
//     an A tile (128 x 64) and a B tile (BN x 64) in the 128-byte-swizzled
//     K-major layout wgmma's descriptors read (wgmma.cuh). A landed stage
//     passes cp.async.wait_group, fence.proxy.async and a barrier before
//     any wgmma reads it. One wgmma group stays in flight (wait_group 1):
//     the copies of stage i + STAGES - 2 overlap the products of stage i,
//     and they refill the slot that stage i - 2 used, which every
//     warpgroup has finished reading by the barrier of step i.
//   - Consumers: two warpgroups, each wgmma m64nBNk16 over one 64-row half
//     of the 128-row tile (BN = 320: two m64n160k16 per k16), fp32
//     accumulators in registers. BN is 128, 160 or 320 and divides Cout
//     where it can (SD1.5's 320, 640 and 1280 all divide by 160 and 320),
//     so no tensor-core column is thrown away at those widths. The wider
//     the tile, the fewer bytes each product pulls from L2 (a K step copies
//     16 KB of image rows and BN x 128 B of weights); the plan's choices
//     are timed by tools/time_plans.py.
//   - Split-K: where the grid (Cout / BN x M / 128 blocks) is short of a
//     wave on 132 SMs, the host plan (ops/conv.py:conv_plan) splits the K
//     steps into `splits` ranges over grid.z. Each block then writes its
//     fp32 tile to a [splits, M, N] workspace, and a second kernel adds the
//     partial sums in split order and applies the epilogue: no float
//     atomics, so the output is deterministic. With one split the main
//     kernel applies the epilogue itself.
// Not yet: TMA loads, warp specialisation, persistent blocks.
#include "wgmma.cuh"

namespace hcp {
namespace {

constexpr int BM = 128;              // output pixels per block: two warpgroups of 64
constexpr int BKC = 64;              // channels per K step: one 128-byte row
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * BKC * 2;

template <int BN>
__host__ __device__ constexpr int stage_bytes() { return A_BYTES + BN * BKC * 2; }

// wgmma takes N <= 256: a wider column tile is two products of half its width
template <int BN>
__host__ __device__ constexpr int wgmma_n() { return BN > 256 ? BN / 2 : BN; }

// as many stages as fit 227 KB (BN 320: 4 x 56 KB), at most 5
template <int BN>
__host__ __device__ constexpr int stages() { return BN > 160 ? 4 : 5; }

// + 1024 bytes to align the ring to the swizzle's 1024-byte period
template <int BN>
__host__ __device__ constexpr int smem_bytes() { return stages<BN>() * stage_bytes<BN>() + 1024; }

struct ConvParams {
    const bf16* x;              // [B, H, W, Cin]
    const bf16* w;              // [Cout, 3, 3, Cin]
    const void* bias;           // [Cout] or null         (output type)
    const void* row_bias;       // [B, Cout] or null      (output type)
    const void* res;            // [B, H, W, Cout] or null (output type)
    void* out;                  // [B, H, W, Cout]        (output type)
    float* ws;                  // [splits, M, Cout] partial sums, or null (one split)
    int B, H, W, Cin, Cout;
    int cblocks;                // ceil(Cin / 64): K steps per tap
    int ksteps;                 // 9 * cblocks
    int splits;
};

// bias + row bias + residual in fp32, one store of columns col, col + 1 of
// output row `row` (a pixel of sample row / (H * W)).
template <typename OutT>
__device__ __forceinline__ void epilogue_store(const ConvParams& p, int row, int col, float y0,
                                               float y1) {
    const int N = p.Cout;
    if (p.bias) {
        float2 v = load2(static_cast<const OutT*>(p.bias) + col);
        y0 += v.x;
        y1 += v.y;
    }
    if (p.row_bias) {
        const int b = row / (p.H * p.W);
        float2 v = load2(static_cast<const OutT*>(p.row_bias) + (size_t)b * N + col);
        y0 += v.x;
        y1 += v.y;
    }
    if (p.res) {
        float2 v = load2(static_cast<const OutT*>(p.res) + (size_t)row * N + col);
        y0 += v.x;
        y1 += v.y;
    }
    store2(static_cast<OutT*>(p.out) + (size_t)row * N + col, y0, y1);
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(THREADS, 1) conv3x3_wgmma_kernel(ConvParams p) {
    constexpr int S = stages<BN>();
    constexpr int SB = stage_bytes<BN>();
    constexpr int A_ROWS = BM / 32;      // A rows a thread copies per stage
    constexpr int B_ROWS = BN / 32;      // B rows a thread copies per stage
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

    const int tid = threadIdx.x;
    const int M = p.B * p.H * p.W, N = p.Cout, hw = p.H * p.W;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int ks0 = (int)((long long)blockIdx.z * p.ksteps / p.splits);
    const int nk = (int)((long long)(blockIdx.z + 1) * p.ksteps / p.splits) - ks0;

    // This thread copies the 16-byte chunk j (channels 8j .. 8j + 7 of the
    // step) of rows r0 + 32 i; all those rows share r0 % 8, so the chunk's
    // swizzled place in the row is one constant.
    const int j = tid & 7, r0 = tid >> 3;
    const uint32_t chunk_off = r0 * 128 + ((j ^ (r0 & 7)) << 4);
    int pb[A_ROWS], py[A_ROWS], px[A_ROWS];
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
        const int m = m0 + r0 + 32 * i;
        pb[i] = m < M ? m / hw : -1;
        const int rem = m - (m < M ? pb[i] : 0) * hw;
        py[i] = rem / p.W;
        px[i] = rem - py[i] * p.W;
    }
    auto load_stage = [&](int slot, int ks) {
        const int tap = ks / p.cblocks;                       // one divide per stage
        const int ci = (ks - tap * p.cblocks) * BKC + j * 8;
        const int dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
        const bool cin_ok = ci < p.Cin;
        const uint32_t sa = base + slot * SB + chunk_off;
        const uint32_t sb = base + slot * SB + A_BYTES + chunk_off;
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i) {
            const int iy = py[i] + dy, ix = px[i] + dx;
            const bool ok = cin_ok && pb[i] >= 0 && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
            const bf16* src = ok ? p.x + (((size_t)pb[i] * p.H + iy) * p.W + ix) * p.Cin + ci : p.x;
            cp_async16(sa + i * 32 * 128, src, ok);
        }
#pragma unroll
        for (int i = 0; i < B_ROWS; ++i) {
            const int n = n0 + r0 + 32 * i;
            const bool ok = cin_ok && n < N;
            const bf16* src = ok ? p.w + ((size_t)n * 9 + tap) * p.Cin + ci : p.w;
            cp_async16(sb + i * 32 * 128, src, ok);
        }
    };

    constexpr int WN = wgmma_n<BN>(), NW = BN / WN;
    float acc[NW][WN / 2];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < WN / 2; ++i) acc[w][i] = 0.f;
    const int wg = tid >> 7;

#pragma unroll
    for (int s = 0; s < S - 2; ++s) {
        if (s < nk) load_stage(s, ks0 + s);
        cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
        cp_async_wait<S - 3>();          // this thread's copies of stage i have landed
        fence_proxy_async();
        __syncthreads();                 // everyone's have; every wgmma of step i - 2 is done
        const uint32_t sa = base + (i % S) * SB;
        const uint64_t da = smem_desc<128>(sa + wg * 64 * 128, 16, 1024);
        const uint64_t db = smem_desc<128>(sa + A_BYTES, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int w = 0; w < NW; ++w) fence_operands(acc[w]);
#pragma unroll
        for (int kk = 0; kk < BKC / 16; ++kk)
#pragma unroll
            for (int w = 0; w < NW; ++w)   // B rows w * WN.. start w * WN * 128 bytes on
                Wgmma<WN>::mma(acc[w], da + 2 * kk, db + 2 * kk + w * WN * 8);
        wgmma_commit();
#pragma unroll
        for (int w = 0; w < NW; ++w) fence_operands(acc[w]);
        wgmma_wait<1>();                 // this warpgroup's products of step i - 1 are done
        if (i + S - 2 < nk) load_stage((i + S - 2) % S, ks0 + i + S - 2);
        cp_async_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int w = 0; w < NW; ++w) fence_operands(acc[w]);

    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int jn = 0; jn < WN / 8; ++jn) {
                const int col = n0 + w * WN + jn * 8 + 2 * t;
                if (col >= N) continue;  // N is even, so col + 1 < N too
                const float y0 = acc[w][jn * 4 + 2 * h], y1 = acc[w][jn * 4 + 2 * h + 1];
                if (p.ws)
                    store2(p.ws + ((size_t)blockIdx.z * M + row) * N + col, y0, y1);
                else
                    epilogue_store<OutT>(p, row, col, y0, y1);
            }
    }
}

// The split partial sums [splits, M, N], added in split order, then the
// epilogue; one thread per pair of columns.
template <typename OutT>
__global__ void __launch_bounds__(THREADS) conv3x3_splitk_reduce(ConvParams p) {
    const int N = p.Cout;
    const size_t M = (size_t)p.B * p.H * p.W, plane = M * N, pairs = plane / 2;
    for (size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x; idx < pairs;
         idx += (size_t)gridDim.x * THREADS) {
        const size_t e = idx * 2;
        float y0 = 0.f, y1 = 0.f;
        for (int s = 0; s < p.splits; ++s) {
            const float2 v = *reinterpret_cast<const float2*>(p.ws + s * plane + e);
            y0 += v.x;
            y1 += v.y;
        }
        epilogue_store<OutT>(p, (int)(e / N), (int)(e % N), y0, y1);
    }
}

template <int BN, typename OutT>
int launch(const ConvParams& p, cudaStream_t s) {
    constexpr int smem = smem_bytes<BN>();
    auto kern = conv3x3_wgmma_kernel<BN, OutT>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int M = p.B * p.H * p.W;
    dim3 grid((p.Cout + BN - 1) / BN, (M + BM - 1) / BM, p.splits);
    kern<<<grid, THREADS, smem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
    const size_t pairs = (size_t)M * p.Cout / 2, needed = (pairs + THREADS - 1) / THREADS;
    const int blocks = (int)(needed < 132 * 8 ? needed : 132 * 8);
    conv3x3_splitk_reduce<OutT><<<blocks, THREADS, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_bn(const ConvParams& p, int bn, cudaStream_t s) {
    switch (bn) {
        case 128: return launch<128, OutT>(p, s);
        case 160: return launch<160, OutT>(p, s);
        case 320: return launch<320, OutT>(p, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace
}  // namespace hcp

// x [B, H, W, Cin], w [Cout, 3, 3, Cin]: bf16. bias [Cout], row_bias
// [B, Cout], res [B, H, W, Cout] (each may be null) and out [B, H, W,
// Cout]: bf16, or fp32 when out_f32 != 0. All contiguous; x, w, res and
// out 16-byte aligned; Cin % 8 == 0, Cout % 2 == 0. bn is 128, 160 or
// 320; with splits > 1, workspace holds splits * B*H*W * Cout floats
// (otherwise it may be null), and 1 <= splits <= 9 * ceil(Cin / 64).
// Returns cudaGetLastError(), or the error of setting the kernel's shared
// memory size, or cudaErrorInvalidValue for another bn or splits.
extern "C" int hcp_conv3x3(const void* x, const void* w, const void* bias, const void* row_bias,
                           const void* res, void* out, void* workspace, int B, int H, int W,
                           int Cin, int Cout, int bn, int splits, int out_f32, void* stream) {
    using namespace hcp;
    ConvParams p;
    p.x = static_cast<const bf16*>(x);
    p.w = static_cast<const bf16*>(w);
    p.bias = bias;
    p.row_bias = row_bias;
    p.res = res;
    p.out = out;
    p.B = B;
    p.H = H;
    p.W = W;
    p.Cin = Cin;
    p.Cout = Cout;
    p.cblocks = (Cin + BKC - 1) / BKC;
    p.ksteps = 9 * p.cblocks;
    p.splits = splits;
    p.ws = splits > 1 ? static_cast<float*>(workspace) : nullptr;
    if (splits < 1 || splits > p.ksteps || (splits > 1 && workspace == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return out_f32 ? launch_bn<float>(p, bn, s) : launch_bn<bf16>(p, bn, s);
}
