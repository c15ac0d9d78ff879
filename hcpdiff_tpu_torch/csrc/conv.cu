// Kernel J (conv3x3): 3x3 stride-1 SAME convolution of an NHWC bf16 image
// with an OHWI weight, + bias, + a per-sample row bias, + a residual, all
// added in fp32 and rounded to bf16 once.
//
// Replaces hcpdiff_tpu/ops/conv.py:_conv3_kernel (:48, via _conv3_pallas
// :80 and conv3x3 :235).
//
// What bounds it on the H100: at the UNet resblocks' shapes (B = 8, 64x64
// .. 8x8 pixels, Cin 320..2560, Cout 320..1280) a conv does 2 * 9 * Cin
// FLOPs per output for 2 * (Cin + Cout) bytes per pixel, far above the 295
// FLOP/byte ridge: the tensor cores bound it. The time-embedding add
// (after conv1) and the skip add (after conv2) are memory traffic that two
// elementwise passes would add on top; the design keeps them in the
// epilogue.
//
// Design: an implicit GEMM, out[M = B*H*W, N = Cout] = A[M, 9*Cin] x
// W[Cout, 9*Cin]^T, where row m of A is the 3x3 window of pixel m, tap by
// tap: k = (ky * 3 + kx) * Cin + ci. That is the byte order of the weight
// in OHWI (a channels_last nn.Conv2d weight), so W is read as a plain
// [Cout, 9*Cin] matrix; the A-stage loader gathers each 16-byte chunk from
// the shifted pixel (y + ky - 1, x + kx - 1) and zero-fills it through
// cp.async's source size where that pixel lies outside the image, so no
// padded copy is made. The TPU kernel's trick (pad the image, flatten it,
// and take every tap as one contiguous slice with junk columns) and its
// VMEM gate, which sent large images to XLA, have no reason here: every
// shape runs this kernel. Same main loop as the GEMMs (gemm_tile.cuh).
#include "gemm_tile.cuh"

namespace hcp {
namespace {

struct ConvParams {
    const bf16* x;              // [B, H, W, Cin]
    const bf16* w;              // [Cout, 3, 3, Cin]
    const bf16* bias;           // [Cout] or null
    const bf16* row_bias;       // [B, Cout] or null
    const bf16* res;            // [B, H, W, Cout] or null
    bf16* out;                  // [B, H, W, Cout]
    int B, H, W, Cin, Cout;
};

__global__ void __launch_bounds__(THREADS) conv3x3_kernel(ConvParams p) {
    __shared__ __align__(16) TileSmem sm;

    const int M = p.B * p.H * p.W, K = 9 * p.Cin, N = p.Cout;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * 128;

    // the pixels of this thread's A rows, fixed over the K loop
    int pb[A_CHUNKS], py[A_CHUNKS], px[A_CHUNKS];
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
        const int m = m0 + a_chunk_row(i);
        const int hw = p.H * p.W;
        pb[i] = m < M ? m / hw : -1;
        py[i] = (m % hw) / p.W;
        px[i] = m % p.W;
    }
    auto fill_a = [&](bf16* s, int k0) {
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
            const int r = a_chunk_row(i), kc = a_chunk_col(i);
            const int k = k0 + kc;
            const int tap = k / p.Cin, ci = k - tap * p.Cin;
            const int iy = py[i] + tap / 3 - 1, ix = px[i] + tap % 3 - 1;
            const bool ok = pb[i] >= 0 && k < K && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
            const bf16* src =
                ok ? p.x + (((size_t)pb[i] * p.H + iy) * p.W + ix) * p.Cin + ci : p.x;
            cp_async16(&s[r * LDS + kc], src, ok);
        }
    };
    auto no_prep = [](bf16*, int) {};

    float acc[2][8][4];
    mainloop<false>(acc, sm, p.w, N, K, n0, fill_a, no_prep);

    // Epilogue: acc + bias + row_bias, then + res, in fp32; one bf16 store.
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
    const int hw = p.H * p.W;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm * 32 + mi * 16 + g + h * 8;
            if (row >= M) continue;
            const int b = row / hw;
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
                const int col = n0 + wn * 64 + ni * 8 + 2 * t;
                if (col >= N) continue;
                float y0 = acc[mi][ni][2 * h], y1 = acc[mi][ni][2 * h + 1];
                if (p.bias) {
                    y0 += __bfloat162float(p.bias[col]);
                    y1 += __bfloat162float(p.bias[col + 1]);
                }
                if (p.row_bias) {
                    y0 += __bfloat162float(p.row_bias[(size_t)b * N + col]);
                    y1 += __bfloat162float(p.row_bias[(size_t)b * N + col + 1]);
                }
                if (p.res) {
                    __nv_bfloat162 r2 =
                        *reinterpret_cast<const __nv_bfloat162*>(p.res + (size_t)row * N + col);
                    y0 += __low2float(r2);
                    y1 += __high2float(r2);
                }
                store_bf16x2(p.out + (size_t)row * N + col, y0, y1);
            }
        }
    }
}

}  // namespace
}  // namespace hcp

// x [B, H, W, Cin], w [Cout, 3, 3, Cin], bias [Cout] or null, row_bias
// [B, Cout] or null, res [B, H, W, Cout] or null, out [B, H, W, Cout]; all
// bf16, contiguous, 16-byte aligned; Cin % 8 == 0, Cout % 2 == 0.
// Returns cudaGetLastError().
extern "C" int hcp_conv3x3(const void* x, const void* w, const void* bias, const void* row_bias,
                           const void* res, void* out, int B, int H, int W, int Cin, int Cout,
                           void* stream) {
    using namespace hcp;
    ConvParams p;
    p.x = static_cast<const bf16*>(x);
    p.w = static_cast<const bf16*>(w);
    p.bias = static_cast<const bf16*>(bias);
    p.row_bias = static_cast<const bf16*>(row_bias);
    p.res = static_cast<const bf16*>(res);
    p.out = static_cast<bf16*>(out);
    p.B = B;
    p.H = H;
    p.W = W;
    p.Cin = Cin;
    p.Cout = Cout;
    const int M = B * H * W;
    dim3 grid((Cout + 127) / 128, (M + BM - 1) / BM);
    conv3x3_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
