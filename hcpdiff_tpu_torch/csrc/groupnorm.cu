// Kernel D: GroupNorm with fp32 statistics, affine, optional SiLU, on a
// channels-last tensor x [B, S, C] of type T (bf16, or fp32: an fp32 model
// reads, normalises and writes fp32), with scale and bias [C] of type P
// (bf16 or fp32, read as they are: no cast kernel beside the launch).
//
// Replaces hcpdiff_tpu/ops/groupnorm.py:_gn_silu_kernel (#12, :22, via
// _gn_silu_pallas_raw :125 and group_norm_silu :281), and the streaming
// pair _gn_stats_kernel / _gn_apply_kernel (#13, :177 / :204), which
// compute the same function in two passes for large S.
//
// What bounds it on the H100: bytes. It does about ten fp32 operations an
// element, so the least time is one read of x and one write of y at
// 3.35 TB/s. The TPU kernel kept one sample's [S, C] block in VMEM for one
// round trip; here a sample is spread over many SMs, so the design is:
//   - one cooperative launch a call (cudaLaunchAttributeCooperative): B *
//     nb blocks, at most one an SM, all resident at once; block (b, k)
//     owns rows [k * rows, (k + 1) * rows) of sample b, one contiguous span
//     of bytes;
//   - pass 1 brings the span into shared memory with 1-D bulk copies
//     (cp.async.bulk, completed on an mbarrier a slot), in chunks of about
//     CHUNK_BYTES, and sums x and x*x per channel (fp32, in registers: a
//     thread owns 8 channels) as the chunks land; the block folds its sums
//     into groups in a fixed order and writes its [2, G] partial sums;
//   - the nb blocks of a sample meet at a barrier (two counters and a
//     generation word a sample in a buffer that lives across calls: a call
//     counts on the counter the generation's parity names and zeroes the
//     other, which the call before used, so no memset launch); then
//     every block reduces all nb partials of its sample in double, in the
//     same fixed order, so every block gets the same mean and rstd and the
//     output is bitwise the same from run to run;
//   - pass 2 normalises from shared memory and writes y with 16-byte
//     stores. Where the span fits the slots (the resident regime) x is
//     read once: the bound itself. Where it does not (the re-read regime)
//     the ring of slots holds the span's last chunks after pass 1; pass 2
//     takes those first and reads the others again (from L2 where x fits
//     its 50 MB).
// The variance is E[x^2] - E[x]^2 clamped at 0, as _gn_silu_xla_direct
// (:116) computes it; rstd = rsqrt(var + eps); y = x * a + c with a =
// rstd * scale, c = bias - mean * a; then SiLU if asked.
//
// The launch plan (blocks a sample, rows a block, chunk rows, slots,
// threads, shared memory) is ops/groupnorm.py:gn_plan, within the limits
// of the HCP_GN_LIMITS table, which the CPU tests read from this source.
#include "common.cuh"

namespace hcp {
namespace {

// X(NAME, VALUE): the kernel's limits.
//   MAX_THREADS    threads a block (registers: 65536 / 640 = 102 a thread)
//   BLOCKS_PER_SM  blocks an SM (the grid is at most SMs * this)
//   MAX_SMEM       shared memory a block may use (227 KB)
//   MAX_SLOTS      chunk slots a block (one mbarrier and one phase bit each)
//   CHUNK_BYTES    the bytes of x a chunk holds, about
#define HCP_GN_LIMITS(X)  \
    X(MAX_THREADS, 640)   \
    X(BLOCKS_PER_SM, 1)   \
    X(MAX_SMEM, 232448)   \
    X(MAX_SLOTS, 32)      \
    X(CHUNK_BYTES, 32768)

#define HCP_GN_DEFINE(name, value) constexpr int GN_##name = value;
HCP_GN_LIMITS(HCP_GN_DEFINE)
#undef HCP_GN_DEFINE

constexpr int MAX_TX_BYTES = (1 << 20) - 1;   // an mbarrier's transaction count
static_assert(GN_CHUNK_BYTES % 16 == 0 && GN_CHUNK_BYTES <= MAX_TX_BYTES, "a chunk's bulk copy");

__host__ __device__ constexpr int align128(int n) { return (n + 127) & ~127; }

// Shared memory: MAX_SLOTS mbarriers; the block's per-thread (sum, sum of
// squares) of 8 channels as [8, threads + 2] float2 (the 2 spread a column
// of channels over the banks); [2, G] fp32 mean and rstd; the chunk slots.
struct Layout {
    int scratch, stats, data, total;
};

__host__ __device__ inline Layout smem_layout(int threads, int G, int slots, int slot_bytes) {
    Layout l;
    l.scratch = align128(GN_MAX_SLOTS * 8);
    l.stats = l.scratch + align128(8 * (threads + 2) * 8);
    l.data = l.stats + align128(8 * G);
    l.total = l.data + slots * slot_bytes;
    return l;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16, 16-byte aligned ends) global -> shared, counted
// on `bar`, which this thread arrives on with the byte count
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

// The barrier's memory operations: an acquiring load and a releasing add
// (CUTLASS's grid barrier has the same shape)
__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
    unsigned int v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ void red_add_release(unsigned int* p, unsigned int v) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

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

// SiLU. bf16 output: y * sigmoid(y) = h + h * tanh(h) with h = y / 2, one
// MUFU op (tanh.approx, relative error ~2^-11, below bf16's 2^-9); the
// exp and the division took pass 2 from the memory's time to the ALUs'.
// fp32 output: y / (1 + e^-y), as the plain version.
__device__ __forceinline__ float silu_of(float y, bf16*) {
    const float h = 0.5f * y;
    float t;
    asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
    return fmaf(h, t, h);
}
__device__ __forceinline__ float silu_of(float y, float*) { return y / (1.f + __expf(-y)); }

// Block (b, k) of the grid B * nb: rows [k * rows, min(S, (k + 1) * rows))
// of sample b. Thread t < vr * rpp owns the 8 channels of vector t % vr on
// rows t / vr, t / vr + rpp, ... of every chunk (vr = C / 8), so a warp's
// 16-byte accesses are contiguous in shared and global memory; threads
// past vr * rpp (the block rounded up to whole warps) only help reduce.
template <typename T, typename P>
__global__ void __launch_bounds__(GN_MAX_THREADS, GN_BLOCKS_PER_SM)
gn_kernel(const T* __restrict__ x, const P* __restrict__ scale, const P* __restrict__ bias,
          T* __restrict__ y, float* __restrict__ partial, unsigned int* __restrict__ counters,
          int S, int C, int G, int nb, int rows, int chunk_rows, int slots, int rpp, float eps,
          int silu) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int threads = blockDim.x, tid = threadIdx.x;
    const int vr = C / 8, v = tid % vr, j = tid / vr;
    const bool on = tid < vr * rpp;
    const int b = blockIdx.x / nb, blk = blockIdx.x % nb;
    const int r0 = blk * rows, nrows = min(rows, S - r0);
    const int nchunks = (nrows + chunk_rows - 1) / chunk_rows;
    const int K = min(slots, nchunks);              // slots this block uses
    const size_t slot_elems = (size_t)chunk_rows * C;
    const Layout L = smem_layout(threads, G, slots, (int)(slot_elems * sizeof(T)));
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    float2* scratch = reinterpret_cast<float2*>(smem + L.scratch);
    float* gstat = reinterpret_cast<float*>(smem + L.stats);    // [G] mean, [G] rstd
    T* data = reinterpret_cast<T*>(smem + L.data);
    const size_t span = ((size_t)b * S + r0) * C;
    const T* xs = x + span;
    T* ys = y + span;

    auto chunk_len = [&](int c) { return min(chunk_rows, nrows - c * chunk_rows); };
    auto load = [&](int c, int slot) {      // one thread: chunk c into slot
        bulk_load(data + slot * slot_elems, xs + (size_t)c * chunk_rows * C,
                  (uint32_t)(chunk_len(c) * C * sizeof(T)), bars + slot);
    };

    if (tid == 0) {
        for (int s = 0; s < K; ++s) mbar_init(bars + s);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
        for (int s = 0; s < K; ++s) load(s, s);
    // The sample's barrier, counters[4b..4b+2] = {count 0, count 1,
    // generation}: a launch arrives on count (generation & 1) and waits for
    // it to reach nb; its block 0 zeroes the other count (the previous
    // launch's, done by now) and, past the barrier, moves the generation on.
    unsigned int* bar_count = counters + 4 * b;
    unsigned int gen0 = 0;
    if (tid == 0) {
        gen0 = ld_acquire(counters + 4 * b + 2);
        if (blk == 0) *reinterpret_cast<volatile unsigned int*>(bar_count + (~gen0 & 1u)) = 0u;
        bar_count += gen0 & 1u;
    }
    // this thread's scale and bias, read while the chunks are in flight
    float A[8], Cc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        A[i] = as_float(scale[v * 8 + i]);
        Cc[i] = as_float(bias[v * 8 + i]);
    }

    // Pass 1: per-channel sums as the chunks land (chunk c in slot c % K).
    float s8[8], q8[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s8[i] = q8[i] = 0.f;
    uint32_t phase = 0;                             // a parity bit a slot
    for (int c = 0; c < nchunks; ++c) {
        const int slot = c % K;
        mbar_wait(bars + slot, (phase >> slot) & 1u);
        phase ^= 1u << slot;
        if (on) {
            const T* d = data + slot * slot_elems + v * 8;
            const int n = chunk_len(c);
            for (int r = j; r < n; r += rpp) {
                float f[8];
                load8(d + (size_t)r * C, f);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    s8[i] += f[i];
                    q8[i] = fmaf(f[i], f[i], q8[i]);
                }
            }
        }
        if (c + K < nchunks) {                      // refill the slot once all have read it
            __syncthreads();
            if (tid == 0) load(c + K, slot);
        }
    }

    // The block's group sums, in a fixed order: the threads' 8-channel sums
    // go to the scratch; then gp threads a group (gp a power of two, gp * G <=
    // threads) each add the rpp row offsets of every gp-th channel of the
    // group, and the gp lanes add theirs up in a fixed butterfly.
    const int cg = C / G, ld = threads + 2;
    const int g_first = v * 8 / cg, g_left = cg - v * 8 % cg;   // this thread's first group
    int gp = 1;
    while (gp < 32 && 2 * gp * G <= threads) gp *= 2;
    const int lp = __ffs(gp) - 1, busy = (G * gp + 31) / 32 * 32;  // whole warps
    if (on) {
#pragma unroll
        for (int i = 0; i < 8; ++i) scratch[i * ld + tid] = make_float2(s8[i], q8[i]);
    }
    __syncthreads();
    float* out = partial + (size_t)b * nb * 2 * G + blk;      // [2, G, nb] a sample
    for (int t = tid; t < busy; t += threads) {
        const int g = t >> lp, p = t & (gp - 1);
        float2 a = make_float2(0.f, 0.f);
        if (g < G) {
            for (int n = p; n < cg; n += gp) {
                const int ch = g * cg + n;
                const float2* col = scratch + (ch % 8) * ld + ch / 8;
#pragma unroll 4
                for (int jj = 0; jj < rpp; ++jj) {
                    const float2 x = col[jj * vr];
                    a.x += x.x;
                    a.y += x.y;
                }
            }
        }
        for (int o = gp / 2; o > 0; o >>= 1) {
            a.x += __shfl_xor_sync(0xffffffffu, a.x, o);
            a.y += __shfl_xor_sync(0xffffffffu, a.y, o);
        }
        if (g < G && p == 0) {
            out[g * nb] = a.x;
            out[(G + g) * nb] = a.y;
        }
    }
    __syncthreads();

    // The barrier: this block's partial sums, released with its arrival.
    if (tid == 0) {
        red_add_release(bar_count, 1u);
        while (ld_acquire(bar_count) < (unsigned int)nb) {
        }
        if (blk == 0) *reinterpret_cast<volatile unsigned int*>(counters + 4 * b + 2) = gen0 + 1u;
    }
    __syncthreads();

    // Every block of the sample reduces the same nb partials the same way:
    // gp threads a group each add every gp-th block's, in double, then the
    // butterfly (a group's partials are contiguous: the loads coalesce).
    const float* part = partial + (size_t)b * nb * 2 * G;
    for (int t = tid; t < busy; t += threads) {
        const int g = t >> lp, p = t & (gp - 1);
        double a = 0.0, a2 = 0.0;
        if (g < G) {
            for (int k = p; k < nb; k += gp) {
                a += (double)__ldcg(part + (size_t)g * nb + k);
                a2 += (double)__ldcg(part + (size_t)(G + g) * nb + k);
            }
        }
        for (int o = gp / 2; o > 0; o >>= 1) {
            a += __shfl_xor_sync(0xffffffffu, a, o);
            a2 += __shfl_xor_sync(0xffffffffu, a2, o);
        }
        if (g < G && p == 0) {
            const double n = (double)S * cg;
            const double mean = a / n, var = a2 / n - mean * mean;
            gstat[g] = (float)mean;
            gstat[G + g] = rsqrtf((float)(var > 0.0 ? var : 0.0) + eps);
        }
    }
    __syncthreads();

    int g = g_first, left = g_left;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        A[i] *= gstat[G + g];                       // rstd * scale
        Cc[i] -= gstat[g] * A[i];                   // bias - mean * a
        if (--left == 0) {
            ++g;
            left = cg;
        }
    }

    // Pass 2: position t takes the chunks still in the slots first (the
    // last K, chunk nchunks - K + t), then chunk t - K, reloaded into the
    // slot position t - K freed: slot (nchunks + t) % K either way.
    for (int t = 0; t < nchunks; ++t) {
        const int c = t < K ? nchunks - K + t : t - K;
        const int slot = (nchunks + t) % K;
        if (t >= K) {
            mbar_wait(bars + slot, (phase >> slot) & 1u);
            phase ^= 1u << slot;
        }
        if (on) {
            const T* d = data + slot * slot_elems + v * 8;
            T* o = ys + (size_t)c * chunk_rows * C + v * 8;
            const int n = chunk_len(c);
#pragma unroll 4
            for (int r = j; r < n; r += rpp) {
                float f[8];
                load8(d + (size_t)r * C, f);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float yi = fmaf(f[i], A[i], Cc[i]);
                    f[i] = silu ? silu_of(yi, static_cast<T*>(nullptr)) : yi;
                }
                store8(o + (size_t)r * C, f);
            }
        }
        if (t + K < nchunks) {
            __syncthreads();
            if (tid == 0) load(t, slot);
        }
    }
}

template <typename T, typename P>
int launch(const void* x, const void* scale, const void* bias, void* y, void* partial,
           void* counters, int B, int S, int C, int G, int nb, int rows, int chunk_rows,
           int slots, int rpp, int threads, int smem, float eps, int silu, cudaStream_t s) {
    const int vr = C / 8;
    const long long slot_bytes = (long long)chunk_rows * C * sizeof(T);
    const bool ok = C % 8 == 0 && G >= 1 && C % G == 0 && rpp >= 1
        && vr * rpp <= GN_MAX_THREADS && threads == (vr * rpp + 31) / 32 * 32
        && B >= 1 && nb >= 1 && rows >= 1 && (long long)(nb - 1) * rows < S
        && (long long)nb * rows >= S && chunk_rows >= 1 && chunk_rows <= rows
        && slots >= 1 && slots <= GN_MAX_SLOTS && slot_bytes <= MAX_TX_BYTES
        && (long long)B * nb * 2 * G < (1LL << 31)
        && smem == smem_layout(threads, G, slots, (int)slot_bytes).total && smem <= GN_MAX_SMEM;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = gn_kernel<T, P>;
    // the most shared memory the instance may take, once a device
    static uint32_t set_on = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 32 || !((set_on >> dev) & 1u)) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   GN_MAX_SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (dev < 32) set_on |= 1u << dev;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;   // all blocks resident, or refused
    attr[0].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * nb);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const P*>(scale),
                             static_cast<const P*>(bias), static_cast<T*>(y),
                             static_cast<float*>(partial), static_cast<unsigned int*>(counters),
                             S, C, G, nb, rows, chunk_rows, slots, rpp, eps, silu);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hcp

// x, y [B, S, C]: bf16, or fp32 when x_f32 != 0; contiguous, 16-byte
// aligned, C % 8 == 0, C % G == 0; scale, bias [C]: bf16, or fp32 when
// p_f32 != 0. The plan (ops/groupnorm.py:gn_plan): nb blocks a sample of
// `rows` rows each (the last may be shorter, none empty), chunks of
// chunk_rows rows in `slots` slots, rpp rows read at once, `threads` =
// C / 8 * rpp rounded up to whole warps, `smem` bytes. partial: B * nb * 2 *
// G floats; counters: 4 * B unsigned ints, zero before the first call and
// kept by the kernel from call to call (calls that share them must not
// overlap). Returns
// cudaErrorInvalidValue for a plan outside these rules, else the launch's
// error (cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// resident at once) or cudaGetLastError().
extern "C" int hcp_group_norm(const void* x, const void* scale, const void* bias, void* y,
                              void* partial, void* counters, int B, int S, int C, int G, int nb,
                              int rows, int chunk_rows, int slots, int rpp, int threads,
                              int smem, float eps, int silu, int x_f32, int p_f32,
                              void* stream) {
    using namespace hcp;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HCP_GN_LAUNCH(T, P)                                                                   \
    launch<T, P>(x, scale, bias, y, partial, counters, B, S, C, G, nb, rows, chunk_rows, slots, \
                 rpp, threads, smem, eps, silu, s)
    if (x_f32) return p_f32 ? HCP_GN_LAUNCH(float, float) : HCP_GN_LAUNCH(float, bf16);
    return p_f32 ? HCP_GN_LAUNCH(bf16, float) : HCP_GN_LAUNCH(bf16, bf16);
#undef HCP_GN_LAUNCH
}
