// Hopper warpgroup matrix products (wgmma, sm_90a) over swizzled
// shared-memory tiles, for kernels J (conv.cu), A (flash_attention.cu), E
// and F (flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu), B and C
// (gemm_wgmma.cu), G, H and I (ln_gemm_wgmma.cu) and, over int8, L
// (int8_gemm.cu: Wgmma8).
//
// Layouts. A tile of R rows is stored as blocks of R rows x SW bytes (SW =
// 128, 64 or 32: 64, 32 or 16 bf16 columns), each block at an address
// aligned to 8 * SW; the 16-byte chunk c of row r of a block lies at
// r * SW + ((c ^ ((r * SW / 128) % (SW / 16))) * 16) (swz_offset), which
// is the hardware's swizzle of the address bits (4.. XOR 7..), the layout
// TMA's CU_TENSOR_MAP_SWIZZLE_{128,64,32}B writes. Rows of 128 bytes (SW =
// 128, J's only layout) need a column count divisible by 64; 64- and
// 32-byte rows serve head dims such as 160 and 48/80.
//
// Descriptors (smem_desc): start address >> 4, leading byte offset >> 4
// (bits 16-29), stride byte offset >> 4 (bits 32-45), layout type in bits
// 62-63 (1: 128-byte swizzle, 2: 64, 3: 32).
//   - K-major operand (the K dim along a row; A and B of Q K^T, J's A and
//     B): stride offset 8 * SW (one 8-row group), leading offset unused
//     (1). The k-th 16-deep slice starts in block k / (SW / 32), 32 * (k %
//     (SW / 32)) bytes into it: the hardware applies the swizzle to the
//     address it computes, so the start simply advances.
//   - MN-major B (N along a row, read with the transpose bit; V in O += P
//     V, stored [key][d]): leading offset = the bytes of one block (the
//     next SW / 2 columns of N), stride offset 8 * SW (the next 8 rows of
//     K); the 16-deep slice k starts 16 * k rows into the tile.
//
// Wgmma<N>::mma(d, a, b, scale_d): d[64 x N] (+)= A[64 x 16] * B[N x 16]^T,
// A and B both K-major in shared memory (N 32, 48, 64, 128, 160);
// scale_d = 0 ignores d's old value.
// WgmmaRS<N>::mma(d, a, b): d[64 x N] += A[64 x 16] * B[16 x N], A from
// registers (the mma.sync m16n8k16 A fragment of each warp's 16 rows: a0 =
// (g, 2q..2q+1), a1 = (g+8, ..), a2 = (g, 2q+8..), a3 = (g+8, 2q+8..)), B
// MN-major in shared memory. fp32 accumulators in both: thread t of the
// warpgroup (warp w = t / 32, g = (t % 32) / 4, q = t % 4) holds d[i] at
// row w * 16 + g + 8 * ((i / 2) % 2), column (i / 4) * 8 + 2 * q + i % 2:
// the mma.sync C fragment repeated over N / 8 column tiles.
#pragma once

#include "common.cuh"

namespace hcp {

// The descriptor of a tile in the SW-byte swizzled layout at shared address
// `smem`, with leading and stride byte offsets `lbo` and `sbo`.
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t smem, uint32_t lbo, uint32_t sbo) {
    static_assert(SW == 128 || SW == 64 || SW == 32, "swizzle width is 128, 64 or 32 bytes");
    constexpr uint64_t mode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
    return static_cast<uint64_t>((smem & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
           (uint64_t(sbo >> 4) << 32) | (mode << 62);
}

// Byte offset of the 16-byte chunk c of row r in a block of SW-byte rows.
template <int SW>
__device__ __forceinline__ uint32_t swz_offset(int r, int c) {
    return r * SW + ((c ^ ((r * SW / 128) % (SW / 16))) << 4);
}

// Make the generic-proxy writes to shared memory (cp.async's) visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Rows r0.. (< S) and columns col0..col0 + NCOL (< D) of a [S, D] bf16
// matrix with row stride ss into a tile of R rows at shared address dst,
// in the SW-byte swizzled layout (blocks of R rows x SW / 2 columns, block
// stride R * SW), by THREADS threads with 16-byte cp.async; zero-filled
// past S and past D.
template <int SW, int THREADS, int R, int NCOL>
__device__ __forceinline__ void load_swizzled(uint32_t dst, const bf16* src, long long ss,
                                              int r0, int S, int col0, int D, int tid) {
    constexpr int NC = NCOL / 8, CPB = SW / 16, TOTAL = R * NC;
#pragma unroll
    for (int i = 0; i < (TOTAL + THREADS - 1) / THREADS; ++i) {
        const int c = tid + i * THREADS;
        if (TOTAL % THREADS != 0 && c >= TOTAL) break;
        const int r = c / NC, cc = c % NC, d = col0 + cc * 8;
        const bool ok = r0 + r < S && d < D;
        const uint32_t off = (cc / CPB) * (R * SW) + swz_offset<SW>(r, cc % CPB);
        cp_async16(dst + off, ok ? src + (r0 + r) * ss + d : src, ok);
    }
}

// Keep the compiler from moving reads or writes of accumulator (or
// register-A) registers across an asynchronous product still in flight.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_operands(uint32_t (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
    __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
            "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <>
struct Wgmma<48> {
    __device__ __forceinline__ static void mma(float (&d)[24], uint64_t a, uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23"
            "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
              "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
              "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
              "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <>
struct Wgmma<64> {
    __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
            "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <>
struct Wgmma<128> {
    __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
            "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <>
struct Wgmma<160> {
    __device__ __forceinline__ static void mma(float (&d)[80], uint64_t a, uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
            "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
            "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
              "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
              "+f"(d[78]), "+f"(d[79])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

// WgmmaRS's A operand from a [64 x N] fp32 accumulator, rounded to bf16:
// the accumulators of column tiles 2j, 2j + 1 are exactly the A fragment of
// the k16 slice j (the warpgroup's rows, columns 16j..16j + 15 as depth).
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
        a[j][0] = pack_bf16x2(x[8 * j + 0], x[8 * j + 1]);
        a[j][1] = pack_bf16x2(x[8 * j + 2], x[8 * j + 3]);
        a[j][2] = pack_bf16x2(x[8 * j + 4], x[8 * j + 5]);
        a[j][3] = pack_bf16x2(x[8 * j + 6], x[8 * j + 7]);
    }
}

template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<48> {
    __device__ __forceinline__ static void mma(float (&d)[24], const uint32_t (&a)[4],
                                               uint64_t b, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23"
            "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <>
struct WgmmaRS<64> {
    __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
            "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <>
struct WgmmaRS<80> {
    __device__ __forceinline__ static void mma(float (&d)[40], const uint32_t (&a)[4],
                                               uint64_t b, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
            "%32, %33, %34, %35, %36, %37, %38, %39"
            "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <>
struct WgmmaRS<128> {
    __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t b, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
            "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <>
struct WgmmaRS<160> {
    __device__ __forceinline__ static void mma(float (&d)[80], const uint32_t (&a)[4],
                                               uint64_t b, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
            "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
            "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
              "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
              "+f"(d[78]), "+f"(d[79])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <>
struct WgmmaRS<256> {
    __device__ __forceinline__ static void mma(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t b, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
            "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
            "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
            "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
            "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
            "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
              "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
              "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
              "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
              "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
              "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
              "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
              "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
              "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
              "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
              "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Wgmma8<N>::mma(d, a, b, scale_d): d[64 x N] (+)= A[64 x 32] * B[N x 32]^T
// over signed 8-bit operands with int32 accumulators (kernel L,
// int8_gemm.cu). For 8-bit types both operands must be K-major in shared
// memory (there is no transpose bit); a 32-deep slice is 32 bytes, as a
// 16-deep bf16 slice is, so the descriptors and swizzled layouts above
// serve unchanged. The int32 fragment has the fp32 one's layout.
template <int N>
struct Wgmma8;

template <>
struct Wgmma8<160> {
    __device__ __forceinline__ static void mma(int (&d)[80], uint64_t a, uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
            "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
            "}, %80, %81, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
              "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
              "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
              "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
              "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
              "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
              "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
              "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
              "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
              "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
              "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
              "+r"(d[78]), "+r"(d[79])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

}  // namespace hcp
