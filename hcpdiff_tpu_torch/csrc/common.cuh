// Shared device helpers for the hand-written Hopper kernels (sm_90a).
//
// The kernels use cp.async for global -> shared copies and bf16 tensor-core
// products with fp32 accumulation: the warp-level mma.sync.m16n8k16 (E and
// F at D=512), or the warpgroup-level wgmma (A-C, E-J; wgmma.cuh).
// mma.sync's fragment layouts (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..2t+1)
//                         a2 = (g, 2t+8..+9)   a3 = (g+8, 2t+8..+9)
//   B (16x8, "col"):      b0 = (k=2t..2t+1, n=g)   b1 = (k=2t+8..+9, n=g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1)   c2,c3 = (g+8, 2t..2t+1)
// So both operands are read from shared tiles stored K-contiguous: A as
// [rows][k] and B as [n][k]. Each register holds two bf16 with the lower
// column in the lower 16 bits, which is the order they sit in memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hcp {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared. When `pred` is false nothing is read
// and the 16 shared bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
    int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(smem)), "l"(gmem), "r"(n));
}

// The same, to a shared-memory address given as a 32-bit shared-window offset.
__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem, bool pred) {
    int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// 4-byte async copy global -> shared (zero-filled when `pred` is false).
__device__ __forceinline__ void cp_async4(uint32_t smem, const void* gmem, bool pred) {
    int n = pred ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem), "l"(gmem), "r"(n));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// d += a (16x16 bf16) * b (16x8 bf16), fp32 accumulate.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of the 16x16 tile at (r0, k0) of a row-major shared tile.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int ld, int r0, int k0,
                                       int g, int t) {
    a[0] = ld32(s + (r0 + g) * ld + k0 + 2 * t);
    a[1] = ld32(s + (r0 + g + 8) * ld + k0 + 2 * t);
    a[2] = ld32(s + (r0 + g) * ld + k0 + 8 + 2 * t);
    a[3] = ld32(s + (r0 + g + 8) * ld + k0 + 8 + 2 * t);
}

// B fragment of the 16x8 tile at (k0, n0) of a shared tile stored [n][k].
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* s, int ld, int n0, int k0,
                                       int g, int t) {
    b[0] = ld32(s + (n0 + g) * ld + k0 + 2 * t);
    b[1] = ld32(s + (n0 + g) * ld + k0 + 8 + 2 * t);
}

// 2^x on the MUFU unit (relative error ~2^-22; -inf gives +0).
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// Epilogue inputs and outputs of type T (bf16, or fp32 for an fp32 call):
// read as float, and a pair of adjacent columns stored in one access.
__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float as_float(float v) { return v; }

__device__ __forceinline__ void store2(bf16* p, float lo, float hi) { store_bf16x2(p, lo, hi); }
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}

}  // namespace hcp
