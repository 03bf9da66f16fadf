// Tile primitives for the Hopper attention kernels (sm_90a): asynchronous
// global -> shared copies, ldmatrix and the bf16 tensor-core product
// mma.sync.m16n8k16 with f32 accumulation.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, c = lane % 4), each
// 32-bit register holding two bf16 values, the lower column first:
//   A 16x16 (row-major): a0 (row g, cols 2c..2c+1), a1 (row g+8, same
//     cols), a2 (row g, cols 2c+8..2c+9), a3 (row g+8, cols 2c+8..2c+9);
//   B 16x8 (column-major): b0 (rows 2c..2c+1, col g), b1 (rows 2c+8..,
//     col g);
//   C 16x8 f32: c0, c1 (row g, cols 2c, 2c+1), c2, c3 (row g+8, same).
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16,
// are the A fragment of a 16-deep product (pack_bf16x2 below): a softmax
// output never leaves the registers on its way into the next product.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace devqa {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared, bypassing L1; when `in` is false nothing
// is read and the 16 bytes are zero-filled (src must still be valid).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4-byte copy global -> shared (any 4-byte-aligned address), zero-filled
// when `in` is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

// Closes the group of this thread's copies issued since the last commit
// (an empty group is legal and completes at once).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the
// shared-window addresses of matrix i's rows (16 bytes each); register i
// holds matrix i's fragment (lane l: row l / 4, elements 2(l % 4),
// 2(l % 4) + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same, each matrix transposed (lane l: column l / 4, rows 2(l % 4),
// 2(l % 4) + 1): the B fragment of a row-major [k][n] operand.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a * b on the tensor cores: bf16 16x16 by 16x8, f32 16x8.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (flushes subnormal results to zero).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to bf16 in one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace devqa
