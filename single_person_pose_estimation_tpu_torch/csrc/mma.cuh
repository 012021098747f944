// Tensor-core building blocks for Hopper (sm_90a), as inline PTX:
//
//   mma_bf16       mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, one
//                  16x8 float32 tile += a 16x16 bf16 A tile times a 16x8 B
//                  tile;
//   ldmatrix_x4, ldmatrix_x4_t, ldmatrix_x2_t
//                  four (or two) 8x8 tiles of 16-bit values from shared
//                  memory, each row 16 contiguous bytes whose address one
//                  lane gives; the _t forms transpose each tile;
//   cp_async16, cp_async16_zfill, cp_async_commit, cp_async_wait(_n)
//                  16-byte copies from device memory to shared memory that
//                  bypass the registers and L1, grouped and waited for.
//
// Fragment layout of one m16n8k16 product (lane = threadIdx.x % 32,
// g = lane / 4, t = lane % 4), as the PTX ISA defines it:
//   A (16x16, row-major) a[0..3]: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
//       (g+8, 2t+8..), two bf16 in each register;
//   B (16x8, k by n)     b[0..1]: (k 2t..2t+1, n g), (k 2t+8.., n g);
//   C (16x8, float32)    c[0..3]: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// ldmatrix_x4 of the A tile takes, from lane i, the address of row i % 16
// at column (i / 16) * 8; ldmatrix_x4_t of two B tiles stored k-major (k
// rows of n values) takes the address of k row ((i / 8) % 2) * 8 + i % 8 at
// column (i / 16) * 8, and gives b[0..1] of the first tile in r[0..1] and
// of the second in r[2..3].
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace spe {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Two transposed 8x8 tiles; lanes 0-15 give the addresses.
__device__ __forceinline__ void ldmatrix_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// c += a . b on the tensor cores, float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device memory (16-byte aligned) to shared memory.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(dst), "l"(src)
               : "memory");
}

// The same, or 16 zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same for n in 0..3 known only at run time.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Two floats as one register of two bf16 (round to nearest even).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace mma
}  // namespace spe
