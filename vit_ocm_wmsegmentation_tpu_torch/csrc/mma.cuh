// Warp-level bf16 tensor-core product, mma.sync.m16n8k16 with f32
// accumulation, and the fragment layouts the kernels rely on.
//
// With g = lane / 4 and t = lane % 4, for one 16x8 output tile:
//   A (16x16, row-major) a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//                        a[2] = A[g][2t+8..2t+9], a[3] = A[g+8][2t+8..2t+9]
//   B (16x8, "col": B[k][n] read at fixed n) b[0] = B[2t..2t+1][g],
//                                            b[1] = B[2t+8..2t+9][g]
//   C (16x8 f32) c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// Each a/b register packs two bf16 values, the lower k in the low half, so a
// 32-bit load of two neighbouring bf16 values in k order gives one register.
// bf16 products are exact in f32; the sums are f32.
//
// ldmatrix.x4 loads four 8x8 bf16 tiles from shared memory, lane i giving
// the address of row i % 8 of tile i / 8 (16-byte aligned rows). Without
// .trans, register j of a lane holds tile j's (row g, cols 2t..2t+1); with
// .trans it holds tile j's (rows 2t..2t+1, col g). The helpers below build
// fragments from tiles stored row-major in either orientation.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vitocm {

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// int8 tensor-core product, mma.sync.m16n8k32 with int32 accumulation. In
// bytes its fragments are the bf16 m16n8k16 ones above: a register holds
// four int8 values of one row (A) or column (B) in k order, a[0] = A[g][4t..
// 4t+3], a[1] = A[g+8][4t..], a[2] = A[g][16+4t..], a[3] = A[g+8][16+4t..],
// b[0] = B[4t..4t+3][g], b[1] = B[16+4t..][g]; C as above, in int32. So both
// operands are read with the same byte offsets, from tiles k-contiguous by row.
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix.x4 without .trans on any element type: four 8-row x 16-byte tiles
__device__ __forceinline__ void ldsm_x4_bytes(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// two bf16 values at p[0], p[1] (4-byte aligned) as one fragment register
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of a 16x16 tile at `base` (row-major, `pitch` elements a row)
__device__ __forceinline__ void ld_a_frag(uint32_t (&a)[4], const __nv_bfloat16* base,
                                          int pitch, int g, int t) {
  a[0] = ld_pair(base + g * pitch + 2 * t);
  a[1] = ld_pair(base + (g + 8) * pitch + 2 * t);
  a[2] = ld_pair(base + g * pitch + 2 * t + 8);
  a[3] = ld_pair(base + (g + 8) * pitch + 2 * t + 8);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment of the 16x16 tile A[m][k] = S[k0 + k][m0 + m] of a matrix
// stored transposed (S row-major, `pitch` elements a row, in shared memory)
__device__ __forceinline__ void ld_a_frag_t(uint32_t (&a)[4], const __nv_bfloat16* s, int pitch,
                                            int k0, int m0, int lane) {
  ldsm_x4_trans(a, s + (k0 + (lane & 7) + (lane >> 4) * 8) * pitch + m0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two neighbouring 16x8 tiles, B[k][n] = T[k0 + k][n0 + n]
// for n < 16, from T row-major in shared memory: b[0..1] for columns
// n0..n0+7, b[2..3] for n0+8..n0+15
__device__ __forceinline__ void ld_b_frag2(uint32_t (&b)[4], const __nv_bfloat16* tm, int pitch,
                                           int k0, int n0, int lane) {
  ldsm_x4_trans(b, tm + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 + (lane >> 4) * 8);
}

}  // namespace vitocm
