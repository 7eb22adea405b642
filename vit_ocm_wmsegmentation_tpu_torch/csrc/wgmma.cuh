// Hopper building blocks of the wgmma kernels (attention_qkv_wgmma.cu,
// attention_bwd_wgmma.cu, attention_savep_wgmma.cu,
// attention_savep_bwd_wgmma.cu, fused_mlp_wgmma.cu, fused_mlp_bwd_wgmma.cu,
// ln_linear_bwd_wgmma.cu, probe_attention_wgmma.cu):
// warpgroup matrix products (wgmma), tensor-memory copies (TMA) completing on
// shared-memory barriers (mbarrier) and TMA stores, and the shared-memory
// descriptors that tie them together.
// sm_90a only.
//
// Operand tiles live in shared memory as TMA writes them with the 128-byte
// (or 64-byte) swizzle: rows of 128 (64) bytes, the 16-byte chunks of each
// row permuted by XOR with the row index within its 1024-byte (512-byte)
// atom of 8 rows. Every tile starts on a 1024-byte boundary, so a
// descriptor's base offset is 0. A K-major operand (K contiguous in a row)
// takes SBO = one atom (8 rows) and steps 16 elements of K by adding 32
// bytes to the start address; an MN-major operand (N contiguous, rows along
// K) takes SBO = one atom (8 K rows) and LBO = the distance between blocks
// of 64 N values, and steps 16 of K by 16 rows.
//
// Accumulators (m64nN, f32): warp w of the warpgroup, lane = 4g + t, holds
// d[4i + e] = D[16w + g + 8 (e >> 1)][8i + 2t + (e & 1)], i < N / 8 -- per
// 8 columns the layout of mma.sync's C fragment. A register A operand
// (m64k16, bf16 pairs) is that of mma.sync's A fragment, so the accumulators
// of columns 16k..16k+15, rounded and packed in pairs, are the A operand of
// k-step k (FlashAttention-3's register reuse).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace vitocm {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (dynamic shared memory is only
// 16-byte aligned; kernels allocate 1 KB more)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// --- descriptors -----------------------------------------------------------
// layout: 1 = 128-byte swizzle, 2 = 64-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (layout << 62);
}
// K-major, 128-byte rows: 8-row atoms of 1024 bytes
__device__ __forceinline__ uint64_t desc_k128(const void* p) { return smem_desc(p, 16, 1024, 1); }
// K-major, 64-byte rows: 8-row atoms of 512 bytes
__device__ __forceinline__ uint64_t desc_k64(const void* p) { return smem_desc(p, 16, 512, 2); }
// MN-major, 128-byte rows along K; blocks of 64 N values lbo bytes apart
__device__ __forceinline__ uint64_t desc_mn128(const void* p, uint32_t lbo) {
  return smem_desc(p, lbo, 1024, 1);
}
// MN-major, 64-byte rows along K (32 N values, one block: no LBO)
__device__ __forceinline__ uint64_t desc_mn64(const void* p) { return smem_desc(p, 0, 512, 2); }

// byte offset of (r, col) in a tile of 64-byte rows (32 bf16 columns) as
// TMA's 64-byte swizzle lays it out from a 512-byte boundary: the 16-byte
// chunk col / 8 XOR (r / 2) % 4. A warp's accumulator-layout pairs (rows g,
// g + 8 of 16, columns 8i + 2t .. ) land in 32 distinct banks.
__device__ __forceinline__ int sw64_offset(int r, int col) {
  return r * 64 + ((((col >> 3) ^ (r >> 1)) & 3) << 4) + (col & 7) * 2;
}

// byte offset of (r, col) in a (128 x N) bf16 tile as TMA's 128-byte
// swizzle writes it in 64-column chunks of 128 rows: chunk col / 64 at
// (col / 64) * 128 * 128, 128-byte rows, 16-byte groups XOR r % 8
__device__ __forceinline__ int sw128_offset(int r, int col) {
  return (col >> 6) * 128 * 128 + r * 128 + ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// A warp's 16 x 32 bf16 tile, held at sw64_offset(r, col) of `tile`, out to
// rows row0 .. row0 + 15 (those below R) of a row-major array with `ld`
// columns, at column col0: 16 bytes a lane and store
__device__ __forceinline__ void warp_tile_store(const unsigned char* tile, __nv_bfloat16* dst,
                                                long long row0, long long R, int ld, int col0,
                                                int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = (lane >> 2) + 8 * k, q = lane & 3;
    if (row0 + r < R)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * ld + col0 + 8 * q) =
          *reinterpret_cast<const uint4*>(tile + r * 64 + ((q ^ ((r >> 1) & 3)) << 4));
  }
}

// --- wgmma synchronization -------------------------------------------------
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
// pins registers that an asynchronous wgmma writes to this point of the
// program, so that the compiler moves no read of them above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// --- mbarrier ----------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive and expect `bytes` of TMA transfers before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA -----------------------------------------------------------------
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared -> device memory through a tiled map, into this thread's bulk
// group; the box's rows and columns past the map's dims are not written.
// The tile's shared-memory writes need fence_proxy_async first.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups are still reading their
// shared-memory sources
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// generic-proxy stores to shared memory made visible to wgmma's reads
// (and to TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// --- host: tensor maps ------------------------------------------------------
// A tiled map over a row-major array of `rank` dims (dims innermost first,
// strides in bytes of dims 1..rank-1, multiples of 16); rows past a dim
// read as 0.
inline bool make_tmap(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                      const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  const uint32_t ones[5] = {1, 1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, type, rank, const_cast<void*>(base), dims, strides, box,
                                ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
inline bool make_tmap_bf16(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                           const uint64_t* strides, const uint32_t* box,
                           CUtensorMapSwizzle swizzle) {
  return make_tmap(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, strides, box,
                   swizzle);
}

// --- register operands --------------------------------------------------------
// two floats rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ldmatrix.x4.trans: four 8x8 bf16 tiles from shared memory, lane i giving
// the address of row i % 8 of tile i / 8 (16-byte aligned rows); register j
// of a lane holds tile j's (rows 2t..2t+1, col g), g = lane / 4, t = lane % 4
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// --- products (register lists spelled out) ------------------------------------
// D (64 x 64, f32, registers) += A (64 x 16) . B (16 x 64), both from shared
// memory through descriptors, A K-major; TRANS_B = 1 reads B MN-major (N
// contiguous), 0 K-major; scale_d = 0 ignores D's old values (D = A . B)
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

#define VITOCM_S32_ACC32                                                                   \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),       \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), \
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),           \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),           \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])

// D (64 x 64, s32, registers) += A (64 x 32) . B (32 x 64), s8, both from
// shared memory, both K-major (8-bit wgmma has no transpose); scale_d = 0
// ignores D's old values
__device__ __forceinline__ void wgmma_ss_m64n64k32_s8(int (&d)[32], uint64_t da, uint64_t db,
                                                      int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : VITOCM_S32_ACC32
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, s32) += A (64 x 32, s8 in registers) . B (32 x 64, s8, shared
// memory, K-major). A register of the A operand holds four int8 values of one
// row in k order, as mma.sync.m16n8k32's A fragment: a[0] = A[g][4t..4t+3],
// a[1] = A[g+8][4t..], a[2] = A[g][16+4t..], a[3] = A[g+8][16+4t..] for warp
// w's rows 16w..16w+15
__device__ __forceinline__ void wgmma_rs_m64n64k32_s8(int (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : VITOCM_S32_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef VITOCM_S32_ACC32

// D (64 x 32, f32, registers) += A (64 x 16) . B (16 x 32), both from shared
// memory through descriptors, A K-major; TRANS_B = 1 reads B MN-major, 0 K-major
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// D (64 x 8, f32, registers) += A (64 x 16) . B (16 x 8), both from shared
// memory; TRANS_A / TRANS_B = 1 read A / B MN-major, 0 K-major
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_m64n8k16(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
      "%7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, shared
// memory); TRANS_B = 1 reads B MN-major (N contiguous), 0 K-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
}

// D (64 x 8, f32) += A (64 x 16, bf16 in registers) . B (16 x 8, shared
// memory, K-major)
__device__ __forceinline__ void wgmma_rs_m64n8k16(float (&d)[4], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 192, f32) += A (64 x 16, bf16 in registers) . B (16 x 192, shared
// memory); TRANS_B = 1 reads B MN-major (N contiguous), 0 K-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n192k16(float (&d)[96], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
}

// D (64 x 192, f32) += A (64 x 16) . B (16 x 192), both from shared memory;
// TRANS_A / TRANS_B = 1 read A / B MN-major, 0 K-major
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_m64n192k16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// --- the attention backwards' two product shapes ----------------------------
// acc (64 x 64) += A . B^T over D, issued (not committed): A's 64 rows at a
// and B's 64 rows at b, both K-major, 64-column chunks a_chunk / b_chunk
// bytes apart
template <int D>
__device__ __forceinline__ void issue_abt(float (&acc)[32], const unsigned char* a, int a_chunk,
                                          const unsigned char* b, int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk >> 2, off = (kk & 3) * 32;
    wgmma_ss_m64n64k16(acc, desc_k128(a + c * a_chunk + off), desc_k128(b + c * b_chunk + off));
  }
}

// acc (64 x D) += A (64 x 64) . B (64 x D), issued (not committed): A in
// registers, k-step kk (rows 16 kk .. 16 kk + 15 of B) in a[4 kk .. 4 kk + 3];
// B MN-major at b, 64-column chunks b_chunk bytes apart
template <int D>
__device__ __forceinline__ void issue_ab(float (&acc)[D / 64][32], const uint32_t (&a)[16],
                                         const unsigned char* b, int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      wgmma_rs_m64n64k16<1>(acc[c], ak, desc_mn128(b + c * b_chunk + kk * 16 * 128, b_chunk));
  }
}

}  // namespace vitocm
