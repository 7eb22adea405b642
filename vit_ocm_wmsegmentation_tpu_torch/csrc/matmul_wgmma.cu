// Tiled matrix product C = A B^T on Hopper's warpgroup tensor cores, bf16
// (wgmma m64n128k16, f32 accumulation) or int8 (wgmma m64n128k32, s8 x s8
// -> s32), fed by TMA through an mbarrier ring. Replaces the TPU probe
// kernel tools/probe_dot.py::matmul (`kern`, pallas_call at :45) and carries
// the int8 serving route's projections (ops/quant.py::int8_dot of the JAX
// package), after quantize_rows.cu has quantized the activations.
//
// Layouts: A (M, K) and B (N, K), both row-major, so both operands are
// K-major, as 8-bit wgmma requires: the route's weights already are
// (nn.Linear's (out, in)); the probe's (K, N) B is transposed once by its
// caller, outside the timed region. K * sizeof(T) must be a multiple of 16
// bytes (a TMA row stride); M, N and K are otherwise free: TMA zero-fills
// the rows and the k bytes past the edges (int8 K = 16 runs one k32 step
// half of zeros) and the stores are masked.
//
// Epilogues (template EPI), in the TPU code's order of operations:
//   kStore:     the probe's `.astype(o_ref.dtype)`: f32 -> bf16 rounded to
//               nearest even, or int32 -> int8 wrapped modulo 256 as XLA's
//               convert does;
//   kDequant*:  the route's (float(acc) * sx[row]) * sw[col] (+ bias[col]),
//               each operation rounded on its own (no FMA contraction), then
//               one cast to f32 or bf16: ops/quant.py's int8_dot_plain plus
//               the bias add of flash_attention.py:715-721 / vit.py:441-445,
//               fused. float(acc) rounds to nearest even: the accumulators
//               pass 2^24. int32 sums are exact (|acc| <= 127^2 K), so the
//               int8 outputs are bit-equal to the plain twin's.
//
// What bounds it on the H100: at the route's shapes (112945 rows, K = 384 or
// 1536, N = 384 to 1536) only 3 to 12 k-steps of 128 bytes run per tile, and
// the bf16 or f32 output write is the largest stream (260 MB for qkv, 0.078
// ms of HBM time against 0.05 ms of int8 tensor-core time); at the probe's
// 2048^3 the tensor cores. So the epilogue has to overlap the products, and
// the loads need many bytes in flight. The design: a persistent CTA an SM
// walks 128 x 128 tiles of C (N fastest, so that the CTAs sharing an A tile
// run together and read it from L2); one lane of a producer warpgroup
// keeps 128-byte k-slices of A's and B's 128 rows in flight with TMA
// (128-byte swizzle, 16 KB each), across tile boundaries, through a ring of
// 5 stages (f32 out) or 6 guarded by "full" mbarriers (the bytes arrived)
// and "empty" ones (the 4 warps of the consuming warpgroup are done with
// the slice); on an H100 the 2048^3 bf16 product ran clearly faster with 6
// stages than with 4. Two consumer warpgroups take the CTA's tiles in
// turn (ping-pong), each a whole 128 x 128 tile as two m64n128 products a
// k-step, one stage's group in flight while the next is queued, their main
// loops in tile order (a "turn" mbarrier each), so that one warpgroup's
// epilogue runs beside the other's products. The consumers hold 128
// accumulators and rise to 240 registers with setmaxnreg, the producer
// drops to 24 (a CTA's warps trade only the registers the CTA was launched
// with, so the producer is a whole warpgroup; two CTAs an SM would launch
// with 80 registers, and ptxas refuses a 64-accumulator wgmma there). In
// the epilogue each warp converts its accumulators in registers (the
// tile's column scales and biases read once into shared memory), stages
// the outputs, 8 rows at a time, in at most 4.3 KB of its own shared
// memory, and writes them in 16-byte chunks contiguous across the warp (a
// row of f32, two of bf16 or four of int8 a step).

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kGM = 128, kGN = 128;  // C tile
constexpr int kGK = 128;             // bytes of k a stage: 64 bf16 or 128 int8 values
constexpr int kGThreads = 384;       // two consumer warpgroups + the producer warpgroup
constexpr int kGTile = kGM * kGK;    // one operand's slice a stage (16 KB)
constexpr int kGStageBytes = 2 * kGTile;

enum MatmulEpi { kStore = 0, kDequantF32 = 1, kDequantBF16 = 2 };

#define VITOCM_ACC8(c, b)                                                                   \
  c(d[b]), c(d[b + 1]), c(d[b + 2]), c(d[b + 3]), c(d[b + 4]), c(d[b + 5]), c(d[b + 6]), \
      c(d[b + 7])
#define VITOCM_ACC64(c)                                                                  \
  VITOCM_ACC8(c, 0), VITOCM_ACC8(c, 8), VITOCM_ACC8(c, 16), VITOCM_ACC8(c, 24),          \
      VITOCM_ACC8(c, 32), VITOCM_ACC8(c, 40), VITOCM_ACC8(c, 48), VITOCM_ACC8(c, 56)
#define VITOCM_D64                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

template <typename T>
struct GemmOf;

template <>
struct GemmOf<__nv_bfloat16> {
  using Acc = float;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // D (64 x 128, f32) += A (64 x 16) . B (128 x 16)^T, both K-major in shared memory
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VITOCM_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : VITOCM_ACC64("+f")
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct GemmOf<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  // D (64 x 128, s32) += A (64 x 32) . B (128 x 32)^T, s8, both K-major
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " VITOCM_D64 ", %64, %65, p;\n}\n"
        : VITOCM_ACC64("+r")
        : "l"(da), "l"(db), "r"(1));
  }
};

// pins accumulators that asynchronous wgmma writes to this point
__device__ __forceinline__ void fence_acc(float (&d)[64]) { fence_regs(d); }
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the output of an instance: its bytes a value; the staging of a warp's 8
// rows, (8, PITCH) bytes, PITCH chosen so that the accumulator-layout stores
// of a warp (or half-warp, 8-byte ones) hit 32 distinct banks; the ring's
// stages, as many as the shared memory left holds (5 for f32, 6 else)
template <typename T, int EPI>
struct GemmOut {
  static constexpr int OSZ = EPI == kDequantF32 ? 4 : (EPI == kStore && sizeof(T) == 1 ? 1 : 2);
  static constexpr int PITCH = OSZ == 4 ? 544 : OSZ == 2 ? 272 : 144;
  static constexpr int STAGES = OSZ == 4 ? 5 : 6;
  static constexpr size_t SMEM = 1024 + STAGES * kGStageBytes + 8 * 8 * PITCH + 8 * kGN * 4 +
                                 (2 * STAGES + 2) * 8;
  using Type = std::conditional_t<OSZ == 4, float,
                                  std::conditional_t<OSZ == 2, __nv_bfloat16, int8_t>>;
};

// columns c, c + 1 of staged row r: a pair of accumulators as the output
// type, dequantized first by the row's scale sxr, the columns' scales sw2
// and biases b2 (kDequant*); int32 -> int8 wraps
template <typename T, int EPI>
__device__ __forceinline__ void stage_pair(unsigned char* stage, int r, int c,
                                           typename GemmOf<T>::Acc a0,
                                           typename GemmOf<T>::Acc a1, float sxr,
                                           const float* sw2, const float* b2, bool has_bias) {
  using O = GemmOut<T, EPI>;
  unsigned char* p = stage + r * O::PITCH + c * O::OSZ;
  if constexpr (O::OSZ == 1) {
    *reinterpret_cast<uint16_t*>(p) =
        static_cast<uint16_t>((static_cast<uint32_t>(a0) & 0xFFu) |
                              (static_cast<uint32_t>(a1) & 0xFFu) << 8);
  } else {
    float v0, v1;
    if constexpr (EPI == kStore) {
      v0 = a0;
      v1 = a1;
    } else {  // (float(acc) * sx) * sw (+ bias), each step rounded on its own
      v0 = __fmul_rn(__fmul_rn(__int2float_rn(a0), sxr), sw2[0]);
      v1 = __fmul_rn(__fmul_rn(__int2float_rn(a1), sxr), sw2[1]);
      if (has_bias) {
        v0 = __fadd_rn(v0, b2[0]);
        v1 = __fadd_rn(v1, b2[1]);
      }
    }
    if constexpr (O::OSZ == 4)
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    else
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
  }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(kGThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map, void* __restrict__ C,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    const float* __restrict__ bias, int M, int N, int K) {
  using G = GemmOf<T>;
  using O = GemmOut<T, EPI>;
  constexpr int kGStages = O::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* stg = ring + kGStages * kGStageBytes;
  float* colv = reinterpret_cast<float*>(stg + 8 * 8 * O::PITCH);  // column scales, biases
  uint64_t* full = reinterpret_cast<uint64_t*>(colv + 8 * kGN);
  uint64_t* empty = full + kGStages;
  uint64_t* turn = empty + kGStages;  // turn[w]: the other warpgroup's products are queued

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tn = (N + kGN - 1) / kGN, tiles = tn * ((M + kGM - 1) / kGM);
  const int ksteps = (K * (int)sizeof(T) + kGK - 1) / kGK;
  if (tid == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the warps of the consuming warpgroup
    }
    mbar_init(&turn[0], 4);
    mbar_init(&turn[1], 4);
    mbar_fence_init();
  }
  __syncthreads();

  // the CTA's tiles: blockIdx.x + lt * gridDim.x for lt = 0, 1, ...; ring
  // use it = lt * ksteps + kk takes stage it % kGStages
  if (warp >= 8) {  // producer warpgroup: one lane starts every copy
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      for (int lt = 0, j = blockIdx.x; j < tiles; ++lt, j += gridDim.x) {
        const int m0 = (j / tn) * kGM, n0 = (j % tn) * kGN;
        for (int kk = 0; kk < ksteps; ++kk) {
          const int it = lt * ksteps + kk, s = it % kGStages;
          unsigned char* st = ring + s * kGStageBytes;
          const int kc = kk * (kGK / (int)sizeof(T));  // the slice's first k, in elements
          mbar_wait(&empty[s], ((it / kGStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kGStageBytes);  // the whole boxes, zero fill included
          tma_load_2d(st, &a_map, &full[s], kc, m0);
          tma_load_2d(st + kGTile, &b_map, &full[s], kc, n0);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();
  // consumer warpgroup wg takes the CTA's tiles lt = wg, wg + 2, ...; warp
  // wl of it holds acc[h][4i + e] = C[64 h + 16 wl + g + 8 (e >> 1)][8i + 2 t4 + (e & 1)]
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  constexpr int E = 16 / O::OSZ, CPR = kGN / E;  // values a 16-byte chunk, chunks a row
  unsigned char* ws = stg + warp * 8 * O::PITCH;
  const bool vec = (N * O::OSZ) % 16 == 0, has_bias = bias != nullptr;
  typename G::Acc acc[2][64];
  for (int n = 0, lt = wg, j = blockIdx.x + wg * gridDim.x; j < tiles;
       ++n, lt += 2, j += 2 * gridDim.x) {
    const int m0 = (j / tn) * kGM, n0 = (j % tn) * kGN;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0;
    // the warpgroups' products run in the order of the tiles: every earlier
    // use of a stage has landed before this one waits for its own (a
    // parity wait cannot tell a use from the one before the last)
    if (n > 0 || wg == 1) mbar_wait(&turn[wg], (n - (wg == 0)) & 1);
    for (int kk = 0; kk < ksteps; ++kk) {
      const int it = lt * ksteps + kk, s = it % kGStages;
      const unsigned char* st = ring + s * kGStageBytes;
      const uint64_t da = desc_k128(st), db = desc_k128(st + kGTile);
      mbar_wait(&full[s], (it / kGStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < kGK / 32; ++q)  // 32 bytes of k a product: descriptor + 2
#pragma unroll
        for (int h = 0; h < 2; ++h)  // rows 64 h ..: 8 KB further into A's slice
          G::mma(acc[h], da + ((h * 64 * kGK) >> 4) + 2 * q, db + 2 * q);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are complete
      if (kk > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kGStages]);
    }
    if (lane == 0) mbar_arrive(&turn[wg ^ 1]);
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (lane == 0) mbar_arrive(&empty[(lt * ksteps + ksteps - 1) % kGStages]);

    // the tile's column scales, then its biases, once, in
    // one of two buffers a warpgroup (a warp that writes tile n + 2's has
    // passed tile n + 1's barrier, which the others reach after tile n)
    float* sw_s = colv + (2 * wg + (n & 1)) * 2 * kGN;
    if (EPI != kStore) {
      const int c = 32 * wl + lane;
      sw_s[c] = n0 + c < N ? sw[n0 + c] : 1.f;
      sw_s[kGN + c] = has_bias && n0 + c < N ? bias[n0 + c] : 0.f;
      named_barrier(1 + wg, 128);
    }
    // 8 rows at a time (rows g, then g + 8, of each half): the outputs,
    // converted in registers, into the warp's staging as pairs; then out in
    // 16-byte chunks, contiguous across the warp (a row of f32, two of bf16,
    // four of int8 a step)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row0 = m0 + 64 * h + 16 * wl + 8 * e;
        const float sxr = EPI != kStore && row0 + g < M ? sx[row0 + g] : 1.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int c = 8 * i + 2 * t4;
          stage_pair<T, EPI>(ws, g, c, acc[h][4 * i + 2 * e], acc[h][4 * i + 2 * e + 1], sxr,
                             sw_s + c, sw_s + kGN + c, has_bias);
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 8 * CPR / 32; ++q) {
          const int r = q * (32 / CPR) + lane / CPR, c = (lane % CPR) * E;
          const int row = row0 + r, col = n0 + c;
          if (row < M && col < N) {
            const unsigned char* src = ws + r * O::PITCH + c * O::OSZ;
            typename O::Type* dst = static_cast<typename O::Type*>(C) + (long long)row * N + col;
            if (vec && col + E <= N) {
              *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
              for (int x = 0; x < E && col + x < N; ++x)
                dst[x] = reinterpret_cast<const typename O::Type*>(src)[x];
            }
          }
        }
        __syncwarp();
      }
    }
  }
}

template <typename T, int EPI>
static int launch_matmul_wgmma(const void* A, const void* B, void* C, const float* sx,
                               const float* sw, const float* bias, int M, int N, int K,
                               cudaStream_t stream) {
  CUtensorMap am, bm;
  const uint64_t da[2] = {(uint64_t)K, (uint64_t)M}, db[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t stride[1] = {(uint64_t)K * sizeof(T)};
  const uint32_t box[2] = {(uint32_t)(kGK / sizeof(T)), (uint32_t)kGM};
  if (!make_tmap(&am, GemmOf<T>::kMapType, A, 2, da, stride, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap(&bm, GemmOf<T>::kMapType, B, 2, db, stride, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  auto kern = matmul_wgmma_kernel<T, EPI>;
  constexpr size_t smem = GemmOut<T, EPI>::SMEM;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long long tiles = (long long)((N + kGN - 1) / kGN) * ((M + kGM - 1) / kGM);
  kern<<<(int)(tiles < sms ? tiles : sms), kGThreads, smem, stream>>>(am, bm, C, sx, sw, bias, M,
                                                                       N, K);
  return (int)cudaGetLastError();
}

}  // namespace vitocm

// C (M, N) = A (M, K) B (N, K)^T. dtype: 1 bf16 operands (epi 0 only: C
// bf16), 2 int8 operands (epi 0: C int8 wrapped; 1: C f32 dequantized with
// sx (M,), sw (N,) and bias (N,) or null; 2: the same rounded to bf16). A
// and B 16-byte aligned, K * itemsize a multiple of 16. Returns
// cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue) for a
// combination that has no instantiation or for operands TMA cannot map.
extern "C" int vitocm_matmul(int dtype, int epi, const void* A, const void* B, void* C,
                             const void* sx, const void* sw, const void* bias, int M, int N, int K,
                             void* stream) {
  using namespace vitocm;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16 && epi == kStore)
    return launch_matmul_wgmma<__nv_bfloat16, kStore>(A, B, C, nullptr, nullptr, nullptr, M, N, K,
                                                      s);
  if (dtype == 2 && epi == kStore)
    return launch_matmul_wgmma<int8_t, kStore>(A, B, C, nullptr, nullptr, nullptr, M, N, K, s);
  if (dtype == 2 && epi == kDequantF32)
    return launch_matmul_wgmma<int8_t, kDequantF32>(A, B, C, f(sx), f(sw), f(bias), M, N, K, s);
  if (dtype == 2 && epi == kDequantBF16)
    return launch_matmul_wgmma<int8_t, kDequantBF16>(A, B, C, f(sx), f(sw), f(bias), M, N, K, s);
  return (int)cudaErrorInvalidValue;
}
