// Tiled matrix product C = A B^T on the tensor cores, bf16 (mma.sync
// m16n8k16, f32 accumulation) or int8 (mma.sync m16n8k32, int32
// accumulation). Replaces the TPU probe kernel tools/probe_dot.py::matmul
// (`kern`, pallas_call at :45) and carries the int8 serving route's
// projections (ops/quant.py::int8_dot of the JAX package).
//
// Layouts: A (M, K) and B (N, K), both row-major, so that every row of both
// operands is contiguous along k (the "col" operand of mma.sync). ldmatrix
// transposes only 16-bit elements, so an int8 B must arrive k-contiguous: the
// route's weights already are (nn.Linear's (out, in)); the probe's (K, N) B
// is transposed once by its caller, outside the timed region. K * sizeof(T)
// must be a multiple of 16 bytes; M and N are free (the edge tiles are
// zero-filled and their stores masked).
//
// Epilogues (template EPI), in the TPU code's order of operations:
//   kStore:     the probe's `.astype(o_ref.dtype)`: f32 -> bf16 rounded to
//               nearest even, or int32 -> int8 wrapped modulo 256 as XLA's
//               convert does;
//   kDequant*:  the route's (float(acc) * sx[row]) * sw[col] (+ bias[col]),
//               each operation rounded on its own (no FMA contraction), then
//               one cast to f32 or bf16: ops/quant.py:84-87 plus the bias add
//               of flash_attention.py:715-721 / vit.py:441-445, fused.
//               float(acc) rounds to nearest even: the accumulators pass 2^24.
//
// A CTA owns a 128 x 128 tile of C, eight warps of 64 x 32; k advances 64
// bytes a stage (32 bf16 or 64 int8 values) through a three-stage cp.async
// ring in shared memory (rows padded to 80 bytes: ldmatrix hits 32 banks).
// Bound on the H100: tensor-core issue at the probe's 2048^3 and at the
// route's shapes (K = 384 or 1536 against 128-wide tiles); no wgmma/TMA yet.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace vitocm {

constexpr int kMM_BM = 128, kMM_BN = 128;  // C tile
constexpr int kMM_BK = 64;                 // bytes of k a stage
constexpr int kMM_PITCH = kMM_BK + 16;     // staged row pitch in bytes
constexpr int kMM_STAGES = 3;
constexpr int kMM_THREADS = 256;
constexpr int kMM_STAGE_BYTES = (kMM_BM + kMM_BN) * kMM_PITCH;

enum MatmulEpi { kStore = 0, kDequantF32 = 1, kDequantBF16 = 2 };

template <typename T>
struct MmaOf;

template <>
struct MmaOf<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    mma_bf16_16816(c, a, b0, b1);
  }
};

template <>
struct MmaOf<int8_t> {
  using Acc = int;
  static __device__ __forceinline__ void run(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    mma_s8_16832(c, a, b0, b1);
  }
};

// (float(acc) * sx) * sw (+ bias[col]), each step rounded on its own
__device__ __forceinline__ float dequant(int acc, float sx, float sw, const float* bias, int col) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  if (bias != nullptr) v = __fadd_rn(v, bias[col]);
  return v;
}

template <typename T, int EPI>
__device__ __forceinline__ void store_one(void* C, long long idx, typename MmaOf<T>::Acc acc,
                                          float sx, float sw, const float* bias, int col) {
  if constexpr (EPI == kStore) {
    if constexpr (sizeof(T) == 1) {
      static_cast<int8_t*>(C)[idx] = static_cast<int8_t>(static_cast<uint8_t>(acc));
    } else {
      static_cast<__nv_bfloat16*>(C)[idx] = __float2bfloat16_rn(acc);
    }
  } else {
    const float v = dequant(acc, sx, sw, bias, col);
    if constexpr (EPI == kDequantF32) {
      static_cast<float*>(C)[idx] = v;
    } else {
      static_cast<__nv_bfloat16*>(C)[idx] = __float2bfloat16_rn(v);
    }
  }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(kMM_THREADS)
matmul_mma_kernel(const T* __restrict__ A, const T* __restrict__ B, void* __restrict__ C,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  const float* __restrict__ bias, int M, int N, int K) {
  using Acc = typename MmaOf<T>::Acc;
  extern __shared__ __align__(16) unsigned char mm_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // this warp's C sub-tile
  const int m0 = blockIdx.y * kMM_BM, n0 = blockIdx.x * kMM_BN;
  const long long kbytes = (long long)K * sizeof(T);
  const unsigned char* Ab = reinterpret_cast<const unsigned char*>(A);
  const unsigned char* Bb = reinterpret_cast<const unsigned char*>(B);
  const int ktiles = (int)((kbytes + kMM_BK - 1) / kMM_BK);

  // rows of A then rows of B, 64 bytes of k each, into stage slot s
  auto stage = [&](int s, int kt) {
    unsigned char* dst0 = mm_smem + s * kMM_STAGE_BYTES;
    const long long kb0 = (long long)kt * kMM_BK;
    for (int i = tid; i < (kMM_BM + kMM_BN) * (kMM_BK / 16); i += kMM_THREADS) {
      const int r = i / (kMM_BK / 16), c = (i % (kMM_BK / 16)) * 16;
      const bool is_a = r < kMM_BM;
      const int grow = is_a ? m0 + r : n0 + r - kMM_BM;
      const bool ok = grow < (is_a ? M : N) && kb0 + c < kbytes;
      const unsigned char* src =
          (is_a ? Ab : Bb) + (ok ? (long long)grow * kbytes + kb0 + c : 0);
      cp_async16(dst0 + r * kMM_PITCH + c, src, ok ? 16 : 0);
    }
  };

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kMM_STAGES - 1; ++s) {
    if (s < ktiles) stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kMM_STAGES - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    const int nk = kt + kMM_STAGES - 1;
    if (nk < ktiles) stage(nk % kMM_STAGES, nk);
    cp_async_commit();

    const unsigned char* As = mm_smem + (kt % kMM_STAGES) * kMM_STAGE_BYTES;
    const unsigned char* Bs = As + kMM_BM * kMM_PITCH;
#pragma unroll
    for (int ks = 0; ks < kMM_BK / 32; ++ks) {  // 32 bytes of k a product
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4_bytes(af[mi], As + (wm + 16 * mi + (lane & 7) + ((lane >> 3) & 1) * 8) * kMM_PITCH +
                                  32 * ks + (lane >> 4) * 16);
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t r[4];
        ldsm_x4_bytes(r, Bs + (wn + 8 * nj + (lane & 7) + (lane >> 4) * 8) * kMM_PITCH + 32 * ks +
                             ((lane >> 3) & 1) * 16);
        bfr[nj][0] = r[0];
        bfr[nj][1] = r[1];
        bfr[nj + 1][0] = r[2];
        bfr[nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) MmaOf<T>::run(acc[mi][nj], af[mi], bfr[nj][0], bfr[nj][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + 16 * mi + g + 8 * half;
      if (row >= M) continue;
      const float sxr = EPI == kStore ? 1.f : sx[row];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + 8 * nj + 2 * t + e;
          if (col < N)
            store_one<T, EPI>(C, (long long)row * N + col, acc[mi][nj][2 * half + e], sxr,
                              EPI == kStore ? 1.f : sw[col], bias, col);
        }
    }
}

template <typename T, int EPI>
int launch_matmul(const void* A, const void* B, void* C, const float* sx, const float* sw,
                  const float* bias, int M, int N, int K, cudaStream_t stream) {
  const size_t smem = (size_t)kMM_STAGES * kMM_STAGE_BYTES;
  cudaFuncSetAttribute(matmul_mma_kernel<T, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((N + kMM_BN - 1) / kMM_BN, (M + kMM_BM - 1) / kMM_BM);
  matmul_mma_kernel<T, EPI><<<grid, kMM_THREADS, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), C, sx, sw, bias, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace vitocm

// C (M, N) = A (M, K) B (N, K)^T. dtype: 1 bf16 operands (epi 0 only: C
// bf16), 2 int8 operands (epi 0: C int8 wrapped; 1: C f32 dequantized with
// sx (M,), sw (N,) and bias (N,) or null; 2: the same rounded to bf16).
// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue) for
// a combination that has no instantiation.
extern "C" int vitocm_matmul(int dtype, int epi, const void* A, const void* B, void* C,
                             const void* sx, const void* sw, const void* bias, int M, int N, int K,
                             void* stream) {
  using namespace vitocm;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == kBF16 && epi == kStore)
    return launch_matmul<__nv_bfloat16, kStore>(A, B, C, nullptr, nullptr, nullptr, M, N, K, s);
  if (dtype == 2 && epi == kStore)
    return launch_matmul<int8_t, kStore>(A, B, C, nullptr, nullptr, nullptr, M, N, K, s);
  if (dtype == 2 && epi == kDequantF32)
    return launch_matmul<int8_t, kDequantF32>(A, B, C, f(sx), f(sw), f(bias), M, N, K, s);
  if (dtype == 2 && epi == kDequantBF16)
    return launch_matmul<int8_t, kDequantBF16>(A, B, C, f(sx), f(sw), f(bias), M, N, K, s);
  return (int)cudaErrorInvalidValue;
}
