// Row-wise int8 quantization of the int8 serving route's activations, one
// kernel: for each row of x (M, K), f32 or bf16,
//   s = max|x| / 127 (1 for an all-zero row),  q = clamp(rint(x / s), -127, 127)
// into xq (M, K) int8 and sx (M,) f32. Replaces the row quantization
// (`_rowwise_int8`) that vit_ocm_wmsegmentation_tpu/ops/quant.py::int8_dot
// runs through XLA before its int8 product, and in the port the ~7 torch
// passes of ops/quant.py::rowwise_int8 that int8_dot ran on the card.
//
// Arithmetic, bit for bit that of rowwise_int8 and of the JAX package's
// _rowwise_int8: the max is exact in any order, s = max|x| / 127 and
// q = x / s are true divisions (__fdiv_rn), and q rounds half to even
// (rintf), as torch.round and jnp.round do.
//
// What bounds it: one read of x and one write of xq (130 MB at 112945 x 384
// in bf16, 0.039 ms at 3.35 TB/s). One warp a row holds the row in
// registers as loaded (8 values a lane a chunk, 16-byte loads, chunks 32
// apart so that the warp reads 512 contiguous bytes a step; as many chunks a
// lane as the row needs, so that bf16 rows of 1536 keep occupancy up),
// reduces the max with shuffles and writes 8 int8 values a lane a chunk.

#include <stdint.h>

#include "common.cuh"

namespace vitocm {

constexpr int kQThreads = 256;  // 8 rows a block

// 8 consecutive values as loaded, 16 bytes of bf16 or 32 of f32; v(e) is
// value e as a float
__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}
template <typename T>
struct Chunk8 {
  uint4 w[sizeof(T) / 2];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < (int)sizeof(T) / 2; ++i) w[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ float v(int e) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(word(w[e >> 2], e & 3));
    const uint32_t u = word(w[0], e >> 1);
    return __uint_as_float(e & 1 ? u & 0xFFFF0000u : u << 16);
  }
};

// CPL: chunks of 8 values a lane, at least K / 256; the row stays in
// registers as loaded between the max and the quantization
template <typename T, int CPL>
__global__ void __launch_bounds__(kQThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                     int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kQThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const int chunks = K / 8;
  const T* xr = x + (long long)row * K;
  Chunk8<T> v[CPL];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (lane + 32 * c < chunks) v[c].load(xr + 8 * (lane + 32 * c));
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (lane + 32 * c < chunks)
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[c].v(e)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  float s = __fdiv_rn(amax, 127.f);
  if (!(s > 0.f)) s = 1.f;
  if (lane == 0) sx[row] = s;
  int8_t* qr = xq + (long long)row * K;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int ch = lane + 32 * c;
    if (ch < chunks) {
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = __fdiv_rn(v[c].v(e), s);
        const float q = fminf(fmaxf(rintf(y), -127.f), 127.f);
        w[e >> 2] |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu) << (8 * (e & 3));
      }
      *reinterpret_cast<uint2*>(qr + 8 * ch) = make_uint2(w[0], w[1]);
    }
  }
}

template <typename T, int CPL>
static void launch_cpl(const void* x, void* xq, float* sx, int M, int K, cudaStream_t s) {
  const dim3 grid((M + kQThreads / 32 - 1) / (kQThreads / 32));
  quantize_rows_kernel<T, CPL><<<grid, kQThreads, 0, s>>>(static_cast<const T*>(x),
                                                          static_cast<int8_t*>(xq), sx, M, K);
}

template <typename T>
static int launch_quantize(const void* x, void* xq, float* sx, int M, int K, cudaStream_t s) {
  const int need = (K / 8 + 31) / 32;  // chunks a lane
  if (need <= 1) launch_cpl<T, 1>(x, xq, sx, M, K, s);
  else if (need <= 2) launch_cpl<T, 2>(x, xq, sx, M, K, s);
  else if (need <= 3) launch_cpl<T, 3>(x, xq, sx, M, K, s);
  else if (need <= 4) launch_cpl<T, 4>(x, xq, sx, M, K, s);
  else if (need <= 6) launch_cpl<T, 6>(x, xq, sx, M, K, s);
  else if (need <= 8) launch_cpl<T, 8>(x, xq, sx, M, K, s);
  else if (need <= 12) launch_cpl<T, 12>(x, xq, sx, M, K, s);
  else launch_cpl<T, 16>(x, xq, sx, M, K, s);
  return (int)cudaGetLastError();
}

}  // namespace vitocm

// x (M, K) f32 (dtype 0) or bf16 (1), 16-byte aligned; xq (M, K) int8 and
// sx (M,) f32 out. K a multiple of 16 and at most 4096. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int vitocm_quantize_rows(int dtype, const void* x, void* xq, void* sx, int M, int K,
                                    void* stream) {
  using namespace vitocm;
  if (M < 1 || K < 16 || K % 16 != 0 || K > 4096) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(sx);
  if (dtype == kF32) return launch_quantize<float>(x, xq, f, M, K, s);
  if (dtype == kBF16) return launch_quantize<__nv_bfloat16>(x, xq, f, M, K, s);
  return (int)cudaErrorInvalidValue;
}
