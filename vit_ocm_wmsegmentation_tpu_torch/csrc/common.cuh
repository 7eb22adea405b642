// Shared helpers of the port's Hopper kernels: the bf16 rounding step, warp
// reductions, cp.async copies and named barriers. The bf16 kernels store in
// __nv_bfloat16 and compute in float; round_bf16 is the "cast to the storage
// type" step the JAX kernels take at fixed points (P before P.V).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace vitocm {

// the value v takes once stored in bf16, back in float
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the two bf16 at p, in float
__device__ __forceinline__ float2 bf16x2_at(const void* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// v summed over the 8 lanes of a warp that share lane % 4 (the rows g of
// an accumulator's quad layout, one column), in a fixed order
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// v summed over the 4 lanes of a quad (one row's columns), in a fixed order
__device__ __forceinline__ float sum_over_quad(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exact-erf GELU and its derivative, sharing the Phi term:
// g = h Phi(h), gp = Phi(h) + h phi(h)
__device__ __forceinline__ void gelu_pieces(float h, float& g, float& gp) {
  const float phi = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  g = h * phi;
  gp = phi + h * (expf(-0.5f * h * h) * 0.39894228040143268f);
}

// the same for the bf16 training kernels, which round g and gp (or dg * gp)
// to bf16: Phi by Abramowitz and Stegun 7.1.26 (|error| < 1.5e-7 on erf),
// whose exponential is phi's, 1 - erf(|h| / sqrt 2) = q(t) exp(-h^2 / 2),
// and exp by ex2.approx: one exponential and one reciprocal where erff and
// expf take some forty instructions
__device__ __forceinline__ void gelu_pieces_bf16(float h, float& g, float& gp) {
  const float t = __fdividef(1.f, fmaf(0.3275911f * 0.70710678118654752f, fabsf(h), 1.f));
  const float e = __expf(-0.5f * h * h);
  const float q =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                                                    t * (-1.453152027f + t * 1.061405429f)))) * e;
  const float phi = h >= 0.f ? 1.f - 0.5f * q : 0.5f * q;
  g = h * phi;
  gp = phi + h * (e * 0.39894228040143268f);
}

// LayerNorm of one row held as v[c] = row[lane + 32*c] across a warp
template <int D>
__device__ __forceinline__ void warp_ln_stats(const float (&v)[D / 32], float eps, float& mu,
                                              float& rstd) {
  constexpr int CPT = D / 32;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) s += v[c];
  mu = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const float t = v[c] - mu;
    q += t * t;
  }
  rstd = 1.f / sqrtf(warp_sum(q) / D + eps);
}

// 16 bytes (16-byte aligned at both ends) global -> shared, asynchronously;
// src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// barrier `id` (1..15) over `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// dtype codes of the C interface
enum DType { kF32 = 0, kBF16 = 1 };

// *sms = the current device's SM count, with kernel K's dynamic
// shared-memory limit raised to smem there: asked of the runtime once a
// device and a kernel, since both calls cost host time on every launch.
// Returns 0, or the CUDA error.
template <auto K>
inline int device_sms_for(size_t smem, int* sms) {
  static int cached[64] = {};  // by device, 0 until asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cached[dev] = n > 0 ? n : 1;
  }
  *sms = cached[dev];
  return 0;
}

// the attention backward's row statistics (attention_bwd.cu): for every
// (batch*head, row) of the folded (BH, N, d) dout and o, stats (BH, 2,
// pitch) = [row, non-finite values as 0 | rowsum(dout * o) in f32], each N
// of a pitch (>= N) floats; row is the logsumexp on the lse route and
// 1/denominator on the saved-P route
int attn_row_stats(int dtype, int d, const float* row, const void* dout, const void* o,
                   float* stats, int BH, int N, int pitch, cudaStream_t s);

// the split count for a grid of `tiles` x splits CTAs over `slots` resident
// CTAs (SMs x CTAs an SM): the one of 1 .. max_splits whose last wave is
// fullest (the larger on a tie); the weight-gradient kernels' choice
static inline int weight_splits(int tiles, int max_splits, int slots) {
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= max_splits; ++s) {
    const int ctas = tiles * s, waves = (ctas + slots - 1) / slots;
    const double fill = (double)ctas / ((double)waves * slots);
    if (fill >= best_fill) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

// out[i] = sum over s < S of part[s * W + i], in order of s: the fixed-order
// reduction of the weight-gradient partials (fused_mlp_bwd.cu)
int reduce_splits(const float* part, float* out, int S, long long W, cudaStream_t stream);

// the same sums for a tall part (S >> W), in another fixed order: each of 8
// warps a block sums a range of rows, then the 8 sums in order
// (fused_mlp_bwd.cu)
int reduce_rows(const float* part, float* out, int S, int W, cudaStream_t stream);

}  // namespace vitocm
