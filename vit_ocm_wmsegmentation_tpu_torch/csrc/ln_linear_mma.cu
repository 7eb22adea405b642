// bf16 variant of csrc/ln_linear.cu's forward on the tensor cores (mma.sync
// m16n8k16, f32 accumulation). Same contract and the TPU kernel's rounding
// points (ops/ln_linear.py::_ln_linear_fwd_kernel): xn rounded to bf16
// before the product, y = bf16(xn W^T + b) with the bias added in f32. The
// bf16 backward is ln_linear_bwd_wgmma.cu.
//
// A CTA owns 64 rows, normalizes them once into shared memory and walks the
// K output columns in chunks of 64: per
// chunk it stages 64 rows of W, and warp w computes rows 16 (w % 4).. by
// columns 32 (w / 4).. of the chunk. 100 KB of shared memory at D = 384, two
// CTAs an SM. At the MIM shape (36880, 384) x (1152, 384) it is 32.6 GFLOP
// on 0.17 GB of HBM traffic: tensor-core issue and the per-chunk loads of W
// from L2 (every CTA reads all of W, 0.88 MB) bound it.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace vitocm {

constexpr int kNR = 64;   // rows per CTA
constexpr int kNC = 64;   // columns of K per chunk
constexpr int kNT = 256;  // threads (8 warps)

template <int D>
constexpr size_t ln_fwd_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kNR + kNC) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kNT)
ln_linear_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ s,
                         const float* __restrict__ bn, const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ b, __nv_bfloat16* __restrict__ y, int R, int K,
                         float eps) {
  constexpr int PD = D + 8, CPT = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (NR, PD)
  __nv_bfloat16* ws = xn + kNR * PD;                                // (NC, PD) [j][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = (warp & 3) * 16, half = warp >> 2;
  const long long r0 = (long long)blockIdx.x * kNR;

  for (int r = warp; r < kNR; r += 8) {
    const long long row = r0 + r;
    float v[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      v[c] = row < R ? __bfloat162float(x[row * D + lane + 32 * c]) : 0.f;
    float mu, rstd;
    warp_ln_stats<D>(v, eps, mu, rstd);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = lane + 32 * c;
      xn[r * PD + col] = __float2bfloat16_rn((v[c] - mu) * rstd * s[col] + bn[col]);
    }
  }

  for (int c0 = 0; c0 < K; c0 += kNC) {
    __syncthreads();  // xn written / the previous chunk consumed
    for (int i = tid; i < kNC * D / 8; i += kNT) {
      const int j = i / (D / 8), k = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + j * PD + k) =
          *reinterpret_cast<const uint4*>(w + (long long)(c0 + j) * D + k);
    }
    __syncthreads();
    float h[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[j][e] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4];
      ld_a_frag(a, xn + rb * PD + k0, PD, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* bp = ws + (32 * half + 8 * j + g) * PD + k0 + 2 * t;
        mma_bf16_16816(h[j], a, ld_pair(bp), ld_pair(bp + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + 32 * half + 8 * j + 2 * t;
      const float b0 = b[col], b1 = b[col + 1];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long row = r0 + rb + g + 8 * hr;
        if (row < R)
          *reinterpret_cast<uint32_t*>(y + row * K + col) =
              pack_bf16(h[j][2 * hr] + b0, h[j][2 * hr + 1] + b1);
      }
    }
  }
}

template <int D>
int launch_ln_fwd_mma(const void* x, const float* s, const float* bn, const void* w,
                      const float* b, void* y, int R, int K, float eps, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const size_t smem = ln_fwd_mma_smem_bytes<D>();
  cudaFuncSetAttribute(ln_linear_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  ln_linear_fwd_mma_kernel<D><<<(R + kNR - 1) / kNR, kNT, smem, stream>>>(
      static_cast<const T*>(x), s, bn, static_cast<const T*>(w), b, static_cast<T*>(y), R, K,
      eps);
  return (int)cudaGetLastError();
}

template int launch_ln_fwd_mma<384>(const void*, const float*, const float*, const void*,
                                     const float*, void*, int, int, float, cudaStream_t);
template int launch_ln_fwd_mma<192>(const void*, const float*, const float*, const void*,
                                     const float*, void*, int, int, float, cudaStream_t);

}  // namespace vitocm
