// bf16 variant of csrc/ln_linear.cu on the tensor cores (mma.sync
// m16n8k16, f32 accumulation). Same contract, the same three-kernel
// backward and the TPU kernels' rounding points
// (ops/ln_linear.py::_ln_linear_fwd_kernel, ::_ln_linear_bwd_kernel): xn
// rounded to bf16 before each product, y = bf16(xn W^T + b) with the bias
// added in f32, dx rounded once, every parameter gradient in f32.
//
// Forward: a CTA owns 64 rows, normalizes them once into shared memory and
// walks the K output columns in chunks of 64 (the first half of
// fused_mlp_mma.cu): per chunk it stages 64 rows of W, and warp w computes
// rows 16 (w % 4).. by columns 32 (w / 4).. of the chunk. 100 KB of shared
// memory at D = 384, two CTAs an SM. At the MIM shape (36880, 384) x (1152,
// 384) it is 32.6 GFLOP on 0.17 GB of HBM traffic: tensor-core issue and the
// per-chunk loads of W from L2 (every CTA reads all of W, 0.88 MB) bound it.
//
// Backward, dx kernel: 64 rows a CTA, K in chunks of 64; per chunk it stages
// the dy tile (64 x 64) and 64 rows of W (64 x D), and dxn += dy_c W_c into
// a 16 x D/2 f32 accumulator a warp (fused_mlp_bwd_mma.cu's dxn += dh1 W1).
// The epilogue stages dxn in f32 for the LN backward, one warp a row, which
// writes dx, xn and the tile's ds / dbb partials. Weight kernel: a CTA owns
// (row split, 32 columns of K); per 64-row tile it stages xn and the dy
// tile, and dW_c += dy_c^T xn (warp w: 16 of the 32 rows of dW_c by D/4
// columns, dy through ldmatrix.trans); db from the staged dy tile.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace vitocm {

constexpr int kNR = 64;          // rows per CTA or tile
constexpr int kNC = 64;          // columns of K per forward / dx chunk
constexpr int kNW = 32;          // columns of K per weight CTA
constexpr int kNT = 256;         // threads (8 warps)
constexpr int kNP = kNC + 8;     // pitch of the dx kernel's dy tile
constexpr int kNWP = kNW + 8;    // pitch of the weight kernel's dy tile

template <int D>
constexpr size_t ln_fwd_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kNR + kNC) * (D + 8);
}

template <int D>
constexpr size_t ln_bwd_dx_mma_smem_bytes() {
  const size_t staging = sizeof(__nv_bfloat16) * (kNR * kNP + kNC * (D + 8));
  const size_t epilogue = sizeof(float) * (kNR * D + 2 * kNR);
  return staging > epilogue ? staging : epilogue;
}

template <int D>
constexpr size_t ln_bwd_w_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kNR * (D + 8) + kNR * kNWP);
}

// rows r0 .. r0+63, columns c0 .. c0+COLS-1 of an (R, ld) bf16 matrix into
// shared memory (pitch COLS + 8), zeros from row `end` on, 16 bytes a load
template <int COLS>
__device__ __forceinline__ void ln_stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                         long long r0, long long end, int ld, int c0) {
  for (int i = threadIdx.x; i < kNR * COLS / 8; i += kNT) {
    const int r = i / (COLS / 8), c = (i % (COLS / 8)) * 8;
    const uint4 val =
        *reinterpret_cast<const uint4*>(src + min(r0 + r, end - 1) * ld + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * (COLS + 8) + c) =
        r0 + r < end ? val : make_uint4(0, 0, 0, 0);
  }
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
__global__ void __launch_bounds__(kNT)
ln_linear_bwd_dx_mma_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ dy, const float* __restrict__ s,
                            const float* __restrict__ bn, const __nv_bfloat16* __restrict__ w,
                            __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ xn_out,
                            float* __restrict__ ln_part, int R, int K, float eps) {
  constexpr int PD = D + 8, CPT = D / 32, NT2 = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* dys = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (NR, NP)
  __nv_bfloat16* ws = dys + kNR * kNP;                              // (NC, PD) [j][c]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = (warp & 3) * 16, half = warp >> 2;
  const long long r0 = (long long)blockIdx.x * kNR;

  float acc[NT2][4];  // dxn: rows rb + g (+8), columns (D/2)*half + 8j + 2t (+1)
#pragma unroll
  for (int j = 0; j < NT2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int c0 = 0; c0 < K; c0 += kNC) {
    __syncthreads();  // the previous chunk is consumed
    ln_stage<kNC>(dys, dy, r0, R, K, c0);
    for (int i = tid; i < kNC * D / 8; i += kNT) {
      const int j = i / (D / 8), k = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + j * PD + k) =
          *reinterpret_cast<const uint4*>(w + (long long)(c0 + j) * D + k);
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kNC; k0 += 16) {
      uint32_t a[4], bf[4];
      ld_a_frag(a, dys + rb * kNP + k0, kNP, g, t);
#pragma unroll
      for (int j = 0; j < NT2; j += 2) {
        ld_b_frag2(bf, ws, PD, k0, (D / 2) * half + 8 * j, lane);
        mma_bf16_16816(acc[j], a, bf[0], bf[1]);
        mma_bf16_16816(acc[j + 1], a, bf[2], bf[3]);
      }
    }
  }
  __syncthreads();  // the staging area takes dxn (f32) and the row statistics

  float* dxs = reinterpret_cast<float*>(smem_raw);  // (NR, D)
  float* mu_s = dxs + kNR * D;
  float* rstd_s = mu_s + kNR;
#pragma unroll
  for (int j = 0; j < NT2; ++j) {
    const int col = (D / 2) * half + 8 * j + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      dxs[(rb + g + 8 * hr) * D + col] = acc[j][2 * hr];
      dxs[(rb + g + 8 * hr) * D + col + 1] = acc[j][2 * hr + 1];
    }
  }
  __syncthreads();

  // LN backward, one warp per row: dx = r (dxh - mean(dxh) - xh mean(dxh xh))
  for (int r = warp; r < kNR; r += 8) {
    const long long row = r0 + r;
    float v[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      v[c] = row < R ? __bfloat162float(x[row * D + lane + 32 * c]) : 0.f;
    float mu, rstd;
    warp_ln_stats<D>(v, eps, mu, rstd);
    float s_a = 0.f, s_b = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = lane + 32 * c;
      v[c] = (v[c] - mu) * rstd;  // xh
      const float dxh = dxs[r * D + col] * s[col];
      s_a += dxh;
      s_b += dxh * v[c];
    }
    const float m1 = warp_sum(s_a) / D, m2 = warp_sum(s_b) / D;
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
    if (row < R) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = lane + 32 * c;
        const float dxh = dxs[r * D + col] * s[col];
        dx[row * D + col] = __float2bfloat16_rn(rstd * (dxh - m1 - v[c] * m2));
        xn_out[row * D + col] = __float2bfloat16_rn(v[c] * s[col] + bn[col]);
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < D; c += kNT) {
    float sd = 0.f, sb = 0.f;
    for (int r = 0; r < kNR; ++r) {
      const long long row = r0 + r;
      if (row >= R) break;
      const float dxn = dxs[r * D + c];
      sd += dxn * ((__bfloat162float(x[row * D + c]) - mu_s[r]) * rstd_s[r]);
      sb += dxn;
    }
    ln_part[(long long)blockIdx.x * 2 * D + c] = sd;
    ln_part[(long long)blockIdx.x * 2 * D + D + c] = sb;
  }
}

template <int D>
__global__ void __launch_bounds__(kNT)
ln_linear_bwd_w_mma_kernel(const __nv_bfloat16* __restrict__ xn_in,
                           const __nv_bfloat16* __restrict__ dy, float* __restrict__ part, int R,
                           int K, int rows_per_split) {
  constexpr int PD = D + 8, NT1 = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (NR, PD)
  __nv_bfloat16* dys = xn + kNR * PD;                               // (NR, NWP)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.y * kNW;
  const long long rs0 = (long long)blockIdx.x * rows_per_split;
  const long long rs1 = min((long long)R, rs0 + rows_per_split);
  part += blockIdx.x * ((long long)K * D + K);

  // dW_c: rows 16*(warp%2) + g (+8) of the 32, columns (warp/2)*(D/4) + 8j + 2t (+1)
  float a1[NT1][4];
#pragma unroll
  for (int j = 0; j < NT1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a1[j][e] = 0.f;
  float db = 0.f;

  for (long long t0 = rs0; t0 < rs1; t0 += kNR) {
    __syncthreads();  // the previous tile is consumed
    ln_stage<D>(xn, xn_in, t0, rs1, D, 0);
    ln_stage<kNW>(dys, dy, t0, rs1, K, c0);
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kNR; k0 += 16) {
      uint32_t a[4], bf[4];
      ld_a_frag_t(a, dys, kNWP, k0, 16 * (warp & 1), lane);
#pragma unroll
      for (int j = 0; j < NT1; j += 2) {
        ld_b_frag2(bf, xn, PD, k0, (warp >> 1) * (D / 4) + 8 * j, lane);
        mma_bf16_16816(a1[j], a, bf[0], bf[1]);
        mma_bf16_16816(a1[j + 1], a, bf[2], bf[3]);
      }
    }
    if (tid < kNW)
      for (int r = 0; r < kNR; ++r) db += __bfloat162float(dys[r * kNWP + tid]);
  }

#pragma unroll
  for (int j = 0; j < NT1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = c0 + 16 * (warp & 1) + g + 8 * (e >> 1);
      const int c = (warp >> 1) * (D / 4) + 8 * j + 2 * t + (e & 1);
      part[(long long)kj * D + c] = a1[j][e];
    }
  if (tid < kNW) part[(long long)K * D + c0 + tid] = db;
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

template <int D>
int launch_ln_bwd_mma(const void* x, const void* dy, const float* s, const float* bn,
                      const void* w, void* dx, void* xn, float* ln_part, float* part, int R,
                      int K, int splits, int rps, float eps, cudaStream_t stream) {
  using T = __nv_bfloat16;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  const size_t s_dx = ln_bwd_dx_mma_smem_bytes<D>(), s_w = ln_bwd_w_mma_smem_bytes<D>();
  cudaFuncSetAttribute(ln_linear_bwd_dx_mma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s_dx);
  cudaFuncSetAttribute(ln_linear_bwd_w_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s_w);
  ln_linear_bwd_dx_mma_kernel<D><<<(R + kNR - 1) / kNR, kNT, s_dx, stream>>>(
      c(x), c(dy), s, bn, c(w), static_cast<T*>(dx), static_cast<T*>(xn), ln_part, R, K, eps);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ln_linear_bwd_w_mma_kernel<D><<<dim3(splits, K / kNW), kNT, s_w, stream>>>(c(xn), c(dy), part,
                                                                              R, K, rps);
  return (int)cudaGetLastError();
}

#define VITOCM_LN_MMA(D)                                                                       \
  template int launch_ln_fwd_mma<D>(const void*, const float*, const float*, const void*,      \
                                    const float*, void*, int, int, float, cudaStream_t);       \
  template int launch_ln_bwd_mma<D>(const void*, const void*, const float*, const float*,      \
                                    const void*, void*, void*, float*, float*, int, int, int,  \
                                    int, float, cudaStream_t);
VITOCM_LN_MMA(384)
VITOCM_LN_MMA(192)
#undef VITOCM_LN_MMA

}  // namespace vitocm
