// Fused LayerNorm -> linear (the LN1 -> qkv projection of a ViT block on the
// TRAIN.LN_QKV route), forward and backward, f32 storage, CUDA cores; the C
// entry points for both storage types.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/ln_linear.py::_ln_linear_fwd_kernel
// and ::_ln_linear_bwd_kernel. With xn = round(LN(x) s + bn) (statistics in
// f32, biased variance) and W in nn.Linear's (K, D) layout:
//   y = round(xn W^T + b), the bias added in f32 before the one rounding;
//   dxn = dy W, dx = LN-backward(dxn) (no residual), dW = dy^T xn (K, D),
//   db = sum dy, ds = sum dxn * xh, dbb = sum dxn, every gradient in f32.
// The TPU kernels keep only x as the residual and recompute the row
// statistics in the backward; so do these.
//
// What changes on Hopper: the TPU backward carries dW, db, ds and dbb across
// a sequential grid axis. Here, as in fused_mlp_bwd.cu, deterministic
// kernels with no atomics: (1) dx, a CTA per row tile walking K in chunks,
// dxn in registers, then the LN backward; it writes dx, xn (for kernel 2,
// which would otherwise recompute the LayerNorm once per column block) and
// its tile's ds/dbb partials; (2) weights, a CTA per (row split, 32 columns
// of K) accumulating dW rows and db over its split, one f32 partial per
// split; (3) the fixed-order reduction of fused_mlp_bwd.cu. Two runs give
// bit-equal gradients.
//
// f32 here: forward 32 rows a CTA and 64 output columns a chunk (a 2 x 4
// block a thread, 148 KB of shared memory at D = 384); backward 32-row tiles
// and 32-column chunks. Bound by FMA issue and shared-memory loads on the
// CUDA cores (no TF32): at the MIM shape x (36880, 384), W (1152, 384) the
// forward is 32.6 GFLOP against 0.2 GB of HBM traffic. bf16 storage takes
// the tensor-core kernels of ln_linear_mma.cu.

#include <math.h>

#include "common.cuh"

namespace vitocm {

constexpr int kLR = 32;   // rows per CTA or tile
constexpr int kLC = 64;   // output columns per forward chunk
constexpr int kLH = 32;   // columns of K per backward chunk / weight CTA
constexpr int kLT = 256;  // threads: 8 warps, warp w owns rows w + 8i

template <int D>
constexpr size_t ln_fwd_smem_bytes() {
  return sizeof(float) * (kLR + kLC) * (D + 1);
}

template <int D>
constexpr size_t ln_bwd_dx_smem_bytes() {
  return sizeof(float) * (kLR * (kLH + 1) + 2 * kLH * (D + 1));
}

template <int D>
constexpr size_t ln_bwd_w_smem_bytes() {
  return sizeof(float) * (kLR * (D + 1) + kLR * (kLH + 1));
}

template <int D>
__global__ void __launch_bounds__(kLT)
ln_linear_fwd_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ bn, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ y, int R, int K, float eps) {
  constexpr int PD = D + 1, CPT = D / 32;
  extern __shared__ float sm[];
  float* xn = sm;               // (LR, PD)
  float* ws = xn + kLR * PD;    // (LC, PD): ws[j][k] = W[c0 + j][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * kLR;
#pragma unroll
  for (int i = 0; i < kLR / 8; ++i) {
    const int r = warp + 8 * i;
    const long long row = r0 + r;
    float v[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) v[c] = row < R ? x[row * D + lane + 32 * c] : 0.f;
    float mu, rstd;
    warp_ln_stats<D>(v, eps, mu, rstd);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = lane + 32 * c;
      xn[r * PD + col] = (v[c] - mu) * rstd * s[col] + bn[col];
    }
  }

  // a 2 x 4 block a thread: rows tr + 16i, columns tc + 16j of the chunk
  const int tr = tid / 16, tc = tid % 16;
  for (int c0 = 0; c0 < K; c0 += kLC) {
    __syncthreads();  // xn written / the previous chunk consumed
    for (int i = tid; i < kLC * D; i += kLT) {
      const int j = i / D, k = i % D;
      ws[j * PD + k] = w[(long long)(c0 + j) * D + k];
    }
    __syncthreads();
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      float xv[2], wv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) xv[i] = xn[(tr + 16 * i) * PD + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[(tc + 16 * j) * PD + k];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long row = r0 + tr + 16 * i;
      if (row >= R) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tc + 16 * j;
        y[row * K + col] = acc[i][j] + b[col];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kLT)
ln_linear_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                        const float* __restrict__ s, const float* __restrict__ bn,
                        const float* __restrict__ w, float* __restrict__ dx,
                        float* __restrict__ xn_out, float* __restrict__ ln_part, int R, int K,
                        float eps) {
  constexpr int PD = D + 1, PG = kLH + 1, CPT = D / 32, RPW = kLR / 8;
  extern __shared__ float sm[];
  float* dys = sm;               // (LR, PG)
  float* ws = dys + kLR * PG;    // (LH, PD): ws[j][c] = W[c0 + j][c]; then dxn
  float* prod = ws + kLH * PD;   // (LR, PD): dxn * xh

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * kLR;

  float acc[RPW][CPT];  // dxn of rows warp + 8i, columns lane + 32c
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int c0 = 0; c0 < K; c0 += kLH) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kLR * kLH; i += kLT) {
      const int r = i / kLH, j = i % kLH;
      dys[r * PG + j] = r0 + r < R ? dy[(r0 + r) * K + c0 + j] : 0.f;
    }
    for (int i = tid; i < kLH * D; i += kLT) {
      const int j = i / D, c = i % D;
      ws[j * PD + c] = w[(long long)(c0 + j) * D + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kLH; ++j) {
      float wv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) wv[c] = ws[j * PD + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float d = dys[(warp + 8 * i) * PG + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(d, wv[c], acc[i][c]);
      }
    }
  }
  __syncthreads();  // ws is free: it takes dxn

  // LN backward, one warp per row: dx = r (dxh - mean(dxh) - xh mean(dxh xh))
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + 8 * i;
    const long long row = r0 + r;
    float v[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) v[c] = row < R ? x[row * D + lane + 32 * c] : 0.f;
    float mu, rstd;
    warp_ln_stats<D>(v, eps, mu, rstd);
    float s_a = 0.f, s_b = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = lane + 32 * c;
      v[c] = (v[c] - mu) * rstd;  // xh
      const float dxh = acc[i][c] * s[col];
      s_a += dxh;
      s_b += dxh * v[c];
      // padded rows (x = 0, dy = 0) give dxn = 0: nothing in the partials
      ws[r * PD + col] = acc[i][c];
      prod[r * PD + col] = acc[i][c] * v[c];
    }
    const float m1 = warp_sum(s_a) / D, m2 = warp_sum(s_b) / D;
    if (row < R) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = lane + 32 * c;
        dx[row * D + col] = rstd * (acc[i][c] * s[col] - m1 - v[c] * m2);
        xn_out[row * D + col] = v[c] * s[col] + bn[col];
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < D; c += kLT) {
    float sd = 0.f, sb = 0.f;
    for (int r = 0; r < kLR; ++r) {
      sd += prod[r * PD + c];
      sb += ws[r * PD + c];
    }
    ln_part[(long long)blockIdx.x * 2 * D + c] = sd;
    ln_part[(long long)blockIdx.x * 2 * D + D + c] = sb;
  }
}

template <int D>
__global__ void __launch_bounds__(kLT)
ln_linear_bwd_w_kernel(const float* __restrict__ xn_in, const float* __restrict__ dy,
                       float* __restrict__ part, int R, int K, int rows_per_split) {
  constexpr int PD = D + 1, PG = kLH + 1, CPT = D / 32, RPW = kLH / 8;
  extern __shared__ float sm[];
  float* xn = sm;              // (LR, PD)
  float* dys = xn + kLR * PD;  // (LR, PG)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.y * kLH;
  const long long rs0 = (long long)blockIdx.x * rows_per_split;
  const long long rs1 = min((long long)R, rs0 + rows_per_split);
  part += blockIdx.x * ((long long)K * D + K);

  float a1[RPW][CPT];  // dW[c0 + warp + 8i][lane + 32c]
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) a1[i][c] = 0.f;
  float db = 0.f;

  for (long long t0 = rs0; t0 < rs1; t0 += kLR) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kLR * D; i += kLT) {
      const int r = i / D, c = i % D;
      xn[r * PD + c] = t0 + r < rs1 ? xn_in[(t0 + r) * D + c] : 0.f;
    }
    for (int i = tid; i < kLR * kLH; i += kLT) {
      const int r = i / kLH, j = i % kLH;
      dys[r * PG + j] = t0 + r < rs1 ? dy[(t0 + r) * K + c0 + j] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kLR; ++r) {
      float xv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) xv[c] = xn[r * PD + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float d = dys[r * PG + warp + 8 * i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) a1[i][c] = fmaf(d, xv[c], a1[i][c]);
      }
    }
    if (tid < kLH)
      for (int r = 0; r < kLR; ++r) db += dys[r * PG + tid];
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      part[(long long)(c0 + warp + 8 * i) * D + lane + 32 * c] = a1[i][c];
  if (tid < kLH) part[(long long)K * D + c0 + tid] = db;
}

template <int D>
static int launch_ln_fwd(const void* x, const float* s, const float* bn, const void* w,
                         const float* b, void* y, int R, int K, float eps, cudaStream_t stream) {
  const size_t smem = ln_fwd_smem_bytes<D>();
  cudaFuncSetAttribute(ln_linear_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  ln_linear_fwd_kernel<D><<<(R + kLR - 1) / kLR, kLT, smem, stream>>>(
      static_cast<const float*>(x), s, bn, static_cast<const float*>(w), b,
      static_cast<float*>(y), R, K, eps);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_ln_bwd(const void* x, const void* dy, const float* s, const float* bn,
                         const void* w, void* dx, void* xn, float* ln_part, float* part, int R,
                         int K, int splits, int rps, float eps, cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t s_dx = ln_bwd_dx_smem_bytes<D>(), s_w = ln_bwd_w_smem_bytes<D>();
  cudaFuncSetAttribute(ln_linear_bwd_dx_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s_dx);
  cudaFuncSetAttribute(ln_linear_bwd_w_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s_w);
  ln_linear_bwd_dx_kernel<D><<<(R + kLR - 1) / kLR, kLT, s_dx, stream>>>(
      f(x), f(dy), s, bn, f(w), static_cast<float*>(dx), static_cast<float*>(xn), ln_part, R, K,
      eps);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ln_linear_bwd_w_kernel<D><<<dim3(splits, K / kLH), kLT, s_w, stream>>>(f(xn), f(dy), part, R,
                                                                          K, rps);
  return (int)cudaGetLastError();
}

// bf16 storage takes the tensor-core kernels of ln_linear_mma.cu
template <int D>
int launch_ln_fwd_mma(const void* x, const float* s, const float* bn, const void* w,
                      const float* b, void* y, int R, int K, float eps, cudaStream_t stream);
template <int D>
int launch_ln_bwd_mma(const void* x, const void* dy, const float* s, const float* bn,
                      const void* w, void* dx, void* xn, float* ln_part, float* part, int R,
                      int K, int splits, int rps, float eps, cudaStream_t stream);

// rows of the dx kernel's tile for each storage type
static int ln_row_tile(int dtype) { return dtype == kF32 ? kLR : 64; }

}  // namespace vitocm

// x (R, D), w (K, D), y (R, K) in the storage type; s, bn (D) and b (K) f32.
// D in {192, 384}, K a multiple of 64. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int vitocm_ln_linear(int dtype, const void* x, const void* s, const void* bn,
                                const void* w, const void* b, void* y, int R, int D, int K,
                                float eps, void* stream) {
  using namespace vitocm;
  if (R < 1 || K < 64 || K % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == kF32 && D == 384)
    return launch_ln_fwd<384>(x, f(s), f(bn), w, f(b), y, R, K, eps, st);
  if (dtype == kF32 && D == 192)
    return launch_ln_fwd<192>(x, f(s), f(bn), w, f(b), y, R, K, eps, st);
  if (dtype == kBF16 && D == 384)
    return launch_ln_fwd_mma<384>(x, f(s), f(bn), w, f(b), y, R, K, eps, st);
  if (dtype == kBF16 && D == 192)
    return launch_ln_fwd_mma<192>(x, f(s), f(bn), w, f(b), y, R, K, eps, st);
  return (int)cudaErrorInvalidValue;
}

// x, dx (R, D), dy (R, K), w (K, D) in the storage type; s, bn (D) f32.
// Workspaces: xn (R, D) in the storage type (LN(x) from the dx kernel for
// the weight kernel), part (splits, K D + K) and ln_part (ceil(R / 32), 2D)
// in f32. grads (K D + K + 2D) f32 receives [dW (K, D) | db (K) | ds (D) |
// dbb (D)]. D in {192, 384}, K a multiple of 64. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int vitocm_ln_linear_bwd(int dtype, const void* x, const void* dy, const void* s,
                                    const void* bn, const void* w, void* dx, void* xn, void* part,
                                    void* ln_part, void* grads, int R, int D, int K, int splits,
                                    float eps, void* stream) {
  using namespace vitocm;
  if (R < 1 || K < 64 || K % 64 != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fs = static_cast<const float*>(s), *fbn = static_cast<const float*>(bn);
  float *fpart = static_cast<float*>(part), *fln = static_cast<float*>(ln_part);
  const int tile = ln_row_tile(dtype);
  const int rps = ((R + splits - 1) / splits + tile - 1) / tile * tile;  // whole tiles
  int rc = (int)cudaErrorInvalidValue;
  if (dtype == kF32 && D == 384)
    rc = launch_ln_bwd<384>(x, dy, fs, fbn, w, dx, xn, fln, fpart, R, K, splits, rps, eps, st);
  else if (dtype == kF32 && D == 192)
    rc = launch_ln_bwd<192>(x, dy, fs, fbn, w, dx, xn, fln, fpart, R, K, splits, rps, eps, st);
  else if (dtype == kBF16 && D == 384)
    rc = launch_ln_bwd_mma<384>(x, dy, fs, fbn, w, dx, xn, fln, fpart, R, K, splits, rps, eps,
                                st);
  else if (dtype == kBF16 && D == 192)
    rc = launch_ln_bwd_mma<192>(x, dy, fs, fbn, w, dx, xn, fln, fpart, R, K, splits, rps, eps,
                                st);
  if (rc != 0) return rc;
  const long long W = (long long)K * D + K;
  float* g = static_cast<float*>(grads);
  rc = reduce_splits(fpart, g, splits, W, st);
  if (rc != 0) return rc;
  return reduce_splits(fln, g + W, (R + tile - 1) / tile, 2LL * D, st);
}
