// Backward of the fused LayerNorm -> MLP -> residual block, f32 storage,
// CUDA cores; the split-reduction kernel and the C entry point for both
// storage types.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/fused_mlp.py::_mlp_bwd_kernel
// (_bwd_impl, the backward of fused_mlp_block on its save-h1 route). With
// xn = LN(x) s + b, g = gelu(h1), gp = gelu'(h1) from the forward's saved
// h1, and do the cotangent of out:
//   dg = do W2,  dh1 = round(dg * gp),  dxn = dh1 W1,
//   dx = do + LN-backward(dxn),  ds = sum dxn * xh,  dbb = sum dxn,
//   dW1 = dh1^T xn,  db1 = sum dh1,  dW2 = do^T round(g),  db2 = sum do.
// On the SAVE_GP route (gp not null; _mlp_bwd_kernel with gp_ref) h1 holds
// the forward's rounded g and gp its rounded gelu'(h1): the kernels read
// both and compute no erf and no exp; the weight kernel stages the g tile
// it reads where the save-h1 route stages the g it computes, so its shared
// memory stays as it is.
// Weights in nn.Linear's layouts: w1 (H, D), w2 (D, H); dW1 comes back as
// (H, D) and dW2 as (D, H), all parameter gradients in f32.
//
// What changes on Hopper: the TPU kernel carries the weight gradients
// across a sequential grid axis over row chunks. Here the work splits into
// deterministic kernels without atomics:
//   1. dx: a CTA owns a row tile and walks H in chunks, dxn in registers,
//      then the LN backward; it writes dx, its tile's partial ds, dbb, and
//      xn = LN(x) (R, D) for the weight kernel, which would otherwise
//      recompute the LayerNorm once for every hidden chunk;
//   2. weights: a CTA owns (row split, hidden chunk): it walks its split's
//      row tiles, reads xn, recomputes dg, dh1 and g for its chunk, and
//      accumulates that chunk's dW1 rows, dW2 columns, db1 (and, for chunk
//      0, db2) in registers; it writes one f32 partial per split;
//   3. reduce: partials summed over splits (and row tiles) in a fixed order.
// The (rows, H) hidden tensors dg, dh1 and g never reach device memory;
// the price is the dg product computed twice (10 R D H FLOPs, not 8). The
// workspace holds splits x (2 H D + H + D) f32 values: 75 MB at 16 splits,
// D = 384, H = 1536. f32 here: 32-row tiles and 32-unit chunks, 256 threads;
// bound by FMA issue and shared-memory loads on the CUDA cores (no TF32).
// bf16 storage takes the tensor-core kernels of fused_mlp_bwd_mma.cu.
//
// Numerics: LN statistics recomputed from x in f32 (biased variance);
// every product in f32; erff where the TPU kernel carries a rational erf
// (about 1 ulp apart).

#include <math.h>

#include "common.cuh"

namespace vitocm {

constexpr int kWR = 32;   // rows per tile (f32)
constexpr int kWH = 32;   // hidden units per chunk (f32)
constexpr int kWT = 256;  // threads

template <int D>
constexpr size_t mlp_bwd_dx_smem_bytes() {
  return sizeof(float) * (3 * kWR * (D + 1) + kWR * (kWH + 1));
}

template <int D>
constexpr size_t mlp_bwd_w_smem_bytes() {
  return sizeof(float) * (3 * kWR * (D + 1) + 2 * kWR * (kWH + 1));
}

template <int D, bool GP>
__global__ void __launch_bounds__(kWT)
mlp_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                  const float* __restrict__ h1, const float* __restrict__ gpp,
                  const float* __restrict__ s1,
                  const float* __restrict__ bn1, const float* __restrict__ w1,
                  const float* __restrict__ w2, float* __restrict__ dx,
                  float* __restrict__ xn_out, float* __restrict__ ln_part, int R, int H,
                  float eps) {
  constexpr int PD = D + 1, PG = kWH + 1, CPT = D / 32, RPW = kWR / 8;
  extern __shared__ float sm[];
  float* dos = sm;               // (WR, PD)
  float* w1s = dos + kWR * PD;   // (WH, PD): w1s[j][c] = W1[h0 + j][c]
  float* w2s = w1s + kWH * PD;   // (WH, PD): w2s[j][c] = W2[c][h0 + j]
  float* dh1s = w2s + kWH * PD;  // (WR, PG)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * kWR;
  for (int i = tid; i < kWR * D; i += kWT) {
    const int r = i / D, c = i % D;
    dos[r * PD + c] = r0 + r < R ? dout[(r0 + r) * D + c] : 0.f;
  }

  float acc[RPW][CPT];  // dxn of rows warp + 8i, columns lane + 32c
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kWH) {
    __syncthreads();  // dos written / the previous chunk consumed
    for (int i = tid; i < kWH * D; i += kWT) {
      const int j = i / D, k = i % D;
      w1s[j * PD + k] = w1[(long long)(h0 + j) * D + k];
    }
    for (int i = tid; i < kWH * D; i += kWT) {
      const int c = i / kWH, j = i % kWH;
      w2s[j * PD + c] = w2[(long long)c * H + h0 + j];
    }
    __syncthreads();

    {  // dg for hidden unit h0 + lane, rows warp + 8i; dh1 = dg * gelu'(h1)
      float h[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) h[i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float wv = w2s[lane * PD + c];
#pragma unroll
        for (int i = 0; i < RPW; ++i) h[i] = fmaf(dos[(warp + 8 * i) * PD + c], wv, h[i]);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const long long row = r0 + warp + 8 * i;
        float gv, gp;
        if (GP)
          gp = row < R ? gpp[row * H + h0 + lane] : 0.f;
        else
          gelu_pieces(row < R ? h1[row * H + h0 + lane] : 0.f, gv, gp);
        dh1s[(warp + 8 * i) * PG + lane] = h[i] * gp;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kWH; ++j) {
      float wv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) wv[c] = w1s[j * PD + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float d = dh1s[(warp + 8 * i) * PG + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(d, wv[c], acc[i][c]);
      }
    }
  }
  __syncthreads();  // w1s and w2s are free: they take dxn and dxn * xh

  // LN backward, one warp per row: dx = do + r (dxh - mean(dxh) - xh mean(dxh xh))
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
      const float dxh = acc[i][c] * s1[col];
      s_a += dxh;
      s_b += dxh * v[c];
      w1s[r * PD + col] = acc[i][c];
      w2s[r * PD + col] = acc[i][c] * v[c];
    }
    const float m1 = warp_sum(s_a) / D, m2 = warp_sum(s_b) / D;
    if (row < R) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = lane + 32 * c;
        const float dxh = acc[i][c] * s1[col];
        dx[row * D + col] = dos[r * PD + col] + rstd * (dxh - m1 - v[c] * m2);
        xn_out[row * D + col] = v[c] * s1[col] + bn1[col];
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < D; c += kWT) {
    float sd = 0.f, sb = 0.f;
    for (int r = 0; r < kWR; ++r) {
      sd += w2s[r * PD + c];
      sb += w1s[r * PD + c];
    }
    ln_part[(long long)blockIdx.x * 2 * D + c] = sd;
    ln_part[(long long)blockIdx.x * 2 * D + D + c] = sb;
  }
}

template <int D, bool GP>
__global__ void __launch_bounds__(kWT)
mlp_bwd_w_kernel(const float* __restrict__ xn_in, const float* __restrict__ dout,
                 const float* __restrict__ h1, const float* __restrict__ gpp,
                 const float* __restrict__ w2,
                 float* __restrict__ part, int R, int H, int rows_per_split) {
  constexpr int PD = D + 1, PG = kWH + 1, CPT = D / 32, RPW = kWR / 8;
  constexpr int NC2 = (D + kWT - 1) / kWT;
  extern __shared__ float sm[];
  float* xn = sm;                // (WR, PD)
  float* dos = xn + kWR * PD;    // (WR, PD)
  float* w2s = dos + kWR * PD;   // (WH, PD): w2s[j][c] = W2[c][h0 + j]
  float* dh1s = w2s + kWH * PD;  // (WR, PG)
  float* gs = dh1s + kWR * PG;   // (WR, PG)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = blockIdx.y * kWH;
  const long long rs0 = (long long)blockIdx.x * rows_per_split;
  const long long rs1 = min((long long)R, rs0 + rows_per_split);
  const long long W = 2LL * H * D + H + D;
  part += blockIdx.x * W;

  for (int i = tid; i < kWH * D; i += kWT) {
    const int c = i / kWH, j = i % kWH;
    w2s[j * PD + c] = w2[(long long)c * H + h0 + j];
  }
  float a1[RPW][CPT];  // dW1[h0 + warp + 8i][lane + 32c]
  float a2[RPW][CPT];  // dW2[lane + 32c][h0 + warp + 8i]
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) a1[i][c] = a2[i][c] = 0.f;
  float db1 = 0.f, db2[NC2];
#pragma unroll
  for (int k = 0; k < NC2; ++k) db2[k] = 0.f;

  for (long long t0 = rs0; t0 < rs1; t0 += kWR) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + 8 * i;
      const long long row = t0 + r;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = lane + 32 * c;
        xn[r * PD + col] = row < rs1 ? xn_in[row * D + col] : 0.f;
        dos[r * PD + col] = row < rs1 ? dout[row * D + col] : 0.f;
      }
    }
    __syncthreads();

    {  // dg, g and dh1 for hidden unit h0 + lane, rows warp + 8i
      float h[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) h[i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float wv = w2s[lane * PD + c];
#pragma unroll
        for (int i = 0; i < RPW; ++i) h[i] = fmaf(dos[(warp + 8 * i) * PD + c], wv, h[i]);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const long long row = t0 + warp + 8 * i;
        float gv, gp;
        if (GP) {
          gv = row < rs1 ? h1[row * H + h0 + lane] : 0.f;
          gp = row < rs1 ? gpp[row * H + h0 + lane] : 0.f;
        } else {
          gelu_pieces(row < rs1 ? h1[row * H + h0 + lane] : 0.f, gv, gp);
        }
        gs[(warp + 8 * i) * PG + lane] = gv;
        dh1s[(warp + 8 * i) * PG + lane] = h[i] * gp;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < kWR; ++r) {
      float xv[CPT], dv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        xv[c] = xn[r * PD + lane + 32 * c];
        dv[c] = dos[r * PD + lane + 32 * c];
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float d = dh1s[r * PG + warp + 8 * i], gv = gs[r * PG + warp + 8 * i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          a1[i][c] = fmaf(d, xv[c], a1[i][c]);
          a2[i][c] = fmaf(dv[c], gv, a2[i][c]);
        }
      }
    }
    if (tid < kWH)
      for (int r = 0; r < kWR; ++r) db1 += dh1s[r * PG + tid];
    if (blockIdx.y == 0) {
#pragma unroll
      for (int k = 0; k < NC2; ++k) {
        const int c = tid + kWT * k;
        if (c < D)
          for (int r = 0; r < kWR; ++r) db2[k] += dos[r * PD + c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int j = h0 + warp + 8 * i;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = lane + 32 * c;
      part[(long long)j * D + col] = a1[i][c];
      part[(long long)H * D + (long long)col * H + j] = a2[i][c];
    }
  }
  if (tid < kWH) part[2LL * H * D + h0 + tid] = db1;
  if (blockIdx.y == 0) {
#pragma unroll
    for (int k = 0; k < NC2; ++k) {
      const int c = tid + kWT * k;
      if (c < D) part[2LL * H * D + H + c] = db2[k];
    }
  }
}

// out[i] = sum over s < S of part[s * W + i], in order of s
__global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int S, long long W) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < W;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[s * W + i];
    out[i] = acc;
  }
}

int reduce_splits(const float* part, float* out, int S, long long W, cudaStream_t stream) {
  const int blocks = (int)min((W + 255) / 256, 4096LL);
  reduce_splits_kernel<<<blocks, 256, 0, stream>>>(part, out, S, W);
  return (int)cudaGetLastError();
}

template <int D, bool GP>
static int launch_mlp_bwd(const void* x, const void* dout, const void* h1, const void* gp,
                          const float* s1, const float* bn1, const void* w1, const void* w2,
                          void* dx, void* xn, float* ln_part, float* part, int R, int H,
                          int splits, int rps, float eps, cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t s_dx = mlp_bwd_dx_smem_bytes<D>(), s_w = mlp_bwd_w_smem_bytes<D>();
  cudaFuncSetAttribute(mlp_bwd_dx_kernel<D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s_dx);
  cudaFuncSetAttribute(mlp_bwd_w_kernel<D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s_w);
  mlp_bwd_dx_kernel<D, GP><<<(R + kWR - 1) / kWR, kWT, s_dx, stream>>>(
      f(x), f(dout), f(h1), f(gp), s1, bn1, f(w1), f(w2), static_cast<float*>(dx),
      static_cast<float*>(xn), ln_part, R, H, eps);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  mlp_bwd_w_kernel<D, GP><<<dim3(splits, H / kWH), kWT, s_w, stream>>>(
      f(xn), f(dout), f(h1), f(gp), f(w2), part, R, H, rps);
  return (int)cudaGetLastError();
}

// bf16 storage takes the tensor-core kernels of fused_mlp_bwd_mma.cu
template <int D, bool GP>
int launch_mlp_bwd_mma(const void* x, const void* dout, const void* h1, const void* gp,
                       const float* s1, const float* bn1, const void* w1, const void* w2,
                       void* dx, void* xn, float* ln_part, float* part, int R, int H, int splits,
                       int rps, float eps, cudaStream_t stream);

template <int D, bool GP>
static int launch_any_mlp_bwd(int dtype, const void* x, const void* dout, const void* h1,
                              const void* gp, const float* s1, const float* bn1, const void* w1,
                              const void* w2, void* dx, void* xn, float* ln_part, float* part,
                              int R, int H, int splits, int rps, float eps, cudaStream_t s) {
  if (dtype == kF32)
    return launch_mlp_bwd<D, GP>(x, dout, h1, gp, s1, bn1, w1, w2, dx, xn, ln_part, part, R, H,
                                 splits, rps, eps, s);
  if (dtype == kBF16)
    return launch_mlp_bwd_mma<D, GP>(x, dout, h1, gp, s1, bn1, w1, w2, dx, xn, ln_part, part, R,
                                     H, splits, rps, eps, s);
  return (int)cudaErrorInvalidValue;
}

template <int D>
static int launch_mlp_bwd_route(int dtype, const void* x, const void* dout, const void* h1,
                                const void* gp, const float* s1, const float* bn1,
                                const void* w1, const void* w2, void* dx, void* xn,
                                float* ln_part, float* part, int R, int H, int splits, int rps,
                                float eps, cudaStream_t s) {
  if (gp != nullptr)
    return launch_any_mlp_bwd<D, true>(dtype, x, dout, h1, gp, s1, bn1, w1, w2, dx, xn, ln_part,
                                       part, R, H, splits, rps, eps, s);
  return launch_any_mlp_bwd<D, false>(dtype, x, dout, h1, gp, s1, bn1, w1, w2, dx, xn, ln_part,
                                      part, R, H, splits, rps, eps, s);
}

// rows of the dx kernel's tile for each storage type
static int bwd_row_tile(int dtype) { return dtype == kF32 ? 32 : 64; }

}  // namespace vitocm

// x, dout, dx (R, D), h1 (R, H), w1 (H, D), w2 (D, H) in the storage type;
// gp null (save-h1 route: h1 is the pre-GELU activation) or (R, H) in the
// storage type (SAVE_GP route: h1 holds g = gelu(h1), gp gelu'(h1));
// s1, bn1 (D) f32. Workspaces: xn (R, D) in the storage type (the dx
// kernel writes LN(x) there for the weight kernel), part (splits, 2HD + H +
// D) and ln_part (ceil(R / 32), 2D) in f32. grads (2HD + H + 3D) f32
// receives [dW1 (H, D) | dW2 (D, H) | db1 (H) | db2 (D) | ds (D) | dbb (D)].
// D in {192, 384}, H a multiple of 64. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int vitocm_fused_mlp_bwd(int dtype, const void* x, const void* dout, const void* h1,
                                    const void* gp, const void* s1, const void* bn1, const void* w1,
                                    const void* w2, void* dx, void* xn, void* part, void* ln_part,
                                    void* grads, int R, int D, int H, int splits, float eps,
                                    void* stream) {
  using namespace vitocm;
  if (R < 1 || H < 64 || H % 64 != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fs1 = static_cast<const float*>(s1), *fbn1 = static_cast<const float*>(bn1);
  float *fpart = static_cast<float*>(part), *fln = static_cast<float*>(ln_part);
  const int tile = bwd_row_tile(dtype);
  // rows per split: a whole number of tiles
  const int rps = ((R + splits - 1) / splits + tile - 1) / tile * tile;
  int rc = (int)cudaErrorInvalidValue;
  if (D == 384)
    rc = launch_mlp_bwd_route<384>(dtype, x, dout, h1, gp, fs1, fbn1, w1, w2, dx, xn, fln, fpart,
                                   R, H, splits, rps, eps, s);
  else if (D == 192)
    rc = launch_mlp_bwd_route<192>(dtype, x, dout, h1, gp, fs1, fbn1, w1, w2, dx, xn, fln, fpart,
                                   R, H, splits, rps, eps, s);
  if (rc != 0) return rc;
  const long long W = 2LL * H * D + H + D;
  float* g = static_cast<float*>(grads);
  rc = reduce_splits(fpart, g, splits, W, s);
  if (rc != 0) return rc;
  return reduce_splits(fln, g + W, (R + tile - 1) / tile, 2LL * D, s);
}
