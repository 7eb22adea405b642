// bf16 variant of csrc/fused_mlp_bwd.cu on the tensor cores (mma.sync
// m16n8k16, f32 accumulation): the same split into a dx kernel and a
// weight-gradient kernel (reduced by fused_mlp_bwd.cu), with the TPU
// kernel's rounding points (ops/fused_mlp.py::_mlp_bwd_kernel): xn, g and
// dh1 rounded to bf16 before their products, dx rounded once, every
// parameter gradient in f32. With GP (the SAVE_GP route) h1 holds the
// forward's bf16 g = gelu(h1) and gp its bf16 gelu'(h1): the dx kernel reads
// gp where it computed gelu'(h1), the weight kernel copies g into the tile it
// computed g into, and neither computes an erf or an exp.
//
// dx kernel: a CTA owns 64 rows and walks H in chunks of 64, eight warps.
// Shared memory holds do (64 x D), the chunk's W1 rows (64 x D) and W2
// columns (D x 64) and the dh1 tile, 161 KB at D = 384. Per chunk warp w
// computes dg for rows 16*(w%4).. and hidden columns 32*(w/4).. (B
// fragments of W2 through ldmatrix.trans), dh1 = bf16(dg * gelu'(h1)), and
// dxn += dh1 W1 into a 16 x D/2 f32 accumulator (96 floats a thread at
// D = 384). The epilogue stages dxn in shared memory for the LN backward,
// one warp per row, which also writes xn = LN(x) for the weight kernel,
// and the tile's partial ds and dbb, one thread per column.
//
// Weight kernel: a CTA owns (row split, 32 hidden units). W2's 32 columns
// stay in shared memory; per 64-row tile it stages xn and do,
// computes dg, g and dh1 for its chunk, then dW1c += dh1^T xn (warp w: 16
// hidden rows x D/4 columns) and dW2c += do^T g (warp w: D/128 blocks of
// 16 columns x 32 hidden), both transposed operands through ldmatrix.trans.
// 138 KB of shared memory on both routes (the SAVE_GP route stages the g it
// reads in the same tile). Bound: tensor-core issue and the per-tile
// staging, not overlapped yet; every CTA re-reads its split's x and do.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace vitocm {

constexpr int kXR = 64;   // rows per tile
constexpr int kXH = 64;   // hidden units per chunk, dx kernel
constexpr int kYH = 32;   // hidden units per chunk, weight kernel
constexpr int kXT = 256;  // threads (8 warps)
constexpr int kXP = kXH + 8;  // pitch of the dx kernel's W2 chunk and dh1 tile
constexpr int kYP = kYH + 8;  // pitch of the weight kernel's W2 chunk, dh1 and g tiles

__device__ __forceinline__ float2 ld_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int D>
constexpr size_t mlp_bwd_dx_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * kXR * (D + 8) + D * kXP + kXR * kXP);
}

template <int D>
constexpr size_t mlp_bwd_w_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * kXR * (D + 8) + D * kYP + 2 * kXR * kYP);
}

// rows r0 .. r0+63 of an (R, D) bf16 matrix into shared memory (pitch D+8),
// zeros from row `end` on (a tile holds at least one row below `end`; the
// loads read a clamped row, so no branch holds them back)
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long r0, long long end) {
  for (int i = threadIdx.x; i < kXR * D / 8; i += kXT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(src + min(r0 + r, end - 1) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) =
        r0 + r < end ? val : make_uint4(0, 0, 0, 0);
  }
}

template <int D, bool GP>
__global__ void __launch_bounds__(kXT)
mlp_bwd_dx_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dout,
                      const __nv_bfloat16* __restrict__ h1, const __nv_bfloat16* __restrict__ gpp,
                      const float* __restrict__ s1,
                      const float* __restrict__ bn1, const __nv_bfloat16* __restrict__ w1,
                      const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ dx,
                      __nv_bfloat16* __restrict__ xn_out, float* __restrict__ ln_part, int R,
                      int H, float eps) {
  constexpr int PD = D + 8, CPT = D / 32, NT2 = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (XR, PD)
  __nv_bfloat16* w1s = dos + kXR * PD;                              // (XH, PD) [j][c]
  __nv_bfloat16* w2s = w1s + kXH * PD;                              // (D, XP) [c][j]
  __nv_bfloat16* dh1s = w2s + D * kXP;                              // (XR, XP)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = (warp & 3) * 16, half = warp >> 2;
  const long long r0 = (long long)blockIdx.x * kXR;
  stage_tile<D>(dos, dout, r0, R);

  float acc[NT2][4];  // dxn: rows rb + g (+8), columns (D/2)*half + 8j + 2t (+1)
#pragma unroll
  for (int j = 0; j < NT2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kXH) {
    __syncthreads();  // do staged / the previous chunk consumed
    for (int i = tid; i < kXH * D / 8; i += kXT) {
      const int j = i / (D / 8), k = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + j * PD + k) =
          *reinterpret_cast<const uint4*>(w1 + (long long)(h0 + j) * D + k);
    }
    for (int i = tid; i < D * kXH / 8; i += kXT) {
      const int c = i / (kXH / 8), j = (i % (kXH / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + c * kXP + j) =
          *reinterpret_cast<const uint4*>(w2 + (long long)c * H + h0 + j);
    }
    __syncthreads();

    {  // dg tile: rows rb.., hidden columns 32*half.. (4 tiles of 8)
      float dg[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dg[j][e] = 0.f;
#pragma unroll 4
      for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t a[4], b[4];
        ld_a_frag(a, dos + rb * PD + k0, PD, g, t);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          ld_b_frag2(b, w2s, kXP, k0, 32 * half + 8 * j, lane);
          mma_bf16_16816(dg[j], a, b[0], b[1]);
          mma_bf16_16816(dg[j + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * half + 8 * j + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = rb + g + 8 * hr;
          float2 hv = make_float2(0.f, 0.f);
          if (r0 + r < R) hv = ld_bf16x2((GP ? gpp : h1) + (r0 + r) * H + h0 + col);
          float g0, gp0 = hv.x, g1, gp1 = hv.y;
          if (!GP) {
            gelu_pieces(hv.x, g0, gp0);
            gelu_pieces(hv.y, g1, gp1);
          }
          *reinterpret_cast<uint32_t*>(dh1s + r * kXP + col) =
              pack_bf16(dg[j][2 * hr] * gp0, dg[j][2 * hr + 1] * gp1);
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int k0 = 0; k0 < kXH; k0 += 16) {
      uint32_t a[4], b[4];
      ld_a_frag(a, dh1s + rb * kXP + k0, kXP, g, t);
#pragma unroll
      for (int j = 0; j < NT2; j += 2) {
        ld_b_frag2(b, w1s, PD, k0, (D / 2) * half + 8 * j, lane);
        mma_bf16_16816(acc[j], a, b[0], b[1]);
        mma_bf16_16816(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
  __syncthreads();  // w1s/w2s take dxn (f32), dh1s the row statistics

  float* dxs = reinterpret_cast<float*>(w1s);  // (XR, D) f32
  float* mu_s = reinterpret_cast<float*>(dh1s);
  float* rstd_s = mu_s + kXR;
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

  // LN backward, one warp per row
  for (int r = warp; r < kXR; r += 8) {
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
      const float dxh = dxs[r * D + col] * s1[col];
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
        const float dxh = dxs[r * D + col] * s1[col];
        dx[row * D + col] = __float2bfloat16_rn(__bfloat162float(dos[r * PD + col]) +
                                                rstd * (dxh - m1 - v[c] * m2));
        xn_out[row * D + col] = __float2bfloat16_rn(v[c] * s1[col] + bn1[col]);
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < D; c += kXT) {
    float sd = 0.f, sb = 0.f;
    for (int r = 0; r < kXR; ++r) {
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

template <int D, bool GP>
__global__ void __launch_bounds__(kXT)
mlp_bwd_w_mma_kernel(const __nv_bfloat16* __restrict__ xn_in,
                     const __nv_bfloat16* __restrict__ dout, const __nv_bfloat16* __restrict__ h1,
                     const __nv_bfloat16* __restrict__ gpp, const __nv_bfloat16* __restrict__ w2, float* __restrict__ part, int R, int H,
                     int rows_per_split) {
  constexpr int PD = D + 8, NT1 = D / 32, MT2 = D / 16;
  constexpr int NC2 = (D + kXT - 1) / kXT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (XR, PD)
  __nv_bfloat16* dos = xn + kXR * PD;                               // (XR, PD)
  __nv_bfloat16* w2s = dos + kXR * PD;                              // (D, YP) [c][j]
  __nv_bfloat16* dh1s = w2s + D * kYP;                              // (XR, YP)
  __nv_bfloat16* gs = dh1s + kXR * kYP;                             // (XR, YP)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = blockIdx.y * kYH;
  const long long rs0 = (long long)blockIdx.x * rows_per_split;
  const long long rs1 = min((long long)R, rs0 + rows_per_split);
  const long long W = 2LL * H * D + H + D;
  part += blockIdx.x * W;

  for (int i = tid; i < D * kYH / 8; i += kXT) {
    const int c = i / (kYH / 8), j = (i % (kYH / 8)) * 8;
    *reinterpret_cast<uint4*>(w2s + c * kYP + j) =
        *reinterpret_cast<const uint4*>(w2 + (long long)c * H + h0 + j);
  }
  // dW1c: hidden rows 16*(warp%2) + g (+8), columns (warp/2)*(D/4) + 8j + 2t (+1)
  float a1[NT1][4];
  // dW2c: columns 16*(warp + 8m) + g (+8) of D, hidden 8n + 2t (+1)
  float a2[3][4][4];
#pragma unroll
  for (int j = 0; j < NT1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a1[j][e] = 0.f;
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) a2[m][n][e] = 0.f;
  float db1 = 0.f, db2[NC2];
#pragma unroll
  for (int k = 0; k < NC2; ++k) db2[k] = 0.f;

  for (long long t0 = rs0; t0 < rs1; t0 += kXR) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<D>(xn, xn_in, t0, rs1);
    stage_tile<D>(dos, dout, t0, rs1);
    __syncthreads();

    {  // dg: rows 16*(warp%4).., hidden columns 16*(warp/4).. (2 tiles of 8)
      const int rb = (warp & 3) * 16, cb = (warp >> 2) * 16;
      float dg[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dg[j][e] = 0.f;
#pragma unroll 4
      for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t a[4], b[4];
        ld_a_frag(a, dos + rb * PD + k0, PD, g, t);
        ld_b_frag2(b, w2s, kYP, k0, cb, lane);
        mma_bf16_16816(dg[0], a, b[0], b[1]);
        mma_bf16_16816(dg[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = cb + 8 * j + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = rb + g + 8 * hr;
          float2 hv = make_float2(0.f, 0.f), pv = hv;
          if (t0 + r < rs1) {
            hv = ld_bf16x2(h1 + (t0 + r) * H + h0 + col);
            if (GP) pv = ld_bf16x2(gpp + (t0 + r) * H + h0 + col);
          }
          float g0 = hv.x, gp0 = pv.x, g1 = hv.y, gp1 = pv.y;  // GP: g and gp as saved
          if (!GP) {
            gelu_pieces(hv.x, g0, gp0);
            gelu_pieces(hv.y, g1, gp1);
          }
          *reinterpret_cast<uint32_t*>(gs + r * kYP + col) = pack_bf16(g0, g1);
          *reinterpret_cast<uint32_t*>(dh1s + r * kYP + col) =
              pack_bf16(dg[j][2 * hr] * gp0, dg[j][2 * hr + 1] * gp1);
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int k0 = 0; k0 < kXR; k0 += 16) {
      uint32_t a[4], b[4];
      ld_a_frag_t(a, dh1s, kYP, k0, 16 * (warp & 1), lane);
#pragma unroll
      for (int j = 0; j < NT1; j += 2) {
        ld_b_frag2(b, xn, PD, k0, (warp >> 1) * (D / 4) + 8 * j, lane);
        mma_bf16_16816(a1[j], a, b[0], b[1]);
        mma_bf16_16816(a1[j + 1], a, b[2], b[3]);
      }
      uint32_t bg[4], bg2[4];
      ld_b_frag2(bg, gs, kYP, k0, 0, lane);
      ld_b_frag2(bg2, gs, kYP, k0, 16, lane);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int mt = warp + 8 * m;
        if (mt < MT2) {
          ld_a_frag_t(a, dos, PD, k0, 16 * mt, lane);
          mma_bf16_16816(a2[m][0], a, bg[0], bg[1]);
          mma_bf16_16816(a2[m][1], a, bg[2], bg[3]);
          mma_bf16_16816(a2[m][2], a, bg2[0], bg2[1]);
          mma_bf16_16816(a2[m][3], a, bg2[2], bg2[3]);
        }
      }
    }
    if (tid < kYH)
      for (int r = 0; r < kXR; ++r) db1 += __bfloat162float(dh1s[r * kYP + tid]);
    if (blockIdx.y == 0) {
#pragma unroll
      for (int k = 0; k < NC2; ++k) {
        const int c = tid + kXT * k;
        if (c < D)
          for (int r = 0; r < kXR; ++r) db2[k] += __bfloat162float(dos[r * PD + c]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NT1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hj = h0 + 16 * (warp & 1) + g + 8 * (e >> 1);
      const int c = (warp >> 1) * (D / 4) + 8 * j + 2 * t + (e & 1);
      part[(long long)hj * D + c] = a1[j][e];
    }
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int mt = warp + 8 * m;
    if (mt >= MT2) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * mt + g + 8 * (e >> 1);
        const int hj = h0 + 8 * n + 2 * t + (e & 1);
        part[(long long)H * D + (long long)c * H + hj] = a2[m][n][e];
      }
  }
  if (tid < kYH) part[2LL * H * D + h0 + tid] = db1;
  if (blockIdx.y == 0) {
#pragma unroll
    for (int k = 0; k < NC2; ++k) {
      const int c = tid + kXT * k;
      if (c < D) part[2LL * H * D + H + c] = db2[k];
    }
  }
}

template <int D, bool GP>
int launch_mlp_bwd_mma(const void* x, const void* dout, const void* h1, const void* gp,
                       const float* s1, const float* bn1, const void* w1, const void* w2,
                       void* dx, void* xn, float* ln_part, float* part, int R, int H, int splits,
                       int rps, float eps, cudaStream_t stream) {
  using T = __nv_bfloat16;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  const size_t s_dx = mlp_bwd_dx_mma_smem_bytes<D>(), s_w = mlp_bwd_w_mma_smem_bytes<D>();
  cudaFuncSetAttribute(mlp_bwd_dx_mma_kernel<D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s_dx);
  cudaFuncSetAttribute(mlp_bwd_w_mma_kernel<D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s_w);
  mlp_bwd_dx_mma_kernel<D, GP><<<(R + kXR - 1) / kXR, kXT, s_dx, stream>>>(
      c(x), c(dout), c(h1), c(gp), s1, bn1, c(w1), c(w2), static_cast<T*>(dx),
      static_cast<T*>(xn), ln_part, R, H, eps);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  mlp_bwd_w_mma_kernel<D, GP><<<dim3(splits, H / kYH), kXT, s_w, stream>>>(
      c(xn), c(dout), c(h1), c(gp), c(w2), part, R, H, rps);
  return (int)cudaGetLastError();
}

#define VITOCM_MLP_BWD_MMA(D, GP)                                                             \
  template int launch_mlp_bwd_mma<D, GP>(const void*, const void*, const void*, const void*,   \
                                         const float*, const float*, const void*, const void*, \
                                         void*, void*, float*, float*, int, int, int, int,     \
                                         float, cudaStream_t);
VITOCM_MLP_BWD_MMA(384, false)
VITOCM_MLP_BWD_MMA(384, true)
VITOCM_MLP_BWD_MMA(192, false)
VITOCM_MLP_BWD_MMA(192, true)
#undef VITOCM_MLP_BWD_MMA

}  // namespace vitocm
