// bf16 variant of csrc/fused_mlp.cu on the tensor cores (mma.sync
// m16n8k16, f32 accumulation). Same function, same rounding points and the
// same weight layouts: out = x + W2 . gelu(W1 . LN(x) + b1) + b2 and, with
// LNOUT, z = LN(out) from the rounded out; with h1 not null, the pre-GELU
// h1 rounded to bf16 (GELU itself reads the unrounded value, as the TPU
// kernel's does); with gp not null as well, the rounded g = gelu(h1) in h1's
// place (the very bf16 values of the g tile that W2 multiplies, so out is
// bit-equal to the save-h1 route's) and gelu'(h1) rounded to bf16. Replaces the same TPU kernel
// (ops/fused_mlp.py::_mlp_fwd_kernel on its save-h1 and save-gp routes, the
// training forward) for bf16 storage: the kernel template mirrors
// fused_mlp.cu's, but only the training modes are instantiated; the
// inference forward (_mlp_fwd_lnout_kernel, _mlp_fwd_kernel with no
// residual outputs) takes fused_mlp_wgmma.cu. f32 storage keeps the
// CUDA-core kernel, which never rounds through TF32.
//
// A CTA owns 64 rows and walks H in chunks of 64 hidden units. Shared
// memory holds, in bf16, the normalized rows xn (64 x D), the chunk's W1
// rows (64 x D), its W2 columns (D x 64) and the GELU tile g (64 x 64),
// each with 8 elements of row padding so fragment loads hit 32 banks: 161 KB
// at D = 384. Eight warps: for h1 = xn . W1c^T warp w computes rows
// 16*(w%4).. and hidden columns 32*(w/4)..; for y += g . W2c^T it owns the
// same 16 rows and half of D, a 16 x D/2 f32 accumulator in registers
// (96 floats a thread at D = 384). The epilogue stages the rounded out in
// shared memory, then one warp per row writes out and, with LNOUT, z.
// Bound: tensor-core issue and the per-chunk weight loads from L2 (every CTA
// reads all of W1 and W2); no pipelining of those loads yet.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace vitocm {

constexpr int kMBR = 64;   // rows per CTA
constexpr int kMHC = 64;   // hidden units per chunk
constexpr int kMMT = 256;  // threads (8 warps)
constexpr int kMPH = kMHC + 8;  // pitch of the W2 chunk and g tiles

template <int D>
constexpr size_t mlp_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * kMBR * (D + 8) + D * kMPH + kMBR * kMPH);
}

template <int D, bool LNOUT, bool H1, bool GP>
__global__ void __launch_bounds__(kMMT)
fused_mlp_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ s1,
                     const float* __restrict__ bn1, const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ s2,
                     const float* __restrict__ bn2, __nv_bfloat16* __restrict__ out,
                     __nv_bfloat16* __restrict__ z, __nv_bfloat16* __restrict__ h1,
                     __nv_bfloat16* __restrict__ gp, int R, int H, float eps) {
  constexpr int PD = D + 8;       // pitch of xn and the W1 chunk
  constexpr int CPT = D / 32;     // LN: columns per lane
  constexpr int NT2 = D / 16;     // y: 8-wide column tiles per warp (D/2 columns)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (BR, PD); later out
  __nv_bfloat16* w1s = xn + kMBR * PD;                              // (HC, PD)
  __nv_bfloat16* w2s = w1s + kMHC * PD;                             // (D, PH)
  __nv_bfloat16* gs = w2s + D * kMPH;                               // (BR, PH)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = (warp & 3) * 16;  // this warp's 16 rows
  const int half = warp >> 2;      // which half of the columns
  const long long r0 = (long long)blockIdx.x * kMBR;

  // LayerNorm, one warp per row: xn = round(LN(x) * s1 + bn1)
  for (int r = warp; r < kMBR; r += 8) {
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
      xn[r * PD + col] = __float2bfloat16_rn((v[c] - mu) * rstd * s1[col] + bn1[col]);
    }
  }

  float acc[NT2][4];
#pragma unroll
  for (int j = 0; j < NT2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kMHC) {
    __syncthreads();  // xn written / the previous chunk consumed
    // W1 rows h0.. (contiguous over D) and W2 columns h0.. (64 contiguous
    // per row of W2), 16 bytes a load
    for (int i = tid; i < kMHC * D / 8; i += kMMT) {
      const int j = i / (D / 8), k = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + j * PD + k) =
          *reinterpret_cast<const uint4*>(w1 + (long long)(h0 + j) * D + k);
    }
    for (int i = tid; i < D * kMHC / 8; i += kMMT) {
      const int c = i / (kMHC / 8), j = (i % (kMHC / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + c * kMPH + j) =
          *reinterpret_cast<const uint4*>(w2 + (long long)c * H + h0 + j);
    }
    __syncthreads();

    {  // h1 tile: rows rb.., hidden columns 32*half.. (4 tiles of 8)
      float h[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) h[j][q] = 0.f;
#pragma unroll 4
      for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t a[4];
        ld_a_frag(a, xn + rb * PD + k0, PD, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat16* bp = w1s + (32 * half + 8 * j + g) * PD + k0 + 2 * t;
          mma_bf16_16816(h[j], a, ld_pair(bp), ld_pair(bp + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * half + 8 * j + 2 * t;
        const float bj0 = b1[h0 + col], bj1 = b1[h0 + col + 1];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float u0 = h[j][2 * hr] + bj0, u1 = h[j][2 * hr + 1] + bj1;
          const long long row = r0 + rb + g + 8 * hr;
          float g0, gp0, g1, gp1;
          gelu_pieces(u0, g0, gp0);
          gelu_pieces(u1, g1, gp1);
          const uint32_t gpair = pack_bf16(g0, g1);
          if (H1 && row < R)
            *reinterpret_cast<uint32_t*>(h1 + row * H + h0 + col) = GP ? gpair : pack_bf16(u0, u1);
          if (GP && row < R)
            *reinterpret_cast<uint32_t*>(gp + row * H + h0 + col) = pack_bf16(gp0, gp1);
          *reinterpret_cast<uint32_t*>(gs + (rb + g + 8 * hr) * kMPH + col) = gpair;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int k0 = 0; k0 < kMHC; k0 += 16) {
      uint32_t a[4];
      ld_a_frag(a, gs + rb * kMPH + k0, kMPH, g, t);
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        const __nv_bfloat16* bp = w2s + ((D / 2) * half + 8 * j + g) * kMPH + k0 + 2 * t;
        mma_bf16_16816(acc[j], a, ld_pair(bp), ld_pair(bp + 8));
      }
    }
  }

  __syncthreads();  // every warp is done reading xn: reuse it for out
#pragma unroll
  for (int j = 0; j < NT2; ++j) {
    const int col = (D / 2) * half + 8 * j + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rb + g + 8 * hr;
      const long long row = r0 + r;
      float x0 = 0.f, x1 = 0.f;
      if (row < R) {
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + row * D + col);
        x0 = __low2float(xv);
        x1 = __high2float(xv);
      }
      *reinterpret_cast<uint32_t*>(xn + r * PD + col) =
          pack_bf16(x0 + (acc[j][2 * hr] + b2[col]), x1 + (acc[j][2 * hr + 1] + b2[col + 1]));
    }
  }
  __syncthreads();

  for (int r = warp; r < kMBR; r += 8) {
    const long long row = r0 + r;
    if (row >= R) break;  // rows only grow with r
    float o[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const __nv_bfloat16 v = xn[r * PD + lane + 32 * c];
      out[row * D + lane + 32 * c] = v;
      o[c] = __bfloat162float(v);
    }
    if (LNOUT) {
      float mu, rstd;
      warp_ln_stats<D>(o, eps, mu, rstd);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = lane + 32 * c;
        z[row * D + col] = __float2bfloat16_rn((o[c] - mu) * rstd * s2[col] + bn2[col]);
      }
    }
  }
}

template <int D>
int launch_mlp_mma(const void* x, const float* s1, const float* bn1, const void* w1,
                   const float* b1, const void* w2, const float* b2, void* out, void* h1,
                   void* gp, int R, int H, float eps, cudaStream_t stream) {
  const size_t smem = mlp_mma_smem_bytes<D>();
  // the training forward only: h1 saved, or g and gp with gp not null
  auto kern = gp == nullptr ? fused_mlp_mma_kernel<D, false, true, false>
                            : fused_mlp_mma_kernel<D, false, true, true>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int grid = (R + kMBR - 1) / kMBR;
  using B = __nv_bfloat16;
  kern<<<grid, kMMT, smem, stream>>>(static_cast<const B*>(x), s1, bn1,
                                     static_cast<const B*>(w1), b1, static_cast<const B*>(w2),
                                     b2, nullptr, nullptr, static_cast<B*>(out), nullptr,
                                     static_cast<B*>(h1), static_cast<B*>(gp), R, H, eps);
  return (int)cudaGetLastError();
}

template int launch_mlp_mma<384>(const void*, const float*, const float*, const void*,
                                 const float*, const void*, const float*, void*, void*, void*,
                                 int, int, float, cudaStream_t);
template int launch_mlp_mma<192>(const void*, const float*, const float*, const void*,
                                 const float*, const void*, const float*, void*, void*, void*,
                                 int, int, float, cudaStream_t);

}  // namespace vitocm
