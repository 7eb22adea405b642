// Fused pre-norm MLP block, inference forward, bf16 storage, on Hopper's
// warpgroup tensor cores: wgmma fed by TMA through an mbarrier ring.
//   out = x + W2 . gelu(W1 . LN(x; s1, bn1) + b1) + b2
//   z   = LN(out; s2, bn2)                      (LNOUT only)
// Replaces vit_ocm_wmsegmentation_tpu/ops/fused_mlp.py::_mlp_fwd_lnout_kernel
// (LNOUT) and ::_mlp_fwd_kernel with no residual outputs, for bf16; the
// training forward (h1 and gp residuals) stays on fused_mlp_mma.cu. Weights
// in nn.Linear's layout: w1 (H, D), w2 (D, H), bf16; LN scales and biases
// f32. D in {192, 384}, H a multiple of 32.
//
// Rounding points of fused_mlp_mma.cu and of the twin (ops/fused_mlp.py::
// _mlp_plain): xn rounded to bf16, h1 in f32 and GELU by erff, g rounded to
// bf16, f32 accumulation, out = round(x + (acc + b2)), z = LN of the rounded
// out. Only the order of the f32 sums inside each product differs.
//
// What bounds it on the H100: at the mosaic's 112945 x 384, H 1536, 267
// GFLOP (0.27 ms at 989 TFLOP/s) against 0.26 GB of HBM traffic. The
// mma.sync kernel it replaces copied each weight chunk with all threads
// between two __syncthreads (tensor cores idle), once per 64 rows. Here a
// CTA owns 128 rows (two consumer warpgroups of 64) and a producer keeps the
// weights in flight with TMA while the tensor cores work: chunks of 32
// hidden units, W1's rows (128-byte swizzle, 24 KB at D = 384) and W2's
// columns (64-byte swizzle, 24 KB) in rings of 2 stages each, guarded by
// "full" mbarriers (the bytes arrived) and "empty" ones (all 8 consumer warps
// done; a W1 stage frees as soon as h is computed). Each consumer warpgroup
// normalizes its 64 rows into shared memory (xn, 128-byte swizzle, 48 KB),
// then per chunk computes h = xn . W1c^T with wgmma (m64n32, both operands
// from shared memory), bias and GELU on the accumulators, and y += g . W2c^T
// with g rounded and packed as the register A operand (m64n192, once or
// twice). The y accumulator is 64 x D f32 in registers (192 a thread at D =
// 384), so the consumers raise their register limit from the launch's 168
// to 240 with setmaxnreg, out of the 144 a thread the producer warpgroup
// gives back by dropping to 24 (a CTA's warps trade only the registers the
// CTA was launched with, so the producer is a whole warpgroup, of which one
// lane issues the copies). Shared memory 193 KB at D = 384: one CTA an SM.
// The epilogue stages the rounded out in the warpgroup's xn space, then one
// warp per row writes out and, with LNOUT, z. Within a warpgroup the h
// product, the GELU and the y product run one after another; the two
// warpgroups overlap each other. On an H100 these were slower: sharing each
// weight chunk between two CTAs of a cluster by TMA multicast, turn-taking
// between the warpgroups, and issuing the next chunk's h before this chunk's
// GELU (which spills at 240 registers).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kFR = 128;        // rows per CTA: two consumer warpgroups
constexpr int kFC = 32;         // hidden units per chunk
constexpr int kFThreads = 384;  // two consumer warpgroups + the producer warpgroup
constexpr int kFS1 = 2, kFS2 = 2;  // stages of the W1 and of the W2 ring

template <int D>
struct MlpWgmma {
  static constexpr int CH = D / 64;                    // 64-column chunks of xn and W1
  static constexpr int HALVES = D / 192;               // n = 192 products of y
  static constexpr int XN_BYTES = CH * kFR * 128;      // chunk c: 128 rows at c * kFR * 128
  static constexpr int W1_BYTES = CH * kFC * 128;      // chunk c: 32 rows at c * kFC * 128
  static constexpr int W2_BYTES = D * kFC * 2;         // D rows of 64 bytes
  static constexpr size_t SMEM =
      1024 + XN_BYTES + kFS1 * W1_BYTES + kFS2 * W2_BYTES + 8 * 2 * (kFS1 + kFS2);
};

// byte offset of xn (r, col) in a warpgroup's swizzled xn tile: column
// chunk col / 64 at chunk * kFR * 128, 128-byte rows, 16-byte groups XOR r % 8
__device__ __forceinline__ int xn_offset(int r, int col) {
  return (col >> 6) * kFR * 128 + r * 128 + ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// h = xn . W1c^T of one chunk, issued (not waited for): 64 rows x 32 units
template <int D>
__device__ __forceinline__ void issue_h(float (&h)[16], const unsigned char* xw,
                                        const unsigned char* w1s) {
#pragma unroll
  for (int i = 0; i < 16; ++i) h[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int j = kk >> 2, off = (kk & 3) * 32;
    wgmma_ss_m64n32k16(h, desc_k128(xw + j * kFR * 128 + off), desc_k128(w1s + j * kFC * 128 + off));
  }
  wgmma_commit();
}

// g = round(gelu(h + b1)) of hidden units h0 .., packed as the A operand of
// the two k-steps of y += g . W2c^T; h[4i + e]: row g + 8 (e >> 1), unit h0
// + 8i + 2 t4 + (e & 1)
__device__ __forceinline__ void gelu_pack(float (&h)[16], const float* __restrict__ b1, int h0,
                                          int t4, uint32_t (&ga)[2][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = h0 + 8 * i + 2 * t4;
    const float bj0 = b1[col], bj1 = b1[col + 1];
    float gp;
    gelu_pieces(h[4 * i] + bj0, h[4 * i], gp);
    gelu_pieces(h[4 * i + 1] + bj1, h[4 * i + 1], gp);
    gelu_pieces(h[4 * i + 2] + bj0, h[4 * i + 2], gp);
    gelu_pieces(h[4 * i + 3] + bj1, h[4 * i + 3], gp);
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    ga[kk][0] = pack_bf16(h[8 * kk], h[8 * kk + 1]);
    ga[kk][1] = pack_bf16(h[8 * kk + 2], h[8 * kk + 3]);
    ga[kk][2] = pack_bf16(h[8 * kk + 4], h[8 * kk + 5]);
    ga[kk][3] = pack_bf16(h[8 * kk + 6], h[8 * kk + 7]);
  }
}

// y += g . W2c^T, issued (not waited for)
template <int D>
__device__ __forceinline__ void issue_y(float (&y)[D / 192][96], const uint32_t (&ga)[2][4],
                                        const unsigned char* w2s) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int hf = 0; hf < D / 192; ++hf)
      wgmma_rs_m64n192k16<0>(y[hf], ga[kk], desc_k64(w2s + hf * 192 * kFC * 2 + kk * 32));
  wgmma_commit();
}

template <int D, bool LNOUT>
__global__ void __launch_bounds__(kFThreads, 1)
fused_mlp_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                       const __grid_constant__ CUtensorMap w2_map,
                       const __nv_bfloat16* __restrict__ x, const float* __restrict__ s1,
                       const float* __restrict__ bn1, const float* __restrict__ b1,
                       const float* __restrict__ b2, const float* __restrict__ s2,
                       const float* __restrict__ bn2, __nv_bfloat16* __restrict__ out,
                       __nv_bfloat16* __restrict__ z, int R, int H, float eps) {
  using C = MlpWgmma<D>;
  constexpr int CPT = D / 32;  // LN: columns per lane
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* xs = align1024(smem_raw);
  unsigned char* ring1 = xs + C::XN_BYTES;          // W1 chunks
  unsigned char* ring2 = ring1 + kFS1 * C::W1_BYTES;  // W2 chunks
  uint64_t* full1 = reinterpret_cast<uint64_t*>(ring2 + kFS2 * C::W2_BYTES);
  uint64_t* empty1 = full1 + kFS1;
  uint64_t* full2 = empty1 + kFS1;
  uint64_t* empty2 = full2 + kFS2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = H / kFC;
  if (tid == 0) {
    for (int s = 0; s < kFS1; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], 8);  // every consumer warp
    }
    for (int s = 0; s < kFS2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one lane issues every copy
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int a = c % kFS1, b = c % kFS2;
        mbar_wait(&empty1[a], ((c / kFS1) & 1) ^ 1);
        mbar_expect_tx(&full1[a], C::W1_BYTES);
        for (int j = 0; j < C::CH; ++j)
          tma_load_2d(ring1 + a * C::W1_BYTES + j * kFC * 128, &w1_map, &full1[a], 64 * j,
                      c * kFC);
        mbar_wait(&empty2[b], ((c / kFS2) & 1) ^ 1);
        mbar_expect_tx(&full2[b], C::W2_BYTES);
        for (int j = 0; j < C::HALVES; ++j)
          tma_load_2d(ring2 + b * C::W2_BYTES + j * 192 * kFC * 2, &w2_map, &full2[b], c * kFC,
                      192 * j);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    // consumer warpgroup wg: rows rb ..; warp wl of it normalizes rows 16 wl
    // .. 16 wl + 15 and holds accumulator rows 16 wl + g (+ 8). A warpgroup
    // with no row below R only releases the chunks.
    const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
    const long long rb = (long long)blockIdx.x * kFR + 64 * wg;
    unsigned char* xw = xs + wg * 64 * 128;
    auto w1s = [&](int c) { return ring1 + (c % kFS1) * C::W1_BYTES; };
    auto w2s = [&](int c) { return ring2 + (c % kFS2) * C::W2_BYTES; };
    auto await1 = [&](int c) { mbar_wait(&full1[c % kFS1], (c / kFS1) & 1); };
    auto await2 = [&](int c) { mbar_wait(&full2[c % kFS2], (c / kFS2) & 1); };
    auto release1 = [&](int c) {
      if (lane == 0) mbar_arrive(&empty1[c % kFS1]);
    };
    auto release2 = [&](int c) {
      if (lane == 0) mbar_arrive(&empty2[c % kFS2]);
    };
    if (rb >= R) {
      for (int c = 0; c < chunks; ++c) {
        await1(c);
        release1(c);
        await2(c);
        release2(c);
      }
      return;
    }

    // xn = round(LN(x) * s1 + bn1), one row at a time across the warp
    for (int i = 0; i < 16; ++i) {
      const int r = 16 * wl + i;
      const long long row = rb + r;
      float v[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        v[c] = row < R ? __bfloat162float(x[row * D + lane + 32 * c]) : 0.f;
      float mu, rstd;
      warp_ln_stats<D>(v, eps, mu, rstd);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = lane + 32 * c;
        *reinterpret_cast<__nv_bfloat16*>(xw + xn_offset(r, col)) =
            __float2bfloat16_rn((v[c] - mu) * rstd * s1[col] + bn1[col]);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);

    float y[C::HALVES][96];
#pragma unroll
    for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
      for (int i = 0; i < 96; ++i) y[hf][i] = 0.f;
    uint32_t ga[2][4];
    for (int c = 0; c < chunks; ++c) {
      float h[16];
      await1(c);
      issue_h<D>(h, xw, w1s(c));
      wgmma_wait<0>();
      fence_regs(h);
      release1(c);
      gelu_pack(h, b1, c * kFC, t4, ga);
      await2(c);
      issue_y<D>(y, ga, w2s(c));
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < C::HALVES; ++hf) fence_regs(y[hf]);
      release2(c);
    }

    // out = round(x + (y + b2)) into this warpgroup's xn space (every
    // product that read xn is complete once all four warps are here)
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
      for (int i = 0; i < 24; ++i) {
        const int col = 192 * hf + 8 * i + 2 * t4;
        const float bc0 = b2[col], bc1 = b2[col + 1];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 16 * wl + g + 8 * e;
          const long long row = rb + r;
          float x0 = 0.f, x1 = 0.f;
          if (row < R) {
            const __nv_bfloat162 xv =
                *reinterpret_cast<const __nv_bfloat162*>(x + row * D + col);
            x0 = __low2float(xv);
            x1 = __high2float(xv);
          }
          *reinterpret_cast<uint32_t*>(xw + xn_offset(r, col)) =
              pack_bf16(x0 + (y[hf][4 * i + 2 * e] + bc0), x1 + (y[hf][4 * i + 2 * e + 1] + bc1));
        }
      }
    named_barrier(1 + wg, 128);

    for (int i = 0; i < 16; ++i) {
      const int r = 16 * wl + i;
      const long long row = rb + r;
      if (row >= R) break;  // rows only grow with i
      float o[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = lane + 32 * c;
        const __nv_bfloat16 v = *reinterpret_cast<const __nv_bfloat16*>(xw + xn_offset(r, col));
        out[row * D + col] = v;
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
}

template <int D, bool LNOUT>
static int launch_mlp_wgmma(const void* x, const float* s1, const float* bn1, const void* w1,
                            const float* b1, const void* w2, const float* b2, const float* s2,
                            const float* bn2, void* out, void* z, int R, int H, float eps,
                            cudaStream_t stream) {
  using C = MlpWgmma<D>;
  CUtensorMap m1, m2;
  const uint64_t d1[2] = {(uint64_t)D, (uint64_t)H}, st1[1] = {(uint64_t)D * 2};
  const uint32_t box1[2] = {64, kFC};
  const uint64_t d2[2] = {(uint64_t)H, (uint64_t)D}, st2[1] = {(uint64_t)H * 2};
  const uint32_t box2[2] = {kFC, 192};
  if (!make_tmap_bf16(&m1, w1, 2, d1, st1, box1, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap_bf16(&m2, w2, 2, d2, st2, box2, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  auto kern = fused_mlp_wgmma_kernel<D, LNOUT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  using B = __nv_bfloat16;
  kern<<<(R + kFR - 1) / kFR, kFThreads, C::SMEM, stream>>>(
      m1, m2, static_cast<const B*>(x), s1, bn1, b1, b2, s2, bn2, static_cast<B*>(out),
      static_cast<B*>(z), R, H, eps);
  return (int)cudaGetLastError();
}

template <int D>
static int dispatch_mlp_wgmma(int lnout, const void* x, const float* s1, const float* bn1,
                              const void* w1, const float* b1, const void* w2, const float* b2,
                              const float* s2, const float* bn2, void* out, void* z, int R, int H,
                              float eps, cudaStream_t s) {
  if (lnout)
    return launch_mlp_wgmma<D, true>(x, s1, bn1, w1, b1, w2, b2, s2, bn2, out, z, R, H, eps, s);
  return launch_mlp_wgmma<D, false>(x, s1, bn1, w1, b1, w2, b2, s2, bn2, out, z, R, H, eps, s);
}

}  // namespace vitocm

// Inference forward, bf16: x, out, z (R, D); w1 (H, D); w2 (D, H), all
// 16-byte aligned; s1, bn1, s2, bn2, b2 (D) and b1 (H) in f32. lnout = 0
// ignores s2, bn2 and z. D in {192, 384}, H a multiple of 32. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int vitocm_fused_mlp_wgmma(int lnout, const void* x, const void* s1, const void* bn1,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* s2, const void* bn2, void* out,
                                      void* z, int R, int D, int H, float eps, void* stream) {
  using namespace vitocm;
  if (R < 1 || H < kFC || H % kFC != 0 || (lnout && z == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (D == 384)
    return dispatch_mlp_wgmma<384>(lnout, x, f(s1), f(bn1), w1, f(b1), w2, f(b2), f(s2), f(bn2),
                                   out, z, R, H, eps, s);
  if (D == 192)
    return dispatch_mlp_wgmma<192>(lnout, x, f(s1), f(bn1), w1, f(b1), w2, f(b2), f(s2), f(bn2),
                                   out, z, R, H, eps, s);
  return (int)cudaErrorInvalidValue;
}
