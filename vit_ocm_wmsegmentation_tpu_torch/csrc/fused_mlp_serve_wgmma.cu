// Fused pre-norm MLP block, inference forward, bf16 storage, on Hopper's
// warpgroup tensor cores, with the hidden layer kept on chip:
//   out = x + W2 . gelu(W1 . LN(x; s1, bn1) + b1) + b2
//   z   = LN(out; s2, bn2)                      (LNOUT only)
// Replaces vit_ocm_wmsegmentation_tpu/ops/fused_mlp.py::_mlp_fwd_lnout_kernel
// (LNOUT) and ::_mlp_fwd_kernel with no residual outputs, for bf16; the
// training routes (want="h1", "gp") stay in fused_mlp_wgmma.cu. Weights in
// nn.Linear's layout: w1 (H, D), w2 (D, H), bf16; LN scales and biases f32.
// D in {192, 384}, H a multiple of 32.
//
// Rounding points of the twin (ops/fused_mlp.py::_mlp_plain), and the bits
// of fused_mlp_wgmma.cu's inference instances, which this kernel took over:
// xn rounded to bf16 (common.cuh::warp_ln_stats), h = xn . W1c^T in f32 over
// D in 16-wide steps from 0, GELU by erff (common.cuh::gelu_pieces), g
// rounded to bf16, y += g . W2c^T chunk after chunk in 16-wide steps, out =
// round(x + (y + b2)), z = LN of the rounded out.
//
// What bounds it on the H100: at the mosaic's 112945 x 384, H 1536, 267
// GFLOP (0.27 ms at 989 TFLOP/s) against 0.26 GB of HBM traffic; every
// 128-row tile also reads all of W1 and W2 (2.36 MB) from L2, 2.08 GB a
// call. The kernel this took over (fused_mlp_wgmma.cu's inference
// instances) took 0.91 ms on an H100 at 700 W; throwaway variants of it,
// timed in one call: GELU replaced by the bare rounding 0.65, no y product
// 0.45, no h product 0.79, none of the three still 0.45, rings of 1 stage
// 1.05. So each warpgroup's chain (h product, wait, bias + GELU + rounding,
// y product, wait) sets the pace, above a floor of 0.45 ms that holds the
// weight stream, the LayerNorm and the epilogue.
//
// Design: the chain as it was, and a lower floor. A CTA owns 128 rows (two
// consumer warpgroups of 64); a producer warpgroup keeps the weights in
// flight with TMA, one lane streaming W1 and another W2, so that neither
// stream waits on the other's ring: chunks of 32 hidden units, W1's rows
// (128-byte swizzle, 24 KB at D = 384) in a ring of kS1 stages and W2's
// columns (64-byte swizzle, 24 KB) in one of kS2, "full" and "empty"
// mbarriers. Each consumer holds the 64 x D f32 accumulator of y (192
// registers a thread at D = 384; setmaxnreg 240, the producer 24) and, per
// chunk, h = xn . W1c^T (m64n32, both operands from shared memory), bias,
// GELU and rounding on the accumulators, and y += g . W2c^T with g packed as
// the register A operand (m64n192). Each warp normalizes its 16 rows into xn
// (128-byte swizzle) kLnRows rows at a time, their loads issued together:
// one row at a time, the kernel this took over waited on memory sixteen
// times a tile before its first product. Warpgroup 1 starts its first h
// product once warpgroup 0 has made its first g, so that the two chains run
// out of step and one's GELU meets the other's products rather than its
// GELU. The epilogue stages the rounded out in xn and writes out and z
// kOutRows rows a warp at a time, the rows' shuffles interleaved. Shared
// memory 217 KB at D = 384: one CTA an SM.
//
// Lost on the H100 (one call each; every variant bit-equal to the kernel it
// took over), 112945 rows, LN-out, against its 0.97-0.99 ms in the same call:
//   * a g warpgroup making the GELU of every chunk for the CTA's 128 rows
//     into a shared-memory ring while two y warpgroups run the y products,
//     a persistent grid, weights multicast to 2-CTA clusters: 1.9-4.5 ms.
//     Two 64 x 384 accumulators leave the third warpgroup ~40 registers; at
//     208-232 a consumer ptxas serializes its wgmma (C7512) or spills the
//     accumulators, and a g warpgroup at 40-72 registers spills or
//     serializes its own h products (C7520);
//   * g through a per-warpgroup shared-memory ring, the next chunk's h
//     issued beside this chunk's y product and its GELU run under it: 1.11;
//   * y product and the next chunk's h product under one wait: 1.16 (C7512);
//   * 16 rows normalized at a time: 0.92; writing 8 rows at a time: 1.16;
//     the next wave's x tile prefetched into L2 (cp.async.bulk.prefetch):
//     0.93-0.95, against 0.91 for 8 and 4;
//   * y products of two chunks under one wait: ptxas serializes (C7512).
// Rings of 2 + 2 stages from one producer lane took 0.91-0.92, 2 + 2 from
// two lanes 0.92, 3 + 2 0.89-0.92, 2 + 3 0.89-0.91 (the LN-out instance;
// the plain one 0.86, 0.85, 0.82, 0.86); the warpgroups out of step 1.12-1.14
// against 1.14-1.16 in step at a streamed band's 142910 rows, and the same
// when warpgroup 1 waits for warpgroup 0's first y product instead.
// What paces it now (ablation at 142910 rows, 1.15 ms whole): no y product
// 0.49, the y product from shared memory (A read from the W2 stage itself:
// timing only) 0.52, GELU replaced by the bias add 0.81, no h product 1.00.
// The y product with g as the register operand and the GELU each cost about
// 0.3 ms in the chain; g through shared memory costs more (1.36 at 142910
// rows, and 1.39 with A read from the W2 stage instead: the stores' path, not
// the operand), and the same 8 stores beside the register operand 1.19.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kVR = 128;        // rows per CTA (sw128_offset's 128): two consumer warpgroups
constexpr int kVC = 32;         // hidden units per chunk
constexpr int kVThreads = 384;  // two consumer warpgroups + the producer warpgroup
constexpr int kS1 = 2, kS2 = 3;  // stages of the W1 ring and of the W2 ring
constexpr int kLnRows = 8;      // rows a warp normalizes at a time
constexpr int kOutRows = 4;     // rows a warp writes out (and normalizes) at a time

template <int D>
struct MlpServe {
  static constexpr int CH = D / 64;                // 64-column chunks of xn and W1
  static constexpr int HALVES = D / 192;           // n = 192 products of y
  static constexpr int XN_BYTES = CH * kVR * 128;  // chunk c: 128 rows at c * kVR * 128
  static constexpr int W1_BYTES = CH * kVC * 128;  // chunk c: 32 rows at c * kVC * 128
  static constexpr int W2_BYTES = D * kVC * 2;     // D rows of 64 bytes
  static constexpr size_t SMEM =
      1024 + XN_BYTES + kS1 * W1_BYTES + kS2 * W2_BYTES + 8 * 2 * (kS1 + kS2);
};

// h = xn . W1c^T of one chunk, issued and committed: 64 rows x 32 units
template <int D>
__device__ __forceinline__ void issue_h_serve(float (&h)[16], const unsigned char* xw,
                                              const unsigned char* w1s) {
#pragma unroll
  for (int i = 0; i < 16; ++i) h[i] = 0.f;
  const uint64_t a = desc_k128(xw), b = desc_k128(w1s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {  // descriptors: a base plus byte offsets / 16
    const int j = kk >> 2, off = (kk & 3) * 32;
    wgmma_ss_m64n32k16(h, a + ((j * kVR * 128 + off) >> 4), b + ((j * kVC * 128 + off) >> 4));
  }
  wgmma_commit();
}

// y += g . W2c^T of one chunk, issued and committed: g packed in ga as the
// register A operand of the chunk's two k-steps
template <int D>
__device__ __forceinline__ void issue_y_serve(float (&y)[D / 192][96], const uint32_t (&ga)[2][4],
                                              const unsigned char* w2s) {
  const uint64_t b = desc_k64(w2s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int hf = 0; hf < D / 192; ++hf)
      wgmma_rs_m64n192k16<0>(y[hf], ga[kk], b + ((hf * 192 * kVC * 2 + kk * 32) >> 4));
  wgmma_commit();
}

// g = round(gelu(h + b1)) of units h0 .., packed as the A operand of the
// two k-steps of y += g . W2c^T; h[4i + e]: row g + 8 (e >> 1), unit h0 + 8i
// + 2 t4 + (e & 1)
__device__ __forceinline__ void gelu_pack(float (&h)[16], const float* __restrict__ b1, int h0,
                                          int t4, uint32_t (&ga)[2][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = 8 * i + 2 * t4;
    const float bj0 = b1[h0 + col], bj1 = b1[h0 + col + 1];
    float p;
    gelu_pieces(h[4 * i] + bj0, h[4 * i], p);
    gelu_pieces(h[4 * i + 1] + bj1, h[4 * i + 1], p);
    gelu_pieces(h[4 * i + 2] + bj0, h[4 * i + 2], p);
    gelu_pieces(h[4 * i + 3] + bj1, h[4 * i + 3], p);
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    ga[kk][0] = pack_bf16(h[8 * kk], h[8 * kk + 1]);
    ga[kk][1] = pack_bf16(h[8 * kk + 2], h[8 * kk + 3]);
    ga[kk][2] = pack_bf16(h[8 * kk + 4], h[8 * kk + 5]);
    ga[kk][3] = pack_bf16(h[8 * kk + 6], h[8 * kk + 7]);
  }
}

// mu and rstd of NR rows held as v[k][c] = row k [lane + 32 c] across a
// warp: common.cuh::warp_ln_stats for each row, the rows' shuffles
// interleaved (the same sums in the same order)
template <int D, int NR>
__device__ __forceinline__ void ln_stats_rows(const float (&v)[NR][D / 32], float eps,
                                              float (&mu)[NR], float (&rstd)[NR]) {
  constexpr int CPT = D / 32;
  float t[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    t[k] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) t[k] += v[k][c];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < NR; ++k) t[k] += __shfl_xor_sync(0xffffffffu, t[k], o);
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    mu[k] = t[k] / D;
    t[k] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float d = v[k][c] - mu[k];
      t[k] += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < NR; ++k) t[k] += __shfl_xor_sync(0xffffffffu, t[k], o);
#pragma unroll
  for (int k = 0; k < NR; ++k) rstd[k] = 1.f / sqrtf(t[k] / D + eps);
}

// LN(x) s + bn of rows row0 .. row0 + NR - 1 of x (rows past R as zeros),
// handed to put(k, col, value) at each lane's columns lane + 32 c: the rows'
// loads issued together, where one row at a time waits on memory NR times
template <int D, int NR, class Put>
__device__ __forceinline__ void ln_rows(const __nv_bfloat16* __restrict__ x, int R, long long row0,
                                        int lane, const float* __restrict__ s,
                                        const float* __restrict__ bn, float eps, Put put) {
  constexpr int CPT = D / 32;
  float v[NR][CPT], mu[NR], rstd[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      v[k][c] = row0 + k < R ? __bfloat162float(x[(row0 + k) * D + lane + 32 * c]) : 0.f;
  ln_stats_rows<D, NR>(v, eps, mu, rstd);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = lane + 32 * c;
    const float sc = s[col], bc = bn[col];
#pragma unroll
    for (int k = 0; k < NR; ++k) put(k, col, (v[k][c] - mu[k]) * rstd[k] * sc + bc);
  }
}

template <int D, bool LNOUT>
__global__ void __launch_bounds__(kVThreads, 1)
fused_mlp_serve_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                             const __grid_constant__ CUtensorMap w2_map,
                             const __nv_bfloat16* __restrict__ x, const float* __restrict__ s1,
                             const float* __restrict__ bn1, const float* __restrict__ b1,
                             const float* __restrict__ b2, const float* __restrict__ s2,
                             const float* __restrict__ bn2, __nv_bfloat16* __restrict__ out,
                             __nv_bfloat16* __restrict__ z, int R, int H, float eps) {
  using C = MlpServe<D>;
  constexpr int CPT = D / 32;  // LN: columns per lane
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* xs = align1024(smem_raw);
  unsigned char* ring1 = xs + C::XN_BYTES;          // W1 chunks
  unsigned char* ring2 = ring1 + kS1 * C::W1_BYTES;  // W2 chunks
  uint64_t* full1 = reinterpret_cast<uint64_t*>(ring2 + kS2 * C::W2_BYTES);
  uint64_t* empty1 = full1 + kS1;
  uint64_t* full2 = empty1 + kS1;
  uint64_t* empty2 = full2 + kS2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = H / kVC;
  if (tid == 0) {
    for (int s = 0; s < kS1; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], 8);  // every consumer warp
    }
    for (int s = 0; s < kS2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one lane streams W1, another W2
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      for (int c = 0; c < n; ++c) {
        const int s = c % kS1;
        mbar_wait(&empty1[s], ((c / kS1) & 1) ^ 1);
        mbar_expect_tx(&full1[s], C::W1_BYTES);
        for (int j = 0; j < C::CH; ++j)
          tma_load_2d(ring1 + s * C::W1_BYTES + j * kVC * 128, &w1_map, &full1[s], 64 * j,
                      c * kVC);
      }
    } else if (warp == 9 && lane == 0) {
      for (int c = 0; c < n; ++c) {
        const int s = c % kS2;
        mbar_wait(&empty2[s], ((c / kS2) & 1) ^ 1);
        mbar_expect_tx(&full2[s], C::W2_BYTES);
        for (int j = 0; j < C::HALVES; ++j)
          tma_load_2d(ring2 + s * C::W2_BYTES + j * 192 * kVC * 2, &w2_map, &full2[s], c * kVC,
                      192 * j);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    // consumer warpgroup wg: rows rb ..; warp wl of it normalizes rows 16 wl
    // .. 16 wl + 15 and holds accumulator rows 16 wl + g (+ 8). A warpgroup
    // with no row below R only releases the chunks.
    const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
    const long long rb = (long long)blockIdx.x * kVR + 64 * wg;
    unsigned char* xw = xs + wg * 64 * 128;
    auto w1s = [&](int c) { return ring1 + (c % kS1) * C::W1_BYTES; };
    auto w2s = [&](int c) { return ring2 + (c % kS2) * C::W2_BYTES; };
    auto await1 = [&](int c) { mbar_wait(&full1[c % kS1], (c / kS1) & 1); };
    auto await2 = [&](int c) { mbar_wait(&full2[c % kS2], (c / kS2) & 1); };
    auto release1 = [&](int c) {
      if (lane == 0) mbar_arrive(&empty1[c % kS1]);
    };
    auto release2 = [&](int c) {
      if (lane == 0) mbar_arrive(&empty2[c % kS2]);
    };
    if (rb >= R) {
      for (int c = 0; c < n; ++c) {
        await1(c);
        release1(c);
        await2(c);
        release2(c);
      }
      return;
    }

    // xn = round(LN(x) * s1 + bn1), kLnRows rows at a time across the warp
#pragma unroll 1
    for (int r0 = 16 * wl; r0 < 16 * wl + 16; r0 += kLnRows)
      ln_rows<D, kLnRows>(x, R, rb + r0, lane, s1, bn1, eps, [&](int k, int col, float v) {
        *reinterpret_cast<__nv_bfloat16*>(xw + sw128_offset(r0 + k, col)) = __float2bfloat16_rn(v);
      });
    fence_proxy_async();
    named_barrier(1 + wg, 128);

    float y[C::HALVES][96];
#pragma unroll
    for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
      for (int i = 0; i < 96; ++i) y[hf][i] = 0.f;
    uint32_t ga[2][4];
    if (wg == 1) named_barrier(3, 256);  // start behind warpgroup 0: see the note
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      float h[16];
      await1(c);
      issue_h_serve<D>(h, xw, w1s(c));
      wgmma_wait<0>();
      fence_regs(h);
      release1(c);
      gelu_pack(h, b1, c * kVC, t4, ga);
      if (c == 0 && wg == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
      await2(c);
      issue_y_serve<D>(y, ga, w2s(c));
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
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + row * D + col);
            x0 = __low2float(xv);
            x1 = __high2float(xv);
          }
          *reinterpret_cast<uint32_t*>(xw + sw128_offset(r, col)) =
              pack_bf16(x0 + (y[hf][4 * i + 2 * e] + bc0), x1 + (y[hf][4 * i + 2 * e + 1] + bc1));
        }
      }
    named_barrier(1 + wg, 128);

    // out from the staged rows, and with LNOUT z = LN(out), kOutRows rows at
    // a time (rows past R read and normalized, not written)
#pragma unroll 1
    for (int r0 = 16 * wl; r0 < 16 * wl + 16 && rb + r0 < R; r0 += kOutRows) {
      float o[kOutRows][CPT];
#pragma unroll
      for (int k = 0; k < kOutRows; ++k) {
        const long long row = rb + r0 + k;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = lane + 32 * c;
          const __nv_bfloat16 v =
              *reinterpret_cast<const __nv_bfloat16*>(xw + sw128_offset(r0 + k, col));
          if (row < R) out[row * D + col] = v;
          o[k][c] = __bfloat162float(v);
        }
      }
      if (LNOUT) {
        float mu[kOutRows], rstd[kOutRows];
        ln_stats_rows<D, kOutRows>(o, eps, mu, rstd);
#pragma unroll
        for (int k = 0; k < kOutRows; ++k) {
          const long long row = rb + r0 + k;
          if (row < R)
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const int col = lane + 32 * c;
              z[row * D + col] = __float2bfloat16_rn((o[k][c] - mu[k]) * rstd[k] * s2[col] + bn2[col]);
            }
        }
      }
    }
  }
}

// x, out, z (R, D); w1 (H, D); w2 (D, H) bf16, 16-byte aligned; s1, bn1, s2,
// bn2, b2 (D) and b1 (H) f32
template <int D, bool LNOUT>
static int launch_mlp_serve(const void* x, const float* s1, const float* bn1, const void* w1,
                            const float* b1, const void* w2, const float* b2, const float* s2,
                            const float* bn2, void* out, void* z, int R, int H, float eps,
                            cudaStream_t stream) {
  using C = MlpServe<D>;
  CUtensorMap m1, m2;
  const uint64_t d1[2] = {(uint64_t)D, (uint64_t)H}, st1[1] = {(uint64_t)D * 2};
  const uint32_t box1[2] = {64, kVC};
  const uint64_t d2[2] = {(uint64_t)H, (uint64_t)D}, st2[1] = {(uint64_t)H * 2};
  const uint32_t box2[2] = {kVC, 192};
  if (!make_tmap_bf16(&m1, w1, 2, d1, st1, box1, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap_bf16(&m2, w2, 2, d2, st2, box2, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int rc = device_sms_for<&fused_mlp_serve_wgmma_kernel<D, LNOUT>>(C::SMEM, &sms);
  if (rc != 0) return rc;
  using B = __nv_bfloat16;
  fused_mlp_serve_wgmma_kernel<D, LNOUT><<<(R + kVR - 1) / kVR, kVThreads, C::SMEM, stream>>>(
      m1, m2, static_cast<const B*>(x), s1, bn1, b1, b2, s2, bn2, static_cast<B*>(out),
      static_cast<B*>(z), R, H, eps);
  return (int)cudaGetLastError();
}

}  // namespace vitocm

// Forward, bf16, inference: x, out, z (R, D); w1 (H, D); w2 (D, H), all
// 16-byte aligned; s1, bn1, s2, bn2, b2 (D) and b1 (H) in f32. lnout = 0
// ignores s2, bn2 and z. D in {192, 384}, H a multiple of 32. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int vitocm_fused_mlp_serve(int lnout, const void* x, const void* s1, const void* bn1,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* s2, const void* bn2, void* out,
                                      void* z, int R, int D, int H, float eps, void* stream) {
  using namespace vitocm;
  if (R < 1 || H < kVC || H % kVC != 0 || (lnout && z == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (D == 384)
    return lnout ? launch_mlp_serve<384, true>(x, f(s1), f(bn1), w1, f(b1), w2, f(b2), f(s2),
                                               f(bn2), out, z, R, H, eps, s)
                 : launch_mlp_serve<384, false>(x, f(s1), f(bn1), w1, f(b1), w2, f(b2), f(s2),
                                                f(bn2), out, z, R, H, eps, s);
  if (D == 192)
    return lnout ? launch_mlp_serve<192, true>(x, f(s1), f(bn1), w1, f(b1), w2, f(b2), f(s2),
                                               f(bn2), out, z, R, H, eps, s)
                 : launch_mlp_serve<192, false>(x, f(s1), f(bn1), w1, f(b1), w2, f(b2), f(s2),
                                                f(bn2), out, z, R, H, eps, s);
  return (int)cudaErrorInvalidValue;
}
