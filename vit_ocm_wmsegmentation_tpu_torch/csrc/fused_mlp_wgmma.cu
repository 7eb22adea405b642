// Fused pre-norm MLP block, training forward, bf16 storage, on Hopper's
// warpgroup tensor cores: wgmma fed by TMA through an mbarrier ring.
//   out = x + W2 . gelu(W1 . LN(x; s1, bn1) + b1) + b2, and h1 or g, gp
// Replaces vit_ocm_wmsegmentation_tpu/ops/fused_mlp.py::_mlp_fwd_kernel for
// bf16 on its training routes: want="h1" (the pre-GELU h1 rounded to bf16,
// GELU reading the unrounded value) and want="gp" (GP: the rounded g =
// gelu(h1) in h1's place, the very bf16 values the y product multiplies, so
// out is bit-equal to the h1 route's, and gelu'(h1) rounded). The inference
// forward (no residual outputs, LN-out and plain) is fused_mlp_serve_wgmma.cu,
// which began as this kernel's inference instances. Weights in nn.Linear's
// layout: w1 (H, D), w2 (D, H), bf16; LN scales and biases f32. D in {192,
// 384}, H a multiple of 32.
//
// Rounding points of the twin (ops/fused_mlp.py::_mlp_plain): xn rounded to
// bf16, h1 in f32, g rounded to bf16, f32 accumulation, out = round(x + (acc
// + b2)). Only the order of the f32 sums inside each product differs, and
// GELU's Phi and exp (common.cuh::gelu_pieces_bf16: within 1.5e-7 of erf,
// shared by both routes so that their outs stay bit-equal).
//
// What bounds it on the H100: at the MIM step's 36880 x 384, H 1536, 87
// GFLOP (0.088 ms at 989 TFLOP/s), and the routes write 113 MB (h1) or 227
// MB (g, gp) besides x and out. The mma.sync kernels this replaced copied
// each weight chunk with all threads between two __syncthreads (tensor cores
// idle), once per 64 rows. Here a
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
// lane issues the copies). Each warp stages its (16 x 32) h1 or g tile, and
// gp, in 2 KB of its own shared memory (64-byte rows, swizzled so that the
// accumulator-layout pairs hit 32 banks), then writes 16 bytes a lane while
// the y product runs. Shared memory 209 KB at D = 384: one CTA an SM. At the
// MIM step's 36880 rows the 289 tiles are 2.19 waves of 132 CTAs, so a third
// of the kernel's time ran 25 CTAs; each tile past the last whole wave
// (ops/fused_mlp.py::fwd_split) runs as up to 4 CTAs, each over a share of
// the chunks, which write their y in f32 for mlp_split_combine_kernel to sum
// in order. The epilogue stages the rounded out in the warpgroup's xn space,
// then one warp per row writes it. Within a warpgroup the h product, the
// GELU and the y product run one after another; the two warpgroups overlap
// each other. On an H100 these were slower: sharing each weight chunk
// between two CTAs of a cluster by TMA multicast, turn-taking between the
// warpgroups, and issuing the next chunk's h before this chunk's GELU (which
// spills at 240 registers).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kFR = 128;        // rows per CTA (sw128_offset's 128): two consumer warpgroups
constexpr int kFC = 32;         // hidden units per chunk
constexpr int kFThreads = 384;  // two consumer warpgroups + the producer warpgroup
constexpr int kFS1 = 2, kFS2 = 2;  // stages of the W1 and of the W2 ring
constexpr int kFStage = 2048;   // a warp's staging on the training routes: h1 or g, then gp

template <int D>
struct MlpWgmma {
  static constexpr int CH = D / 64;                    // 64-column chunks of xn and W1
  static constexpr int HALVES = D / 192;               // n = 192 products of y
  static constexpr int XN_BYTES = CH * kFR * 128;      // chunk c: 128 rows at c * kFR * 128
  static constexpr int W1_BYTES = CH * kFC * 128;      // chunk c: 32 rows at c * kFC * 128
  static constexpr int W2_BYTES = D * kFC * 2;         // D rows of 64 bytes
  static constexpr int ST_BYTES = 8 * kFStage;
  static constexpr size_t SMEM = 1024 + XN_BYTES + kFS1 * W1_BYTES + kFS2 * W2_BYTES + ST_BYTES +
                                 8 * 2 * (kFS1 + kFS2);
};

// h = xn . W1c^T of one chunk, issued (not waited for): 64 rows x 32 units
template <int D>
__device__ __forceinline__ void issue_h(float (&h)[16], const unsigned char* xw,
                                        const unsigned char* w1s) {
#pragma unroll
  for (int i = 0; i < 16; ++i) h[i] = 0.f;
  const uint64_t a = desc_k128(xw), b = desc_k128(w1s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {  // descriptors: a base plus byte offsets / 16
    const int j = kk >> 2, off = (kk & 3) * 32;
    wgmma_ss_m64n32k16(h, a + ((j * kFR * 128 + off) >> 4), b + ((j * kFC * 128 + off) >> 4));
  }
  wgmma_commit();
}

// 4 bytes at (r, col) of a warp's sw64 staging tile
__device__ __forceinline__ void stage_pair(unsigned char* tile, int r, int col, uint32_t v) {
  *reinterpret_cast<uint32_t*>(tile + sw64_offset(r, col)) = v;
}

// g = round(gelu(h + b1)) of hidden units h0 .., packed as the A operand of
// the two k-steps of y += g . W2c^T; h[4i + e]: row g + 8 (e >> 1), unit h0
// + 8i + 2 t4 + (e & 1). The h1 route stages round(h + b1) at st, GP
// instead g there and round(gelu'(h + b1)) at st + 1024 (the warp's rows at
// g, g + 8).
template <bool GP>
__device__ __forceinline__ void gelu_pack(float (&h)[16], const float* __restrict__ b1, int h0,
                                          int g, int t4, uint32_t (&ga)[2][4], unsigned char* st) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = 8 * i + 2 * t4;
    const float bj0 = b1[h0 + col], bj1 = b1[h0 + col + 1];
    const float u0 = h[4 * i] + bj0, u1 = h[4 * i + 1] + bj1;
    const float u2 = h[4 * i + 2] + bj0, u3 = h[4 * i + 3] + bj1;
    if (!GP) {
      stage_pair(st, g, col, pack_bf16(u0, u1));
      stage_pair(st, g + 8, col, pack_bf16(u2, u3));
    }
    float p0, p1, p2, p3;  // gelu'(h): only GP keeps it, rounded
    gelu_pieces_bf16(u0, h[4 * i], p0);  // g (and gp) by the bf16 pieces
    gelu_pieces_bf16(u1, h[4 * i + 1], p1);
    gelu_pieces_bf16(u2, h[4 * i + 2], p2);
    gelu_pieces_bf16(u3, h[4 * i + 3], p3);
    if (GP) {
      stage_pair(st + 1024, g, col, pack_bf16(p0, p1));
      stage_pair(st + 1024, g + 8, col, pack_bf16(p2, p3));
      __syncwarp();  // one i at a time: interleaved, the four spilled beside y at 240 registers
    }
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    ga[kk][0] = pack_bf16(h[8 * kk], h[8 * kk + 1]);
    ga[kk][1] = pack_bf16(h[8 * kk + 2], h[8 * kk + 3]);
    ga[kk][2] = pack_bf16(h[8 * kk + 4], h[8 * kk + 5]);
    ga[kk][3] = pack_bf16(h[8 * kk + 6], h[8 * kk + 7]);
    if (GP) {  // the packed g pairs: rows g, g + 8 of units 16 kk + 2 t4 and 16 kk + 8 + 2 t4
      stage_pair(st, g, 16 * kk + 2 * t4, ga[kk][0]);
      stage_pair(st, g + 8, 16 * kk + 2 * t4, ga[kk][1]);
      stage_pair(st, g, 16 * kk + 8 + 2 * t4, ga[kk][2]);
      stage_pair(st, g + 8, 16 * kk + 8 + 2 * t4, ga[kk][3]);
    }
  }
}

// y += g . W2c^T, issued (not waited for)
template <int D>
__device__ __forceinline__ void issue_y(float (&y)[D / 192][96], const uint32_t (&ga)[2][4],
                                        const unsigned char* w2s) {
  const uint64_t b = desc_k64(w2s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int hf = 0; hf < D / 192; ++hf)
      wgmma_rs_m64n192k16<0>(y[hf], ga[kk], b + ((hf * 192 * kFC * 2 + kk * 32) >> 4));
  wgmma_commit();
}

template <int D, bool GP>
__global__ void __launch_bounds__(kFThreads, 1)
fused_mlp_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                       const __grid_constant__ CUtensorMap w2_map,
                       const __nv_bfloat16* __restrict__ x, const float* __restrict__ s1,
                       const float* __restrict__ bn1, const float* __restrict__ b1,
                       const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                       __nv_bfloat16* __restrict__ h1, __nv_bfloat16* __restrict__ gp,
                       float* __restrict__ ypart, int split_from, int parts, int R, int H,
                       float eps) {
  using C = MlpWgmma<D>;
  constexpr int CPT = D / 32;  // LN: columns per lane
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* xs = align1024(smem_raw);
  unsigned char* ring1 = xs + C::XN_BYTES;          // W1 chunks
  unsigned char* ring2 = ring1 + kFS1 * C::W1_BYTES;  // W2 chunks
  unsigned char* stg = ring2 + kFS2 * C::W2_BYTES;    // per warp: h1 or g, then gp
  uint64_t* full1 = reinterpret_cast<uint64_t*>(stg + C::ST_BYTES);
  uint64_t* empty1 = full1 + kFS1;
  uint64_t* full2 = empty1 + kFS1;
  uint64_t* empty2 = full2 + kFS2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = H / kFC;
  // the tiles from split_from on (those past the
  // last whole wave of CTAs) each run as `parts` CTAs, each over a share of
  // the chunks, that write their y to ypart for mlp_split_combine_kernel
  int tile = blockIdx.x, c0 = 0, n = chunks, part = -1;
  if (tile >= split_from) {
    const int k = tile - split_from;
    tile = split_from + k / parts;
    part = k % parts;
    c0 = part * chunks / parts;
    n = (part + 1) * chunks / parts - c0;
  }
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
      for (int i = 0; i < n; ++i) {  // ring slots by i, weights by chunk c
        const int a = i % kFS1, b = i % kFS2, c = c0 + i;
        mbar_wait(&empty1[a], ((i / kFS1) & 1) ^ 1);
        mbar_expect_tx(&full1[a], C::W1_BYTES);
        for (int j = 0; j < C::CH; ++j)
          tma_load_2d(ring1 + a * C::W1_BYTES + j * kFC * 128, &w1_map, &full1[a], 64 * j,
                      c * kFC);
        mbar_wait(&empty2[b], ((i / kFS2) & 1) ^ 1);
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
    const long long rb = (long long)tile * kFR + 64 * wg;
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
      for (int i = 0; i < n; ++i) {
        await1(i);
        release1(i);
        await2(i);
        release2(i);
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
        *reinterpret_cast<__nv_bfloat16*>(xw + sw128_offset(r, col)) =
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
    unsigned char* st = stg + warp * kFStage;
    for (int i = 0; i < n; ++i) {
      const int c = c0 + i;
      float h[16];
      await1(i);
      issue_h<D>(h, xw, w1s(i));
      wgmma_wait<0>();
      fence_regs(h);
      release1(i);
      gelu_pack<GP>(h, b1, c * kFC, g, t4, ga, st);
      await2(i);
      issue_y<D>(y, ga, w2s(i));
      __syncwarp();  // the staged tiles out while the y product runs
      warp_tile_store(st, h1, rb + 16 * wl, R, H, c * kFC, lane);
      if (GP) warp_tile_store(st + 1024, gp, rb + 16 * wl, R, H, c * kFC, lane);
      __syncwarp();
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < C::HALVES; ++hf) fence_regs(y[hf]);
      release2(i);
    }
    if (part >= 0) {  // a share of a split tile: its y, f32, (128, D) a part
      float* yp = ypart + ((long long)(tile - split_from) * parts + part) * kFR * D;
#pragma unroll
      for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
        for (int i = 0; i < 24; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<float2*>(yp + (64 * wg + 16 * wl + g + 8 * e) * D + 192 * hf +
                                       8 * i + 2 * t4) =
                make_float2(y[hf][4 * i + 2 * e], y[hf][4 * i + 2 * e + 1]);
      return;
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
          *reinterpret_cast<uint32_t*>(xw + sw128_offset(r, col)) =
              pack_bf16(x0 + (y[hf][4 * i + 2 * e] + bc0), x1 + (y[hf][4 * i + 2 * e + 1] + bc1));
        }
      }
    named_barrier(1 + wg, 128);

    for (int i = 0; i < 16; ++i) {
      const int r = 16 * wl + i;
      const long long row = rb + r;
      if (row >= R) break;  // rows only grow with i
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = lane + 32 * c;
        out[row * D + col] = *reinterpret_cast<const __nv_bfloat16*>(xw + sw128_offset(r, col));
      }
    }
  }
}

// out = round(x + ((y_0 + .. + y_{parts-1}) + b2)) for the rows of the split
// tiles, row0 .. R - 1, the parts' y summed in order
__global__ void mlp_split_combine_kernel(const __nv_bfloat16* __restrict__ x,
                                         const float* __restrict__ ypart,
                                         const float* __restrict__ b2,
                                         __nv_bfloat16* __restrict__ out, long long row0, int R,
                                         int D, int parts) {
  const long long pairs = (R - row0) * (D / 2);
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < pairs;
       p += (long long)gridDim.x * blockDim.x) {
    const long long r = p / (D / 2);
    const int col = (int)(p % (D / 2)) * 2;
    const float* yp = ypart + ((r / kFR) * parts * kFR + r % kFR) * D + col;
    float y0 = 0.f, y1 = 0.f;
    for (int s = 0; s < parts; ++s) {
      const float2 v = *reinterpret_cast<const float2*>(yp + (long long)s * kFR * D);
      y0 += v.x;
      y1 += v.y;
    }
    const long long at = (row0 + r) * D + col;
    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + at);
    *reinterpret_cast<uint32_t*>(out + at) =
        pack_bf16(__low2float(xv) + (y0 + b2[col]), __high2float(xv) + (y1 + b2[col + 1]));
  }
}

template <int D, bool GP>
static int launch_mlp_wgmma(const void* x, const float* s1, const float* bn1, const void* w1,
                            const float* b1, const void* w2, const float* b2, void* out, void* h1,
                            void* gp, float* ypart, int split_from, int parts, int R, int H,
                            float eps, cudaStream_t stream) {
  using C = MlpWgmma<D>;
  CUtensorMap m1, m2;
  const uint64_t d1[2] = {(uint64_t)D, (uint64_t)H}, st1[1] = {(uint64_t)D * 2};
  const uint32_t box1[2] = {64, kFC};
  const uint64_t d2[2] = {(uint64_t)H, (uint64_t)D}, st2[1] = {(uint64_t)H * 2};
  const uint32_t box2[2] = {kFC, 192};
  if (!make_tmap_bf16(&m1, w1, 2, d1, st1, box1, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap_bf16(&m2, w2, 2, d2, st2, box2, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  auto kern = fused_mlp_wgmma_kernel<D, GP>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  using B = __nv_bfloat16;
  const int tiles = (R + kFR - 1) / kFR;
  kern<<<split_from + (tiles - split_from) * parts, kFThreads, C::SMEM, stream>>>(
      m1, m2, static_cast<const B*>(x), s1, bn1, b1, b2, static_cast<B*>(out),
      static_cast<B*>(h1), static_cast<B*>(gp), ypart, split_from, parts, R, H, eps);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || split_from == tiles) return rc;
  const long long pairs = (R - (long long)split_from * kFR) * (D / 2);
  mlp_split_combine_kernel<<<(int)min((pairs + 255) / 256, 4096LL), 256, 0, stream>>>(
      static_cast<const B*>(x), ypart, b2, static_cast<B*>(out), (long long)split_from * kFR, R,
      D, parts);
  return (int)cudaGetLastError();
}

}  // namespace vitocm

// Forward, bf16, training: x, out (R, D); h1, gp (R, H); w1 (H, D); w2 (D,
// H), all 16-byte aligned; s1, bn1, b2 (D) and b1 (H) in f32. h1 takes the
// pre-GELU h1; gp not null takes the SAVE_GP route: g = gelu(h1) into h1,
// gelu'(h1) into gp. The 128-row tiles from split_from on run as `parts`
// CTAs each (parts 1: none split), their y in ypart, (ceil(R / 128) -
// split_from) x parts x 128 x D f32. D in {192, 384}, H a multiple of 32.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int vitocm_fused_mlp_wgmma(const void* x, const void* s1, const void* bn1,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, void* out, void* h1, void* gp, void* ypart,
                                      int split_from, int parts, int R, int D, int H, float eps,
                                      void* stream) {
  using namespace vitocm;
  const int tiles = R > 0 ? (R + kFR - 1) / kFR : 0;
  if (R < 1 || H < kFC || H % kFC != 0 || h1 == nullptr || parts < 1 || split_from < 0 ||
      split_from > tiles || (split_from < tiles && (parts < 2 || ypart == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* yp = static_cast<float*>(ypart);
  if (D == 384)
    return gp ? launch_mlp_wgmma<384, true>(x, f(s1), f(bn1), w1, f(b1), w2, f(b2), out, h1, gp,
                                            yp, split_from, parts, R, H, eps, s)
              : launch_mlp_wgmma<384, false>(x, f(s1), f(bn1), w1, f(b1), w2, f(b2), out, h1,
                                             nullptr, yp, split_from, parts, R, H, eps, s);
  if (D == 192)
    return gp ? launch_mlp_wgmma<192, true>(x, f(s1), f(bn1), w1, f(b1), w2, f(b2), out, h1, gp,
                                            yp, split_from, parts, R, H, eps, s)
              : launch_mlp_wgmma<192, false>(x, f(s1), f(bn1), w1, f(b1), w2, f(b2), out, h1,
                                             nullptr, yp, split_from, parts, R, H, eps, s);
  return (int)cudaErrorInvalidValue;
}
