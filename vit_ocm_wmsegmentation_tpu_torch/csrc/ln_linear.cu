// Fused LayerNorm -> linear (the LN1 -> qkv projection of a ViT block on the
// TRAIN.LN_QKV route), forward and backward, f32 storage, CUDA cores; the C
// entry points for both storage types.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/ln_linear.py::_ln_linear_fwd_kernel
// (ln_linear_fwd_kernel) and ::_ln_linear_bwd_kernel (ln_linear_bwd_dx_kernel
// and ln_linear_bwd_w_kernel, then fused_mlp_bwd.cu's reduce_splits). With
// xn = round(LN(x) s + bn) (statistics in f32, biased variance) and W in
// nn.Linear's (K, D) layout:
//   y = round(xn W^T + b), the bias added in f32 before the one rounding;
//   dxn = dy W, dx = LN-backward(dxn) (no residual), dW = dy^T xn (K, D),
//   db = sum dy, ds = sum dxn * xh, dbb = sum dxn, every gradient in f32.
// The TPU kernels keep only x as the residual and recompute the row
// statistics in the backward; so do these. The TPU backward carries dW, db,
// ds and dbb across a sequential grid axis; here deterministic kernels with
// no atomics and a fixed-order reduction: two runs give bit-equal gradients.
//
// What bounds them on the H100: exact f32 products on the CUDA cores (FFMA,
// never TF32): at the MIM step's x (36880, 384), W (1152, 384) the forward is
// 32.6 GFLOP (0.49 ms at 67 TFLOP/s) against 0.23 GB of HBM traffic, the
// backward twice that. An SM issues 128 FFMA a cycle but moves 32 floats a
// cycle from shared memory to registers, so a micro-tile of TR x TK outputs
// (TR + TK floats loaded for TR * TK FFMA) keeps the pipes fed only from
// TR * TK / (TR + TK) = 4. The design is the f32 MLP kernels' (fused_mlp.cu,
// fused_mlp_bwd.cu; building blocks in ffma_tiles.cuh), each product one of
// the MLP's with an operand renamed:
//   * forward (256 threads, 64 rows a CTA): the rows are normalized once
//     into shared xn (pitch D + 4); the CTA walks K in chunks of 256 output
//     columns, y = xn W^T an 8 x 8 register tile a thread (tile_dot: xn and
//     W's rows read as float4 along D; a warp a row group, so xn is a
//     broadcast), W's rows arriving in 256 x 32 slices through a two-slot
//     16-byte cp.async ring, slice s + 1 in flight while slice s is
//     multiplied; a last chunk narrower than 256 (K a multiple of 64) takes
//     an 8 x 6, 8 x 4 or 8 x 2 tile, so no column is computed twice or for
//     nothing. W is read from L2 once per 64 rows. 173 KB of shared memory
//     at D = 384, one CTA an SM; the row tiles past the last whole wave
//     (49 of 577 at the MIM shape on 132 SMs) run as 2-4 CTAs each over a
//     share of the columns;
//   * dx kernel (256 threads, 64 rows a tile): dxn = dy W (64 x D) held in
//     registers for the whole walk over K (tile_pv; 8 x 12 a thread at
//     D = 384, 4 x 12 at D = 192), dy slices (64 rows x 32 of K) and W
//     slices (32 rows x D) through a two-slot cp.async ring; then the LN
//     backward, a row group a row (group_sum), which writes dx, xn (for the
//     weight kernel, which would otherwise recompute the LayerNorm once per
//     column tile) and one [ds | dbb] partial a tile, its rows summed in a
//     fixed order. 118 KB at D = 384;
//   * weight kernel (256 threads, two CTAs an SM): a (128 x 128) tile of
//     dW = dy^T xn, 8 x 8 a thread (tile_tn: a row of each operand a step,
//     as float4s), over the rows of its split in 32-row slices through a
//     three-slot cp.async ring (96 KB); the first column tile also sums db.
//     The split count is the one (at most the caller's) whose last wave of
//     CTAs over the card's SMs is fullest; each split writes one partial.
// bf16 storage takes the wgmma forward of ln_linear_wgmma.cu and the wgmma
// backward of ln_linear_bwd_wgmma.cu.
//
// Numerics: every sum runs over its inner index in order (y over D from 0,
// then the bias; dxn over K; dW and db over the split's rows), so the
// results do not depend on the launch.

#include <math.h>

#include "common.cuh"
#include "ffma_tiles.cuh"

namespace vitocm {

constexpr int kLnR = 64;   // rows a CTA (forward) or tile (dx kernel, ln_part), both storage types
constexpr int kLnT = 256;  // threads: 8 warps
constexpr int kFC = 256;   // forward: output columns (rows of W) a chunk
constexpr int kFS = 32;    // forward: depth (of D) of a W slice
constexpr int kFSlot = kFC * (kFS + 4);
constexpr int kXJ = 32;    // dx kernel: columns of dy (rows of W) a slice
constexpr int kGM = 128, kGN = 128;  // weight kernel: output tile
constexpr int kGK = 32;              // ... rows a slice
constexpr int kGS = 3;               // ... ring slots
constexpr size_t kGSmem = sizeof(float) * kGS * kGK * (kGM + kGN);

template <int D>
constexpr size_t ln_fwd_smem_bytes() {
  return sizeof(float) * (kLnR * (D + 4) + 2 * kFSlot);
}

// the dx kernel's dxn tile: RG row groups of KG lanes, rows rg + RG*i, float4
// column groups 4*kg + 4*KG*g; 8 x 12 at D = 384, 4 x 12 at D = 192
template <int D>
struct LnDxTiles {
  static constexpr int RG = D == 384 ? 8 : 16, KG = kLnT / RG;
};

// floats of a dx ring slot: a dy slice (LnR x XJ) and a W slice (XJ x D)
template <int D>
__host__ __device__ constexpr int ln_dx_slot() {
  return kLnR * (kXJ + 4) + kXJ * (D + 4);
}

template <int D>
constexpr size_t ln_bwd_dx_smem_bytes() {
  return sizeof(float) * 2 * ln_dx_slot<D>();
}

// forward slice st of columns cb .. ce (chunk st / NS, depth slice st % NS):
// W[c0 .. c0 + FC, FS*p ..] into dst; rows from ce on are zeros
template <int D>
__device__ __forceinline__ void ln_fwd_issue(float* dst, const float* w, int st, int cb, int ce) {
  constexpr int NS = D / kFS;
  const int c0 = cb + st / NS * kFC, p = st % NS;
  stage_rows<kFC, kFS, kFS + 4, kLnT>(dst, w + (long long)c0 * D + p * kFS, 0, ce - c0, D);
}

// one forward chunk, TK <= 8 columns a lane: y[r0 + warp + 8i][c0 + lane + 32j]
// over the NS slices st0 .. st0 + NS - 1 of the ring, then the bias
template <int D, int TK>
__device__ __forceinline__ void ln_fwd_chunk(const float* xn, float* ring, const float* w,
                                             const float* b, float* y, int r0, int c0, int st0,
                                             int total, int cb, int ce, int R, int K) {
  constexpr int PX = D + 4, NS = D / kFS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[8][TK];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TK; ++j) acc[i][j] = 0.f;
  for (int p = 0; p < NS; ++p) {
    const int st = st0 + p;
    cp_async_wait<0>();
    __syncthreads();  // slice st (and xn) has landed; slice st - 1 is done
    if (st + 1 < total) ln_fwd_issue<D>(ring + ((st + 1) & 1) * kFSlot, w, st + 1, cb, ce);
    cp_async_commit();
    tile_dot<8, TK, 8, 32, kFS, PX, kFS + 4>(acc, xn + p * kFS, ring + (st & 1) * kFSlot, warp,
                                             lane);
  }
#pragma unroll
  for (int j = 0; j < TK; ++j) {
    const int col = c0 + lane + 32 * j;
    const float bj = b[col];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long row = r0 + warp + 8 * i;
      if (row < R) y[row * K + col] = acc[i][j] + bj;  // a warp stores 128 bytes of a row
    }
  }
}

// The row tiles from split_from on (those past the last whole wave) run as
// `parts` CTAs each, CTA `part` over the columns of its share of K's 64-column
// groups; every output is computed once, so the split changes no bit.
template <int D>
__global__ void __launch_bounds__(kLnT, 1)
ln_linear_fwd_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ bn, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ y, int R, int K,
                     int split_from, int parts, float eps) {
  constexpr int CPT = D / 32, RPW = kLnR / 8, PX = D + 4, NS = D / kFS;
  static_assert(D % kFS == 0 && kLnR == 64 && kFC == 256, "tile shape");
  extern __shared__ __align__(16) float sm[];
  float* xn = sm;                 // (LnR, PX)
  float* ring = xn + kLnR * PX;  // 2 slots

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int tile = blockIdx.x, cb = 0, ce = K;
  if (tile >= split_from) {
    const int q = tile - split_from, part = q % parts, groups = K / 64;
    tile = split_from + q / parts;
    cb = part * groups / parts * 64;
    ce = (part + 1) * groups / parts * 64;
  }
  const int r0 = tile * kLnR;
  const int chunks = (ce - cb + kFC - 1) / kFC, total = chunks * NS;
  if (total == 0) return;
  ln_fwd_issue<D>(ring, w, 0, cb, ce);
  cp_async_commit();

  // LayerNorm, a warp a row, while the first slice lands
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
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
      xn[r * PX + col] = (v[c] - mu) * rstd * s[col] + bn[col];
    }
  }

  for (int c = 0; c < chunks; ++c) {
    const int c0 = cb + c * kFC, nw = min(kFC, ce - c0), st0 = c * NS;
    if (nw == kFC)
      ln_fwd_chunk<D, 8>(xn, ring, w, b, y, r0, c0, st0, total, cb, ce, R, K);
    else if (nw == 192)
      ln_fwd_chunk<D, 6>(xn, ring, w, b, y, r0, c0, st0, total, cb, ce, R, K);
    else if (nw == 128)
      ln_fwd_chunk<D, 4>(xn, ring, w, b, y, r0, c0, st0, total, cb, ce, R, K);
    else
      ln_fwd_chunk<D, 2>(xn, ring, w, b, y, r0, c0, st0, total, cb, ce, R, K);
  }
}

template <int D>
__global__ void __launch_bounds__(kLnT, 1)
ln_linear_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                        const float* __restrict__ s, const float* __restrict__ bn,
                        const float* __restrict__ w, float* __restrict__ dx,
                        float* __restrict__ xn_out, float* __restrict__ ln_part, int R, int K,
                        float eps) {
  using T = LnDxTiles<D>;
  constexpr int RG = T::RG, KG = T::KG, TR = kLnR / RG, TC = D / KG;
  constexpr int PX = D + 4, PY = kXJ + 4, SLOT = ln_dx_slot<D>();
  static_assert(RG * KG == kLnT && TC % 4 == 0 && RG * 2 * D <= 2 * SLOT, "tile shape");
  extern __shared__ __align__(16) float sm[];  // 2 slots: [dy (LnR, PY) | W (XJ, PX)]

  const int tid = threadIdx.x, rg = tid / KG, kg = tid % KG;
  const int r0 = blockIdx.x * kLnR, ns = K / kXJ;
  auto issue = [&](int p, float* dst) {
    stage_rows<kLnR, kXJ, PY, kLnT>(dst, dy + p * kXJ, r0, R, K);
    stage_rows<kXJ, D, PX, kLnT>(dst + kLnR * PY, w + (long long)p * kXJ * D, 0, kXJ, D);
  };

  issue(0, sm);
  cp_async_commit();
  float acc[TR][TC];  // dxn of rows rg + RG*i, columns 4kg + 4KG*g + f
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  for (int p = 0; p < ns; ++p) {
    cp_async_wait<0>();
    __syncthreads();  // slice p has landed; slice p - 1 is done
    if (p + 1 < ns) issue(p + 1, sm + ((p + 1) & 1) * SLOT);
    cp_async_commit();
    const float* sl = sm + (p & 1) * SLOT;
    tile_pv<TR, TC, RG, KG, kXJ, PY, PX>(acc, sl, sl + kLnR * PY, rg, kg);
  }
  __syncthreads();  // the ring is free: it takes the column partials

  // LN backward, a row group a row: dx = r (dxh - mean(dxh) - xh mean(dxh xh))
  float psd[TC], psb[TC];  // this thread's column sums of dxn * xh and dxn
#pragma unroll
  for (int c = 0; c < TC; ++c) psd[c] = psb[c] = 0.f;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const long long row = r0 + rg + RG * i;
    float v[TC], sc[TC];
#pragma unroll
    for (int g = 0; g < TC / 4; ++g) {
      const int col = 4 * kg + 4 * KG * g;
      float a[4] = {0.f, 0.f, 0.f, 0.f}, t[4];
      if (row < R) ld4(a, x + row * D + col);
      ld4(t, s + col);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        v[4 * g + f] = a[f];
        sc[4 * g + f] = t[f];
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) sum += v[c];
    const float mu = group_sum<KG>(sum) / D;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const float t = v[c] - mu;
      q += t * t;
    }
    const float rstd = 1.f / sqrtf(group_sum<KG>(q) / D + eps);
    float s_a = 0.f, s_b = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      v[c] = (v[c] - mu) * rstd;  // xh
      const float dxh = acc[i][c] * sc[c];
      s_a += dxh;
      s_b += dxh * v[c];
      // padded rows (x = 0, dy = 0) give dxn = 0: nothing in the partials
      psd[c] += acc[i][c] * v[c];
      psb[c] += acc[i][c];
    }
    const float m1 = group_sum<KG>(s_a) / D, m2 = group_sum<KG>(s_b) / D;
    if (row < R) {
#pragma unroll
      for (int g = 0; g < TC / 4; ++g) {
        const int col = 4 * kg + 4 * KG * g;
        float o[4], xo[4], bb[4];
        ld4(bb, bn + col);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int c = 4 * g + f;
          o[f] = rstd * (acc[i][c] * sc[c] - m1 - v[c] * m2);
          xo[f] = v[c] * sc[c] + bb[f];
        }
        st4(dx + row * D + col, o[0], o[1], o[2], o[3]);
        st4(xn_out + row * D + col, xo[0], xo[1], xo[2], xo[3]);
      }
    }
  }
  float* red = sm;  // (RG, 2D): [dxn * xh | dxn] summed over a row group's rows
#pragma unroll
  for (int g = 0; g < TC / 4; ++g) {
    const int col = 4 * kg + 4 * KG * g;
    st4(red + rg * 2 * D + col, psd[4 * g], psd[4 * g + 1], psd[4 * g + 2], psd[4 * g + 3]);
    st4(red + rg * 2 * D + D + col, psb[4 * g], psb[4 * g + 1], psb[4 * g + 2], psb[4 * g + 3]);
  }
  __syncthreads();
  for (int c = tid; c < 2 * D; c += kLnT) {
    float sum = 0.f;
    for (int r = 0; r < RG; ++r) sum += red[r * 2 * D + c];
    ln_part[(long long)blockIdx.x * 2 * D + c] = sum;
  }
}

// The weight gradients of one row split: blockIdx.x names a (128 x 128) tile
// of dW (K x D) = dy^T xn, blockIdx.y the split; the first column tile also
// sums db = the column sums of dy. Each sum runs over the split's rows in
// order; the split writes [dW | db] to its partial.
__global__ void __launch_bounds__(kLnT, 2)
ln_linear_bwd_w_kernel(const float* __restrict__ xn, const float* __restrict__ dy,
                       float* __restrict__ part, int R, int D, int K, int rows_per_split) {
  const int tn = (D + kGN - 1) / kGN;
  const int m0 = blockIdx.x / tn * kGM, n0 = blockIdx.x % tn * kGN;
  float* out = part + blockIdx.y * ((long long)K * D + K);  // (K, D), then db (K)
  const long long rs0 = (long long)blockIdx.y * rows_per_split;
  const long long rs1 = min((long long)R, rs0 + rows_per_split);
  const int nst = rs1 > rs0 ? (int)((rs1 - rs0 + kGK - 1) / kGK) : 0;

  extern __shared__ __align__(16) float sm[];
  auto slot = [&](int t) { return sm + (t % kGS) * kGK * (kGM + kGN); };  // dy (GK, GM), xn (GK, GN)
  auto issue = [&](int t) {
    const int k0 = (int)rs0 + t * kGK;
    stage_rows<kGK, kGM, kGM, kLnT>(slot(t), dy + m0, k0, (int)rs1, K, K - m0);
    stage_rows<kGK, kGN, kGN, kLnT>(slot(t) + kGK * kGM, xn + n0, k0, (int)rs1, D, D - n0);
  };

  if (nst > 0) issue(0);
  cp_async_commit();
  if (nst > 1) issue(1);
  cp_async_commit();

  const int tid = threadIdx.x, rg = tid >> 4, kg = tid & 15;
  const bool sums = n0 == 0 && tid < kGM;  // this thread sums dy's column m0 + tid
  float acc[8][8];  // rows 4rg + 64a + e, columns 4kg + 64g + f
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float dbs = 0.f;
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<1>();
    __syncthreads();  // slice t has landed; slice t - 1 is done
    if (t + 2 < nst) issue(t + 2);
    cp_async_commit();
    const float* a = slot(t);
#pragma unroll 2  // two rows in flight: within 128 registers, two CTAs an SM
    for (int k = 0; k < kGK; ++k)
      tile_tn<8, 8, 16, 16, 1, kGM, kGN>(acc, a + k * kGM, a + kGK * kGM + k * kGN, rg, kg);
    if (sums)
      for (int k = 0; k < kGK; ++k) dbs += a[k * kGM + tid];
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 4 * rg + 64 * (i / 4) + i % 4;
    if (m >= K) continue;
#pragma unroll
    for (int gq = 0; gq < 2; ++gq) {
      const int n = n0 + 4 * kg + 64 * gq;
      if (n < D)
        st4(out + (long long)m * D + n, acc[i][4 * gq], acc[i][4 * gq + 1], acc[i][4 * gq + 2],
            acc[i][4 * gq + 3]);
    }
  }
  if (sums && m0 + tid < K) out[(long long)K * D + m0 + tid] = dbs;
}

constexpr int kMaxParts = 4;  // CTAs that share a row tile of the forward's last wave, at most

template <int D>
static int launch_ln_fwd(const void* x, const float* s, const float* bn, const void* w,
                         const float* b, void* y, int R, int K, float eps, cudaStream_t stream) {
  const size_t smem = ln_fwd_smem_bytes<D>();
  cudaFuncSetAttribute(ln_linear_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  // one CTA an SM: the tiles past the last whole wave run in parts, as many
  // as the SMs hold, so that the last wave takes a fraction of a tile's time
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (R + kLnR - 1) / kLnR, tail = tiles % sms;
  const int parts = tiles > sms && tail ? min(kMaxParts, sms / tail) : 1;
  const int split_from = parts > 1 ? tiles - tail : tiles;
  ln_linear_fwd_kernel<D><<<split_from + (tiles - split_from) * parts, kLnT, smem, stream>>>(
      static_cast<const float*>(x), s, bn, static_cast<const float*>(w), b,
      static_cast<float*>(y), R, K, split_from, parts, eps);
  return (int)cudaGetLastError();
}

// the dx kernel, then the weight kernel over as many splits (at most
// max_splits) as fill the card's SMs, two CTAs each, in the fullest last
// wave; *splits: the partials written
template <int D>
static int launch_ln_bwd(const void* x, const void* dy, const float* s, const float* bn,
                         const void* w, void* dx, void* xn, float* ln_part, float* part, int R,
                         int K, int max_splits, float eps, int* splits, cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t s_dx = ln_bwd_dx_smem_bytes<D>();
  cudaFuncSetAttribute(ln_linear_bwd_dx_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s_dx);
  cudaFuncSetAttribute(ln_linear_bwd_w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kGSmem);
  ln_linear_bwd_dx_kernel<D><<<(R + kLnR - 1) / kLnR, kLnT, s_dx, stream>>>(
      f(x), f(dy), s, bn, f(w), static_cast<float*>(dx), static_cast<float*>(xn), ln_part, R, K,
      eps);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (K + kGM - 1) / kGM * ((D + kGN - 1) / kGN);
  const int sp = weight_splits(tiles, min(max_splits, (R + kGK - 1) / kGK), 2 * sms);
  const int rps = ((R + sp - 1) / sp + kGK - 1) / kGK * kGK;  // whole slices
  ln_linear_bwd_w_kernel<<<dim3(tiles, sp), kLnT, kGSmem, stream>>>(f(xn), f(dy), part, R, D, K,
                                                                   rps);
  *splits = sp;
  return (int)cudaGetLastError();
}

// bf16 storage takes the wgmma forward of ln_linear_wgmma.cu and the wgmma
// backward of ln_linear_bwd_wgmma.cu
template <int D>
int launch_ln_fwd_wgmma(const void* x, const float* s, const float* bn, const void* w,
                        const float* b, void* y, int R, int K, float eps, cudaStream_t stream);
template <int D>
int launch_ln_bwd_wgmma(const void* x, const void* dy, const float* s, const float* bn,
                        const void* w, void* dx, void* xn, float* ln_part, float* part, int R,
                        int K, int max_splits, float eps, int* splits, cudaStream_t stream);

template <int D>
static int launch_any_ln_bwd(int dtype, const void* x, const void* dy, const float* s,
                             const float* bn, const void* w, void* dx, void* xn, float* ln_part,
                             float* part, int R, int K, int splits, float eps, int* used,
                             cudaStream_t st) {
  if (dtype == kF32)
    return launch_ln_bwd<D>(x, dy, s, bn, w, dx, xn, ln_part, part, R, K, splits, eps, used, st);
  if (dtype == kBF16)
    return launch_ln_bwd_wgmma<D>(x, dy, s, bn, w, dx, xn, ln_part, part, R, K, splits, eps,
                                  used, st);
  return (int)cudaErrorInvalidValue;
}

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
    return launch_ln_fwd_wgmma<384>(x, f(s), f(bn), w, f(b), y, R, K, eps, st);
  if (dtype == kBF16 && D == 192)
    return launch_ln_fwd_wgmma<192>(x, f(s), f(bn), w, f(b), y, R, K, eps, st);
  return (int)cudaErrorInvalidValue;
}

// x, dx (R, D), dy (R, K), w (K, D) in the storage type; s, bn (D) f32.
// Workspaces: xn (R, D) in the storage type (LN(x) from the dx kernel for
// the weight kernel), part (splits, K D + K) and ln_part (ceil(R / 64), 2D)
// in f32. grads (K D + K + 2D) f32 receives [dW (K, D) | db (K) | ds (D) |
// dbb (D)]. Both storage types write as many of the `splits` partials as
// fill the card. D in {192, 384}, K a multiple of 64. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int vitocm_ln_linear_bwd(int dtype, const void* x, const void* dy, const void* s,
                                    const void* bn, const void* w, void* dx, void* xn, void* part,
                                    void* ln_part, void* grads, int R, int D, int K, int splits,
                                    float eps, void* stream) {
  using namespace vitocm;
  if (R < 1 || K < 64 || K % 64 != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fs = static_cast<const float*>(s), *fbn = static_cast<const float*>(bn);
  float *fpart = static_cast<float*>(part), *fln = static_cast<float*>(ln_part);
  int rc = (int)cudaErrorInvalidValue, used = 0;
  if (D == 384)
    rc = launch_any_ln_bwd<384>(dtype, x, dy, fs, fbn, w, dx, xn, fln, fpart, R, K, splits, eps,
                                &used, st);
  else if (D == 192)
    rc = launch_any_ln_bwd<192>(dtype, x, dy, fs, fbn, w, dx, xn, fln, fpart, R, K, splits, eps,
                                &used, st);
  if (rc != 0) return rc;
  const long long W = (long long)K * D + K;
  float* g = static_cast<float*>(grads);
  rc = reduce_splits(fpart, g, used, W, st);
  if (rc != 0) return rc;
  const int tiles = (R + kLnR - 1) / kLnR;
  if (dtype == kBF16) return reduce_rows(fln, g + W, tiles, 2 * D, st);
  return reduce_splits(fln, g + W, tiles, 2LL * D, st);
}
