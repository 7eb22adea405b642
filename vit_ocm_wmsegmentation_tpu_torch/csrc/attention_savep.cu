// Attention on the saved-P route (TRAIN.ATTN_SAVE_P on), f32 storage, CUDA
// cores; the C entry points for both storage types.
//
// Replaces two pieces of vit_ocm_wmsegmentation_tpu/ops/flash_attention.py:
//   * _attn_fwd_kernel's P output (_flash_fwd with want_p): besides out, the
//     forward writes P = round(exp(s - m)), the scores shifted by the TRUE
//     row max m, and inv = 1 / sum(P), so that e = P * inv is the softmax;
//   * _attn_bwd_savep_kernel (_flash_bwd_savep_impl): the backward reads P
//     and inv instead of recomputing exp(s - lse).
// Folded (B*h, N, d) layout; qs = q * d^-0.5 rounded to the storage type by
// the wrapper; P (B*h, N, Np) with Np = N rounded up to the 64-key tile, its
// padded columns exactly 0; inv (B*h, N) f32.
//
// Forward. The online softmax of attention_qkv.cu cannot write P as it goes:
// its running max changes from key tile to key tile. So one CTA (64 query
// rows, 256 threads, a 4 x 4 score block and a 4 x d/16 output block each)
// walks the keys twice: pass 1 computes s tile by tile and keeps each row's
// max (padded keys masked); pass 2 recomputes s, writes P = exp(s - m) (the
// rounding to the storage type is the identity in f32), accumulates o += P V
// and the row sum of P, then writes o / sum and inv = 1 / sum. 1.5x the
// FLOPs of the lse route's forward plus the write of P: 1.02 GB a layer at
// the MIM shape (48, 2305, 128), 0.30 ms of HBM time against the ~8 ms the
// f32 products take on the CUDA cores, so the FMA issue bounds it.
//
// Backward. The lse route's deterministic split with no atomics
// (attention_bwd.cu): the row statistics once (inv and D = rowsum(do * o),
// rows padded to 4 floats), one CTA per 64 keys owning dk/dv rows, one CTA
// per 128 queries owning dq rows. The s-recompute product and the exp are
// gone: each CTA stages the P tile it needs and forms e = P * inv. The dk/dv
// kernel needs no K, the dq kernel no Q. e, ds = e (do v^T - D), dv = e^T
// do, dk = ds^T qs, dq = ds k * d^-0.5; 10 N^2 d flops and, per kernel, one
// read of P (1.05 GB a layer at the MIM shape, 0.31 ms of HBM time against
// 4.9 ms of FFMA at the peak). Exact f32 on the CUDA cores (FFMA, no TF32,
// no tensor-core instruction) from ffma_tiles.cuh, as the lse route's
// backward is, and bound as it is by shared memory to registers (32 floats
// a cycle an SM against 128 FFMA): every product takes the largest
// micro-tile the registers and shared memory allow, fed by a two-stage
// 16-byte cp.async ring that carries the P tiles too (every P row is 16-byte
// aligned: Np is a multiple of 64).
//   * dk/dv: V of the CTA's 64 keys resident (pitch d + 4); 64-query tiles
//     of Q, dO, P (64 x 64) and the inv and D rows through the ring. With S
//     gone, all 256 threads share the one score product, dP^T = V dO^T, in
//     4 x 4 micro-tiles; each thread reads P at its own (query, key)
//     positions, writes e = P * inv over it and ds = e (dP - D) into a
//     buffer beside it, both query-major, so that the gradient products
//     read them k-major (tile_tn): the first half dV += e^T dO, the second
//     dK += ds^T Q, 8 x d/16 a thread (8 x 8 at d = 128). 217 KB (d = 128)
//     or 137 KB (d = 64) of shared memory; two barriers a tile;
//   * dq: dO of 128 queries resident, K, V and the (128 x BK) P tile through
//     the ring (BK = 64 at d = 64, 32 at d = 128); all threads compute dP =
//     dO V^T (8 x 4 or 4 x 4 micro-tiles) and write ds in place of P, then
//     accumulate dq += ds K, 8 x d/16 a thread. 170 KB or 168 KB; two
//     barriers a tile.
// Padded queries and keys hold P = 0; the statistics past N are masked
// (their rows' padding is not 0). bf16 storage takes
// attention_savep_bwd_wgmma.cu.

#include <math.h>

#include "common.cuh"
#include "ffma_tiles.cuh"

namespace vitocm {

constexpr int kPB = 64;   // query rows (forward, dq) or keys (dk/dv) per CTA, and per tile
constexpr int kPT = 256;  // threads
constexpr int kPS = kPB + 1;

template <int D>
constexpr size_t savep_fwd_smem_bytes() {
  return sizeof(float) * (kPB * (D + 1) * 2 + kPB * D + kPB * kPS);
}

// rows r0.. of one (N, D) slice into shared memory (pitch P), zeros past N
template <int D, int P>
__device__ __forceinline__ void savep_rows(float* dst, const float* src, int r0, int N) {
  for (int i = threadIdx.x; i < kPB * D; i += kPT) {
    const int r = i / D, c = i % D;
    dst[r * P + c] = r0 + r < N ? src[(long long)(r0 + r) * D + c] : 0.f;
  }
}

// s = Q K^T for rows tr + 16i of Qs and rows tc + 16j of Ks (pitch D + 1)
template <int D>
__device__ __forceinline__ void savep_scores(float (&s)[4][4], const float* Qs, const float* Ks,
                                             int tr, int tc) {
  constexpr int PQ = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < D; ++kk) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * PQ + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * PQ + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
}

// the 16 threads of a row group (tid / 16) hold a row's partial results
__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(kPT)
attn_fwd_savep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ P, float* __restrict__ inv, int N, int Np) {
  constexpr int PQ = D + 1, OJ = D / 16;
  extern __shared__ float sm[];
  float* Qs = sm;                  // (PB, PQ)
  float* Ks = Qs + kPB * PQ;       // (PB, PQ)
  float* Vs = Ks + kPB * PQ;       // (PB, D)
  float* Ps = Vs + kPB * D;        // (PB, PS)

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int q0 = blockIdx.x * kPB;
  const long long off = (long long)blockIdx.y * N * D;
  q += off; k += off; v += off; out += off;
  P += (long long)blockIdx.y * N * Np;
  inv += (long long)blockIdx.y * N;

  savep_rows<D, PQ>(Qs, q, q0, N);
  float s[4][4];

  // pass 1: the row max over every valid key
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < N; k0 += kPB) {
    __syncthreads();  // Qs written / the previous K tile consumed
    savep_rows<D, PQ>(Ks, k, k0, N);
    __syncthreads();
    savep_scores<D>(s, Qs, Ks, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tc + 16 * j < N) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = row16_max(m[i]);

  // pass 2: P = exp(s - m), written out; o += P V, l += P
  float o[4][OJ], l[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) o[i][j] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kPB) {
    __syncthreads();  // the previous K, V and P tiles are consumed
    for (int i = tid; i < kPB * D; i += kPT) {
      const int r = i / D, c = i % D, row = k0 + r;
      const bool ok = row < N;
      Ks[r * PQ + c] = ok ? k[(long long)row * D + c] : 0.f;
      Vs[r * D + c] = ok ? v[(long long)row * D + c] : 0.f;
    }
    __syncthreads();
    savep_scores<D>(s, Qs, Ks, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tc + 16 * j;
        const float p = k0 + col < N ? expf(s[i][j] - m[i]) : 0.f;
        l[i] += p;
        Ps[r * kPS + col] = p;
        if (row < N) P[(long long)row * Np + k0 + col] = p;  // k0 + col < Np
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kPB; ++kk) {
      float pv[4], vv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * kPS + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) vv[j] = Vs[kk * D + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sum = row16_sum(l[i]);  // >= 1: the max term is exp(0)
    const int row = q0 + tr + 16 * i;
    if (row >= N) continue;
    if (tc == 0) inv[row] = 1.f / sum;
#pragma unroll
    for (int j = 0; j < OJ; ++j) out[(long long)row * D + tc + 16 * j] = o[i][j] / sum;
  }
}

// ---- backward ---------------------------------------------------------------
constexpr int kSpT = 256;  // threads of both backward kernels
constexpr int kSpStages = 2;

// dk/dv: BKV keys a CTA, BQ queries a tile. dP^T over all the threads in
// 4 x 4 micro-tiles (RGS key groups x KGS query lanes); per half, the
// gradient micro-tiles: TRG keys (float4 groups) x TCG columns
template <int D>
struct SavepKvTiles {
  static constexpr int BKV = 64, BQ = 64, RGS = 16, KGS = 16, TRG = 8, TCG = D == 128 ? 8 : 4;
  static constexpr int RGG = BKV / TRG, KGG = D / TCG;
};

template <int D>
constexpr size_t savep_dkdv_smem_bytes() {
  using T = SavepKvTiles<D>;
  return sizeof(float) * ((T::BKV + 2 * kSpStages * T::BQ) * (D + 4) +
                          (kSpStages + 1) * T::BQ * (T::BKV + 4) + 2 * kSpStages * T::BQ);
}

// dq: BQ queries a CTA, BK keys a tile. dP over all the threads in TRS x TKS
// micro-tiles (RGS query groups x KGS key lanes); dq over all the threads,
// 8 x D/16 a thread (RGG x KGG)
template <int D>
struct SavepDqTiles {
  static constexpr int BQ = 128, BK = D == 64 ? 64 : 32, TRS = D == 64 ? 8 : 4, TKS = 4;
  static constexpr int RGS = BQ / TRS, KGS = BK / TKS, RGG = 16, KGG = 16;
};

template <int D>
constexpr size_t savep_dq_smem_bytes() {
  using T = SavepDqTiles<D>;
  return sizeof(float) * ((T::BQ + 2 * kSpStages * T::BK) * (D + 4) +
                          kSpStages * T::BQ * (T::BK + 4));
}

// One CTA a (batch*head, 64 keys). All threads compute dP^T = V dO^T, read
// P at their (query, key) positions of the staged tile, and write e = P *
// inv over it and ds = e (dP - D) beside it, both query-major; then the
// first half accumulates dV += e^T dO and the second dK += ds^T Q.
template <int D>
__global__ void __launch_bounds__(kSpT, 1)
attn_bwd_savep_dkdv_kernel(const float* __restrict__ qs, const float* __restrict__ v,
                           const float* __restrict__ P, const float* __restrict__ stats,
                           const float* __restrict__ dout, float* __restrict__ dk,
                           float* __restrict__ dv, int N, int Np, int pitch) {
  using T = SavepKvTiles<D>;
  constexpr int BKV = T::BKV, BQ = T::BQ, RGS = T::RGS, KGS = T::KGS, TRG = T::TRG, TCG = T::TCG;
  constexpr int RGG = T::RGG, KGG = T::KGG, TRS = BKV / RGS, TKS = BQ / KGS;
  constexpr int PQ = D + 4, PP = BKV + 4;
  static_assert(RGS * KGS == kSpT && RGG * KGG == kSpT / 2 && TRS * RGS == BKV &&
                TKS * KGS == BQ && 4 * RGG * (TRG / 4) == BKV && 4 * KGG * (TCG / 4) == D,
                "tile shape");
  extern __shared__ __align__(16) float sm[];
  float* Vs = sm;                           // (BKV keys, PQ)
  float* Qs = Vs + BKV * PQ;                // (stages, BQ queries, PQ)
  float* dOs = Qs + kSpStages * BQ * PQ;
  float* Ps = dOs + kSpStages * BQ * PQ;    // (stages, BQ queries, PP): P, then e in place
  float* dSs = Ps + kSpStages * BQ * PP;    // (BQ queries, PP): ds
  float* inv_s = dSs + BQ * PP;             // (stages, BQ)
  float* dd_s = inv_s + kSpStages * BQ;

  const int tid = threadIdx.x, half = tid >> 7, ht = tid & 127;
  const int rgs = tid / KGS, kgs = tid % KGS, rgg = ht / KGG, kgg = ht % KGG;
  const int k0 = blockIdx.x * BKV;
  const long long off = (long long)blockIdx.y * N * D;
  qs += off; v += off; dout += off; dk += off; dv += off;
  P += (long long)blockIdx.y * N * Np + k0;  // this CTA's key columns
  stats += (long long)blockIdx.y * 2 * pitch;
  const int tiles = (N + BQ - 1) / BQ;

  auto stage_tile = [&](int slot, int q1) {
    stage_rows<BQ, D, PQ, kSpT>(Qs + slot * BQ * PQ, qs, q1, N, D);
    stage_rows<BQ, D, PQ, kSpT>(dOs + slot * BQ * PQ, dout, q1, N, D);
    stage_rows<BQ, BKV, PP, kSpT>(Ps + slot * BQ * PP, P, q1, N, Np);
    stage_stats<BQ, kSpT>(inv_s + slot * BQ, dd_s + slot * BQ, stats, q1, N, pitch);
  };
  stage_rows<BKV, D, PQ, kSpT>(Vs, v, k0, N, D);
  stage_tile(0, 0);
  cp_async_commit();

  // first half dv, second half dk: keys 4*rgg + 4*RGG*a + e, float4 column
  // groups 4*kgg + 4*KGG*g
  float g[TRG][TCG];
#pragma unroll
  for (int i = 0; i < TRG; ++i)
#pragma unroll
    for (int c = 0; c < TCG; ++c) g[i][c] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // q tile t has landed; tile t - 1, its e and ds are consumed
    if (t + 1 < tiles) stage_tile((t + 1) % kSpStages, (t + 1) * BQ);
    cp_async_commit();
    const int st = t % kSpStages, q0 = t * BQ;
    const float* Qt = Qs + st * BQ * PQ;
    const float* dOt = dOs + st * BQ * PQ;
    float* Et = Ps + st * BQ * PP;
    const float* it = inv_s + st * BQ;
    const float* dt = dd_s + st * BQ;

    // dp^T for keys rgs + RGS*i, queries kgs + KGS*j
    float a[TRS][TKS];
#pragma unroll
    for (int i = 0; i < TRS; ++i)
#pragma unroll
      for (int j = 0; j < TKS; ++j) a[i][j] = 0.f;
    tile_dot<TRS, TKS, RGS, KGS, D, PQ, PQ>(a, Vs, dOt, rgs, kgs);
    // queries past N: the statistics' padding is not 0, so mask them
#pragma unroll
    for (int j = 0; j < TKS; ++j) {
      const int qc = kgs + KGS * j;
      const bool ok = q0 + qc < N;
      const float iv = it[qc], dd = dt[qc];
#pragma unroll
      for (int i = 0; i < TRS; ++i) {
        const int at = qc * PP + rgs + RGS * i;
        const float e = ok ? Et[at] * iv : 0.f;
        Et[at] = e;
        dSs[at] = ok ? e * (a[i][j] - dd) : 0.f;
      }
    }
    __syncthreads();  // e and ds are written
    tile_tn<TRG, TCG, RGG, KGG, BQ, PP, PQ>(g, half ? dSs : Et, half ? Qt : dOt, rgg, kgg);
  }

  float* dst = half ? dk : dv;
#pragma unroll
  for (int a = 0; a < TRG / 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 4 * rgg + 4 * RGG * a + e;
      if (key >= N) continue;
      const float* r = g[4 * a + e];
#pragma unroll
      for (int c = 0; c < TCG / 4; ++c)
        st4(dst + (long long)key * D + 4 * kgg + 4 * KGG * c, r[4 * c], r[4 * c + 1],
            r[4 * c + 2], r[4 * c + 3]);
    }
}

// One CTA a (batch*head, 128 queries). All threads compute dP = dO V^T and
// write ds = P * inv * (dP - D) over the staged P tile; then all accumulate
// dq += ds K.
template <int D>
__global__ void __launch_bounds__(kSpT, 1)
attn_bwd_savep_dq_kernel(const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ P, const float* __restrict__ stats,
                         const float* __restrict__ dout, float* __restrict__ dq, int N, int Np,
                         int pitch, float scale) {
  using T = SavepDqTiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, TRS = T::TRS, TKS = T::TKS, RGS = T::RGS, KGS = T::KGS;
  constexpr int RGG = T::RGG, KGG = T::KGG, TRG = BQ / RGG, TCG = D / KGG;
  constexpr int PQ = D + 4, PP = BK + 4;
  static_assert(RGS * KGS == kSpT && RGG * KGG == kSpT && TRG * RGG == BQ && TCG % 4 == 0,
                "tile shape");
  extern __shared__ __align__(16) float sm[];
  float* dOs = sm;                         // (BQ queries, PQ)
  float* Ks = dOs + BQ * PQ;               // (stages, BK keys, PQ)
  float* Vs = Ks + kSpStages * BK * PQ;
  float* Ps = Vs + kSpStages * BK * PQ;    // (stages, BQ queries, PP): P, then ds in place

  const int tid = threadIdx.x;
  const int rgs = tid / KGS, kgs = tid % KGS, rgg = tid / KGG, kgg = tid % KGG;
  const int q0 = blockIdx.x * BQ;
  const long long off = (long long)blockIdx.y * N * D;
  k += off; v += off; dout += off; dq += off;
  P += (long long)blockIdx.y * N * Np;
  stats += (long long)blockIdx.y * 2 * pitch;
  const int tiles = (N + BK - 1) / BK;

  auto stage_tile = [&](int slot, int k1) {
    stage_rows<BK, D, PQ, kSpT>(Ks + slot * BK * PQ, k, k1, N, D);
    stage_rows<BK, D, PQ, kSpT>(Vs + slot * BK * PQ, v, k1, N, D);
    stage_rows<BQ, BK, PP, kSpT>(Ps + slot * BQ * PP, P + k1, q0, N, Np);
  };
  stage_rows<BQ, D, PQ, kSpT>(dOs, dout, q0, N, D);
  stage_tile(0, 0);
  cp_async_commit();

  // inv and D of queries rgs + RGS*i (0 past N, where P is 0 too)
  float ri[TRS], rd[TRS];
#pragma unroll
  for (int i = 0; i < TRS; ++i) {
    const int row = q0 + rgs + RGS * i;
    ri[i] = row < N ? stats[row] : 0.f;
    rd[i] = row < N ? stats[pitch + row] : 0.f;
  }
  float gq[TRG][TCG];  // queries rgg + RGG*i, float4 column groups 4*kgg + 4*KGG*c
#pragma unroll
  for (int i = 0; i < TRG; ++i)
#pragma unroll
    for (int c = 0; c < TCG; ++c) gq[i][c] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // key tile t has landed; tile t - 1 and its ds are consumed
    if (t + 1 < tiles) stage_tile((t + 1) % kSpStages, (t + 1) * BK);
    cp_async_commit();
    const int st = t % kSpStages;
    const float* Kt = Ks + st * BK * PQ;
    const float* Vt = Vs + st * BK * PQ;
    float* Et = Ps + st * BQ * PP;

    // dp for queries rgs + RGS*i, keys kgs + KGS*j
    float a[TRS][TKS];
#pragma unroll
    for (int i = 0; i < TRS; ++i)
#pragma unroll
      for (int j = 0; j < TKS; ++j) a[i][j] = 0.f;
    tile_dot<TRS, TKS, RGS, KGS, D, PQ, PQ>(a, dOs, Vt, rgs, kgs);
#pragma unroll
    for (int i = 0; i < TRS; ++i)
#pragma unroll
      for (int j = 0; j < TKS; ++j) {
        const int at = (rgs + RGS * i) * PP + kgs + KGS * j;
        const float e = Et[at] * ri[i];
        Et[at] = e * (a[i][j] - rd[i]);
      }
    __syncthreads();  // ds is written
    tile_pv<TRG, TCG, RGG, KGG, BK, PP, PQ>(gq, Et, Kt, rgg, kgg);
  }

#pragma unroll
  for (int i = 0; i < TRG; ++i) {
    const int row = q0 + rgg + RGG * i;
    if (row >= N) continue;
    float* d = dq + (long long)row * D + 4 * kgg;
#pragma unroll
    for (int c = 0; c < TCG / 4; ++c)
      st4(d + 4 * KGG * c, gq[i][4 * c] * scale, gq[i][4 * c + 1] * scale,
          gq[i][4 * c + 2] * scale, gq[i][4 * c + 3] * scale);
  }
}

template <int D>
static int launch_fwd_savep(const void* qs, const void* k, const void* v, void* out, void* P,
                            float* inv, int BH, int N, int Np, cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t smem = savep_fwd_smem_bytes<D>();
  cudaFuncSetAttribute(attn_fwd_savep_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  attn_fwd_savep_kernel<D><<<dim3((N + kPB - 1) / kPB, BH), kPT, smem, stream>>>(
      f(qs), f(k), f(v), static_cast<float*>(out), static_cast<float*>(P), inv, N, Np);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_bwd_savep(const void* qs, const void* k, const void* v, const void* P,
                            const float* stats, int pitch, const void* dout, void* dq, void* dk,
                            void* dv, int BH, int N, int Np, cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t s1 = savep_dkdv_smem_bytes<D>(), s2 = savep_dq_smem_bytes<D>();
  cudaFuncSetAttribute(attn_bwd_savep_dkdv_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  cudaFuncSetAttribute(attn_bwd_savep_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s2);
  const dim3 g1((N + SavepKvTiles<D>::BKV - 1) / SavepKvTiles<D>::BKV, BH);
  attn_bwd_savep_dkdv_kernel<D><<<g1, kSpT, s1, stream>>>(
      f(qs), f(v), f(P), stats, f(dout), static_cast<float*>(dk), static_cast<float*>(dv), N,
      Np, pitch);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 g2((N + SavepDqTiles<D>::BQ - 1) / SavepDqTiles<D>::BQ, BH);
  attn_bwd_savep_dq_kernel<D><<<g2, kSpT, s2, stream>>>(
      f(k), f(v), f(P), stats, f(dout), static_cast<float*>(dq), N, Np, pitch,
      1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// bf16 storage takes the tensor-core forward of attention_savep_mma.cu and
// the wgmma backward of attention_savep_bwd_wgmma.cu (stats read through TMA)
template <int D>
int launch_fwd_savep_mma(const void* qs, const void* k, const void* v, void* out, void* P,
                         float* inv, int BH, int N, int Np, cudaStream_t stream);
template <int D>
int launch_bwd_savep_wgmma(const void* qs, const void* k, const void* v, const void* P,
                           const float* stats, int pitch, const void* dout, void* dq, void* dk,
                           void* dv, int BH, int N, int Np, cudaStream_t stream);

}  // namespace vitocm

// qs (already scaled), k, v, out (BH, N, d) contiguous in the storage type;
// P (BH, N, Np) in the storage type, Np a multiple of 64 and >= N; inv (BH,
// N) f32. d in {64, 128}. Returns cudaGetLastError() after the launch.
extern "C" int vitocm_flash_fwd_savep(int dtype, const void* qs, const void* k, const void* v,
                                      void* out, void* P, void* inv, int BH, int N, int Np,
                                      int head_dim, void* stream) {
  using namespace vitocm;
  if (BH < 1 || N < 1 || Np < N || Np % kPB != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fi = static_cast<float*>(inv);
  if (dtype == kF32 && head_dim == 64)
    return launch_fwd_savep<64>(qs, k, v, out, P, fi, BH, N, Np, s);
  if (dtype == kF32 && head_dim == 128)
    return launch_fwd_savep<128>(qs, k, v, out, P, fi, BH, N, Np, s);
  if (dtype == kBF16 && head_dim == 64)
    return launch_fwd_savep_mma<64>(qs, k, v, out, P, fi, BH, N, Np, s);
  if (dtype == kBF16 && head_dim == 128)
    return launch_fwd_savep_mma<128>(qs, k, v, out, P, fi, BH, N, Np, s);
  return (int)cudaErrorInvalidValue;
}

// qs, k, v, o, dout, dq, dk, dv (BH, N, d) contiguous in the storage type;
// P (BH, N, Np) and inv (BH, N) as the forward wrote them; stats an f32
// workspace of 2 * BH * round_up(N, 4) values. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int vitocm_flash_bwd_savep(int dtype, const void* qs, const void* k, const void* v,
                                      const void* o, const void* P, const void* inv,
                                      const void* dout, void* dq, void* dk, void* dv, void* stats,
                                      int BH, int N, int Np, int head_dim, void* stream) {
  using namespace vitocm;
  if (BH < 1 || N < 1 || Np < N || Np % kPB != 0 || (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  const int pitch = (N + 3) / 4 * 4;  // 16-byte rows for cp.async and TMA
  int rc = attn_row_stats(dtype, head_dim, static_cast<const float*>(inv), dout, o, st, BH, N,
                          pitch, s);
  if (rc != 0) return rc;
  if (dtype == kF32 && head_dim == 64)
    return launch_bwd_savep<64>(qs, k, v, P, st, pitch, dout, dq, dk, dv, BH, N, Np, s);
  if (dtype == kF32 && head_dim == 128)
    return launch_bwd_savep<128>(qs, k, v, P, st, pitch, dout, dq, dk, dv, BH, N, Np, s);
  if (head_dim == 64)
    return launch_bwd_savep_wgmma<64>(qs, k, v, P, st, pitch, dout, dq, dk, dv, BH, N, Np, s);
  return launch_bwd_savep_wgmma<128>(qs, k, v, P, st, pitch, dout, dq, dk, dv, BH, N, Np, s);
}
