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
// Forward: attention_qkv.cu's f32 forward (row 5) with P written out. One
// CTA of 256 threads owns 128 query rows and walks the keys in tiles (128 at
// d = 64, 64 at d = 128) with register micro-tiles read as float4
// (ffma_tiles.cuh: 8 x 8 scores and 8 x 4 outputs at d = 64, 8 x 4 and 8 x 8
// at d = 128) and K and V tiles through a three-slot 16-byte cp.async ring.
// The softmax stays in registers and its P tile passes through shared memory
// on its way to P.V, so each tile's P also goes out from there as float4s,
// neighbouring lanes on neighbouring keys (1.05 GB a layer at the MIM shape
// (48, 2305, 128), 0.31 ms of HBM time beside the ~3.7 ms of FFMA work that
// bounds the kernel). The online softmax shifts tile t by the running max
// m_t, not by the row's max m, so with at most d key tiles (N <= 8192) the
// kernel walks the keys once: it keeps each row's m_t in the row's own out
// row until the end (out is written last), then rescales the stored tiles
// whose shift was not the final max, P *= exp(m_t - m) (about half of them
// for random scores), and writes out = o / l and inv = 1 / l from the online
// sum l. Such a P differs from exp(s - m) by an ulp or two, well inside the
// f32 gate against the plain twin (1e-5 of max|twin|), which computes
// exp(s - m) in one step.
// Past d key tiles the same loop runs after a first pass that takes each
// row's max (K tiles only, through the same ring), with the running max
// started there: every tile is then shifted by m and nothing is rescaled.
// Padded keys score -inf, so P's padded columns are exactly 0. bf16 storage
// takes attention_savep_wgmma.cu.
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

constexpr int kPB = 64;    // P's columns are a multiple of this key tile
constexpr int kSfT = 256;  // threads of the forward

// the forward's tiles: query rows a CTA, keys a tile, row groups, lanes a
// row group, ring slots (K_t, V_t, K_t+1 or V_t, K_t+1, V_t+1)
template <int D>
struct SavepFwdTiles {
  static constexpr int BQ = 128, BK = D == 64 ? 128 : 64, RG = 16, KG = 16, SLOTS = 3;
};

template <int D>
constexpr size_t savep_fwd_smem_bytes() {
  using T = SavepFwdTiles<D>;
  return sizeof(float) *
         ((T::BQ + T::SLOTS * T::BK) * (D + 4) + T::BQ * (T::BK + T::KG) + T::BQ);
}

// ONE_PASS (at most D key tiles): the keys once, the stored tiles rescaled
// to the row's max at the end; otherwise a first pass takes the max
template <int D, bool ONE_PASS>
__global__ void __launch_bounds__(kSfT, 1)
attn_fwd_savep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ P, float* __restrict__ inv, int N, int Np) {
  using T = SavepFwdTiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, RG = T::RG, KG = T::KG;
  constexpr int TR = BQ / RG, TK = BK / KG, TC = D / KG;
  constexpr int PQ = D + 4, PP = BK + KG;  // PP: a warp's P stores hit distinct banks
  static_assert(RG * KG == kSfT && TK * KG == BK && TC % 4 == 0 && 32 % KG == 0, "tile shape");
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                          // (BQ, PQ)
  float* ring = Qs + BQ * PQ;              // (SLOTS, BK, PQ)
  float* Ps = ring + T::SLOTS * BK * PQ;   // (BQ, PP)
  float* m_fin = Ps + BQ * PP;             // (BQ): each row's max, for the rescale
  auto slot = [&](int i) { return ring + (i % T::SLOTS) * BK * PQ; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kg = lane % KG, rg = warp * (32 / KG) + lane / KG;
  const int q0 = blockIdx.x * BQ;
  const long long off = (long long)blockIdx.y * N * D;
  q += off; k += off; v += off; out += off;
  P += (long long)blockIdx.y * N * Np;
  inv += (long long)blockIdx.y * N;
  const int tiles = (N + BK - 1) / BK;

  float m_run[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) m_run[i] = -INFINITY;
  stage_rows<BQ, D, PQ, kSfT>(Qs, q, q0, N, D);
  if constexpr (!ONE_PASS) {  // pass 1: each row's max over the valid keys
    stage_rows<BK, D, PQ, kSfT>(slot(0), k, 0, N, D);
    cp_async_commit();
    if (tiles > 1) stage_rows<BK, D, PQ, kSfT>(slot(1), k, BK, N, D);
    cp_async_commit();
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<1>();
      __syncthreads();  // K_t has landed; K_t-1 is consumed
      if (t + 2 < tiles) stage_rows<BK, D, PQ, kSfT>(slot(t + 2), k, (t + 2) * BK, N, D);
      cp_async_commit();
      float s[TR][TK];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
      tile_dot<TR, TK, RG, KG, D, PQ, PQ>(s, Qs, slot(t), rg, kg);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j)
          if (t * BK + kg + KG * j < N) m_run[i] = fmaxf(m_run[i], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) m_run[i] = group_max<KG>(m_run[i]);
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the ring
  }

  stage_rows<BK, D, PQ, kSfT>(slot(0), k, 0, N, D);
  cp_async_commit();
  stage_rows<BK, D, PQ, kSfT>(slot(1), v, 0, N, D);
  cp_async_commit();
  float o[TR][TC], l_run[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) o[i][c] = 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<1>();
    __syncthreads();  // K_t has landed; V_t-1 and P are consumed
    if (t + 1 < tiles) stage_rows<BK, D, PQ, kSfT>(slot(2 * t + 2), k, (t + 1) * BK, N, D);
    cp_async_commit();

    float s[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
    tile_dot<TR, TK, RG, KG, D, PQ, PQ>(s, Qs, slot(2 * t), rg, kg);

    // online softmax of each row over this tile (every tile holds a valid key)
    const int k0 = t * BK;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        if (k0 + kg + KG * j >= N) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], group_max<KG>(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        Ps[(rg + RG * i) * PP + kg + KG * j] = s[i][j];
      }
      const float alpha = expf(m_run[i] - m_new);  // 0 on the first tile of one pass
      l_run[i] = l_run[i] * alpha + group_sum<KG>(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < TC; ++c) o[i][c] *= alpha;
      const int row = q0 + rg + RG * i;
      if (ONE_PASS && kg == 0 && row < N) out[(long long)row * D + t] = m_new;  // tile t's shift
    }
    cp_async_wait<1>();
    __syncthreads();  // V_t has landed; P is written; K_t is consumed
    if (t + 1 < tiles) stage_rows<BK, D, PQ, kSfT>(slot(2 * t + 3), v, (t + 1) * BK, N, D);
    cp_async_commit();
    // the P tile out, keys k0 .. below Np, a float4 a thread a step
    for (int idx = threadIdx.x; idx < BQ * (BK / 4); idx += kSfT) {
      const int r = idx / (BK / 4), c = 4 * (idx % (BK / 4));
      if (q0 + r < N && k0 + c < Np)
        *reinterpret_cast<float4*>(P + (long long)(q0 + r) * Np + k0 + c) =
            *reinterpret_cast<const float4*>(Ps + r * PP + c);
    }
    tile_pv<TR, TC, RG, KG, BK, PP, PQ>(o, Ps, slot(2 * t + 1), rg, kg);
  }

  if constexpr (ONE_PASS) {
    if (kg == 0)
#pragma unroll
      for (int i = 0; i < TR; ++i) m_fin[rg + RG * i] = m_run[i];
    __syncthreads();  // the maxima, every P tile and every shift are written
    // a warp a row: tiles stored with a shift below the row's max, times
    // exp(shift - max); eight float4s a lane in flight at a time
    constexpr int F4 = BK / 4;  // float4s a tile row
    for (int r = warp; r < BQ; r += kSfT / 32) {
      const int row = q0 + r;
      if (row >= N) break;  // rows only grow with r
      const float m = m_fin[r];
      float* prow = P + (long long)row * Np;
      const float* shifts = out + (long long)row * D;
      for (int base = 0; base < tiles * F4; base += 8 * 32) {
        float4 p[8];
        float f[8];
        bool fix[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = base + 32 * u + lane, t = idx / F4, col = t * BK + 4 * (idx % F4);
          fix[u] = idx < tiles * F4 && col < Np && shifts[t] < m;
          if (fix[u]) {
            f[u] = expf(shifts[t] - m);
            p[u] = *reinterpret_cast<const float4*>(prow + col);
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = base + 32 * u + lane, col = (idx / F4) * BK + 4 * (idx % F4);
          if (fix[u])
            *reinterpret_cast<float4*>(prow + col) =
                make_float4(p[u].x * f[u], p[u].y * f[u], p[u].z * f[u], p[u].w * f[u]);
        }
      }
    }
    __syncthreads();  // every shift is read before out overwrites them
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + rg + RG * i;
    if (row >= N) continue;
    const float l = l_run[i];  // >= 1: the max term is exp(0)
    float* orow = out + (long long)row * D + 4 * kg;
#pragma unroll
    for (int g = 0; g < TC / 4; ++g)
      st4(orow + 4 * KG * g, o[i][4 * g] / l, o[i][4 * g + 1] / l, o[i][4 * g + 2] / l,
          o[i][4 * g + 3] / l);
    if (kg == 0) inv[row] = 1.f / l;
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
  using T = SavepFwdTiles<D>;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t smem = savep_fwd_smem_bytes<D>();
  // the row's shifts live in its out row (D floats) until the rescale
  auto kern = (N + T::BK - 1) / T::BK <= D ? attn_fwd_savep_kernel<D, true>
                                            : attn_fwd_savep_kernel<D, false>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<dim3((N + T::BQ - 1) / T::BQ, BH), kSfT, smem, stream>>>(
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

// bf16 storage takes the wgmma forward of attention_savep_wgmma.cu and the
// wgmma backward of attention_savep_bwd_wgmma.cu (stats read through TMA)
template <int D>
int launch_fwd_savep_wgmma(const void* qs, const void* k, const void* v, void* out, void* P,
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
    return launch_fwd_savep_wgmma<64>(qs, k, v, out, P, fi, BH, N, Np, s);
  if (dtype == kBF16 && head_dim == 128)
    return launch_fwd_savep_wgmma<128>(qs, k, v, out, P, fi, BH, N, Np, s);
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
