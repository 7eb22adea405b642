// Attention backward from the saved logsumexp, f32 storage, CUDA cores.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/flash_attention.py::
// _attn_bwd_kernel (_flash_bwd_impl, the backward of
// flash_attention_trainable). Inputs in the folded (B*h, N, d) layout:
// qs = q * d^-0.5 rounded to the storage type (as the forward saw it), k,
// v, the forward's out o, its f32 lse (B*h, N), and the cotangent do.
// Outputs dq (with respect to the unscaled q), dk, dv in the same layout.
// With e = exp(qs k^T - lse), D = rowsum(do * o):
//   dv = round(e)^T do,  ds = round(e * (do v^T - D)),
//   dk = ds^T qs,        dq = round(round(ds k) * d^-0.5).
//
// What changes on Hopper: the TPU kernel holds all of K and V for one
// q block and carries dk/dv across q blocks in a sequential grid axis.
// Here blocks run in no order, so the work splits into two deterministic
// kernels that both recompute e = exp(s - lse) in f32, with no atomics:
// one CTA per 64 keys walks every q tile and owns its dk/dv rows; one CTA
// per 128 queries walks every key tile and owns its dq rows (14 N^2 d
// flops against the 10 of the work: the price of a deterministic dq). D
// and the guarded lse are computed once per row by a small kernel ahead of
// both (attn_row_stats), in rows padded to 4 floats so that they too come
// in 16-byte copies. Exact f32 on the CUDA cores (FFMA, no TF32, no
// tensor-core instruction), built from ffma_tiles.cuh as the forward
// (attention_qkv.cu) is, and bound as it is by the path from shared memory
// to registers (32 floats a cycle an SM against 128 FFMA), so each product
// gets the largest micro-tile the registers hold: the two halves of the
// 256 threads take the two score products, S and dP, side by side, each
// with twice the micro-tile one thread taking both would have.
//   * dk/dv: K and V of the CTA's 64 keys resident (pitch d + 4); q tiles
//     (64 queries at d = 64, 32 at d = 128), their dO and their lse and D
//     rows through a two-stage cp.async ring. The first half computes S^T
//     and e, the second dP^T and ds = e (dP - D), 4 x TK register
//     micro-tiles; e and ds go to shared memory once, keys by rows, in the
//     rows the gradient micro-tiles read as float4; then the first half
//     accumulates dV += e^T dO and the second dK += ds^T Q, 8 x d/16 a
//     thread, in registers. 139 KB (d = 64) or 153 KB (d = 128) of shared
//     memory, one CTA an SM; three barriers a tile, the last one the second
//     half's alone;
//   * dq: Q and dO of 128 queries resident, K and V tiles (64 keys at d =
//     64, 32 at d = 128) through the ring; the first half computes S and e
//     (8 x TK a thread), the second dP and then ds in place of e; all 256
//     threads accumulate dq += ds K, 8 x d/16 a thread. 172 KB or 218 KB;
//     three barriers a tile.
// bf16 storage takes attention_bwd_wgmma.cu.
//
// Numerics: as the TPU kernel, whose rounding of e and ds to the storage
// type is the identity in f32; expf; dk and dv accumulate over all q in
// f32 and are written once (at the MIM shape the TPU kernel runs one q
// block, so it too rounds once); every sum runs in a fixed order, so two
// calls give the same bits. Padded q rows and keys are masked in the
// kernels, and a non-finite lse counts as 0, as nan_to_num does in
// _flash_bwd_impl.

#include <math.h>

#include "common.cuh"
#include "ffma_tiles.cuh"

namespace vitocm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// stats of every (batch*head, row), one warp a row: [lse as the kernels use
// it, non-finite values as 0 (nan_to_num in _flash_bwd_impl) | D = rowsum(do
// * o) in f32], each (BH, N) -> stats (BH, 2, pitch). Computed once here
// instead of in every CTA that reads the row.
template <typename T, int D>
__global__ void __launch_bounds__(256)
attn_bwd_stats_kernel(const float* __restrict__ lse, const T* __restrict__ dout,
                      const T* __restrict__ o, float* __restrict__ stats, int BH, int N,
                      int pitch) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)BH * N) return;
  float s = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) s += to_f32(dout[row * D + c]) * to_f32(o[row * D + c]);
  s = warp_sum(s);
  if (lane == 0) {
    const long long bh = row / N, r = row % N;
    const float l = lse[row];
    stats[bh * 2 * pitch + r] = isfinite(l) ? l : 0.f;
    stats[bh * 2 * pitch + pitch + r] = s;
  }
}

template <typename T, int D>
static int launch_attn_bwd_stats(const float* lse, const void* dout, const void* o, float* stats,
                                 int BH, int N, int pitch, cudaStream_t stream) {
  const long long rows = (long long)BH * N;
  attn_bwd_stats_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      lse, static_cast<const T*>(dout), static_cast<const T*>(o), stats, BH, N, pitch);
  return (int)cudaGetLastError();
}

int attn_row_stats(int dtype, int d, const float* row, const void* dout, const void* o,
                   float* stats, int BH, int N, int pitch, cudaStream_t s) {
  if (dtype == kF32 && d == 64)
    return launch_attn_bwd_stats<float, 64>(row, dout, o, stats, BH, N, pitch, s);
  if (dtype == kF32 && d == 128)
    return launch_attn_bwd_stats<float, 128>(row, dout, o, stats, BH, N, pitch, s);
  if (dtype == kBF16 && d == 64)
    return launch_attn_bwd_stats<__nv_bfloat16, 64>(row, dout, o, stats, BH, N, pitch, s);
  if (dtype == kBF16 && d == 128)
    return launch_attn_bwd_stats<__nv_bfloat16, 128>(row, dout, o, stats, BH, N, pitch, s);
  return (int)cudaErrorInvalidValue;
}

constexpr int kBT = 256;     // threads of both kernels: two halves of 128
constexpr int kBStages = 2;

// A half (128 threads) as RG row groups of KG lanes: this thread's group
// and lane, from its index in the half
template <int KG>
__device__ __forceinline__ int half_group(int t) { return (t >> 5) * (32 / KG) + (t & 31) / KG; }

// dk/dv: keys a CTA, queries a tile; per half, the score micro-tiles (rows
// = keys, RGS x KGS) and the gradient micro-tiles (rows = keys, RGG x KGG)
template <int D>
struct DkdvTiles {
  static constexpr int BKV = 64, BQ = D == 64 ? 64 : 32, RGS = 16, KGS = 8, RGG = 8, KGG = 16;
};

template <int D>
constexpr size_t bwd_dkdv_f32_smem_bytes() {
  using T = DkdvTiles<D>;
  return sizeof(float) * ((2 * T::BKV + 2 * kBStages * T::BQ) * (D + 4) +
                          2 * T::BKV * (T::BQ + T::KGS) + 2 * kBStages * T::BQ);
}

// dq: queries a CTA, keys a tile; per half the score micro-tiles (rows =
// queries, RGS x KGS), over all 256 threads the dq micro-tiles (RGG x KGG)
template <int D>
struct DqTiles {
  static constexpr int BQ = 128, BK = D == 64 ? 64 : 32, RGS = 16, KGS = 8, RGG = 16, KGG = 16;
};

template <int D>
constexpr size_t bwd_dq_f32_smem_bytes() {
  using T = DqTiles<D>;
  return sizeof(float) * ((2 * T::BQ + 2 * kBStages * T::BK) * (D + 4) + T::BQ * (T::BK + T::KGS));
}

// One CTA a (batch*head, 64 keys). The first half of the threads computes
// S^T = K Q^T and e, the second dP^T = V dO^T and ds = e (dP - D); then
// the first accumulates dV += e^T dO and the second dK += ds^T Q.
template <int D>
__global__ void __launch_bounds__(kBT, 1)
attn_bwd_dkdv_f32_kernel(const float* __restrict__ qs, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ stats,
                         const float* __restrict__ dout, float* __restrict__ dk,
                         float* __restrict__ dv, int N, int pitch) {
  using T = DkdvTiles<D>;
  constexpr int BKV = T::BKV, BQ = T::BQ, RGS = T::RGS, KGS = T::KGS, RGG = T::RGG, KGG = T::KGG;
  constexpr int TRS = BKV / RGS, TKS = BQ / KGS, TRG = BKV / RGG, TCG = D / KGG;
  constexpr int PQ = D + 4, PE = BQ + KGS;  // PE: a warp's e/ds stores hit distinct banks
  static_assert(RGS * KGS == kBT / 2 && RGG * KGG == kBT / 2 && TRS * RGS == BKV &&
                TKS * KGS == BQ && TRG * RGG == BKV && TCG % 4 == 0, "tile shape");
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;                        // (BKV keys, PQ)
  float* Vs = Ks + BKV * PQ;
  float* Qs = Vs + BKV * PQ;             // (stages, BQ queries, PQ)
  float* dOs = Qs + kBStages * BQ * PQ;
  float* Es = dOs + kBStages * BQ * PQ;  // (BKV keys, PE): e
  float* dSs = Es + BKV * PE;            // (BKV keys, PE): ds
  float* lse_s = dSs + BKV * PE;         // (stages, BQ)
  float* dd_s = lse_s + kBStages * BQ;

  const int half = threadIdx.x >> 7, ht = threadIdx.x & 127;
  const int kgs = ht % KGS, rgs = half_group<KGS>(ht);
  const int kgg = ht % KGG, rgg = half_group<KGG>(ht);
  const int k0 = blockIdx.x * BKV;
  const long long off = (long long)blockIdx.y * N * D;
  qs += off; k += off; v += off; dout += off; dk += off; dv += off;
  stats += (long long)blockIdx.y * 2 * pitch;
  const int tiles = (N + BQ - 1) / BQ;

  stage_rows<BKV, D, PQ, kBT>(Ks, k, k0, N, D);
  stage_rows<BKV, D, PQ, kBT>(Vs, v, k0, N, D);
  stage_rows<BQ, D, PQ, kBT>(Qs, qs, 0, N, D);
  stage_rows<BQ, D, PQ, kBT>(dOs, dout, 0, N, D);
  stage_stats<BQ, kBT>(lse_s, dd_s, stats, 0, N, pitch);
  cp_async_commit();

  // first half dv, second half dk: keys rgg + RGG*i, float4 column groups 4*kgg + 4*KGG*g
  float g[TRG][TCG];
#pragma unroll
  for (int i = 0; i < TRG; ++i)
#pragma unroll
    for (int c = 0; c < TCG; ++c) g[i][c] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // q tile t has landed; tile t - 1 and its e, ds are consumed
    if (t + 1 < tiles) {
      const int nx = (t + 1) % kBStages, q1 = (t + 1) * BQ;
      stage_rows<BQ, D, PQ, kBT>(Qs + nx * BQ * PQ, qs, q1, N, D);
      stage_rows<BQ, D, PQ, kBT>(dOs + nx * BQ * PQ, dout, q1, N, D);
      stage_stats<BQ, kBT>(lse_s + nx * BQ, dd_s + nx * BQ, stats, q1, N, pitch);
    }
    cp_async_commit();
    const int st = t % kBStages, q0 = t * BQ;
    const float* Qt = Qs + st * BQ * PQ;
    const float* dOt = dOs + st * BQ * PQ;

    // s^T (first half) or dp^T (second half) for keys rgs + RGS*i, queries kgs + KGS*j
    float a[TRS][TKS];
#pragma unroll
    for (int i = 0; i < TRS; ++i)
#pragma unroll
      for (int j = 0; j < TKS; ++j) a[i][j] = 0.f;
    tile_dot<TRS, TKS, RGS, KGS, D, PQ, PQ>(a, half ? Vs : Ks, half ? dOt : Qt, rgs, kgs);
#pragma unroll
    for (int j = 0; j < TKS; ++j) {
      const int qc = kgs + KGS * j;
      const bool ok = q0 + qc < N;
      const float l = lse_s[st * BQ + qc], dd = dd_s[st * BQ + qc];
#pragma unroll
      for (int i = 0; i < TRS; ++i) {
        if (half == 0) Es[(rgs + RGS * i) * PE + qc] = ok ? expf(a[i][j] - l) : 0.f;
        a[i][j] = ok ? a[i][j] - dd : 0.f;
      }
    }
    __syncthreads();  // e is written
    if (half) {
#pragma unroll
      for (int j = 0; j < TKS; ++j)
#pragma unroll
        for (int i = 0; i < TRS; ++i) {
          const int at = (rgs + RGS * i) * PE + kgs + KGS * j;
          dSs[at] = Es[at] * a[i][j];
        }
      named_barrier(1, kBT / 2);  // ds is written (read by this half only)
    }
    tile_pv<TRG, TCG, RGG, KGG, BQ, PE, PQ>(g, half ? dSs : Es, half ? Qt : dOt, rgg, kgg);
  }

  float* dst = half ? dk : dv;
#pragma unroll
  for (int i = 0; i < TRG; ++i) {
    const int key = k0 + rgg + RGG * i;
    if (key >= N) continue;
#pragma unroll
    for (int c = 0; c < TCG / 4; ++c)
      st4(dst + (long long)key * D + 4 * kgg + 4 * KGG * c, g[i][4 * c], g[i][4 * c + 1],
          g[i][4 * c + 2], g[i][4 * c + 3]);
  }
}

// One CTA a (batch*head, 128 queries). The first half of the threads
// computes S = Q K^T and e, the second dP = dO V^T and then ds = e (dP - D)
// in place of e; all threads accumulate dq += ds K.
template <int D>
__global__ void __launch_bounds__(kBT, 1)
attn_bwd_dq_f32_kernel(const float* __restrict__ qs, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ stats,
                       const float* __restrict__ dout, float* __restrict__ dq, int N, int pitch,
                       float scale) {
  using T = DqTiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, RGS = T::RGS, KGS = T::KGS, RGG = T::RGG, KGG = T::KGG;
  constexpr int TRS = BQ / RGS, TKS = BK / KGS, TRG = BQ / RGG, TCG = D / KGG;
  constexpr int PQ = D + 4, PS = BK + KGS;
  static_assert(RGS * KGS == kBT / 2 && RGG * KGG == kBT && TRS * RGS == BQ &&
                TKS * KGS == BK && TRG * RGG == BQ && TCG % 4 == 0, "tile shape");
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                        // (BQ queries, PQ)
  float* dOs = Qs + BQ * PQ;
  float* Ks = dOs + BQ * PQ;             // (stages, BK keys, PQ)
  float* Vs = Ks + kBStages * BK * PQ;
  float* Es = Vs + kBStages * BK * PQ;   // (BQ queries, PS): e, then ds

  const int half = threadIdx.x >> 7, ht = threadIdx.x & 127;
  const int kgs = ht % KGS, rgs = half_group<KGS>(ht);
  const int lane = threadIdx.x & 31;
  const int kgg = lane % KGG, rgg = (threadIdx.x >> 5) * (32 / KGG) + lane / KGG;
  const int q0 = blockIdx.x * BQ;
  const long long off = (long long)blockIdx.y * N * D;
  qs += off; k += off; v += off; dout += off; dq += off;
  stats += (long long)blockIdx.y * 2 * pitch;
  const int tiles = (N + BK - 1) / BK;

  stage_rows<BQ, D, PQ, kBT>(Qs, qs, q0, N, D);
  stage_rows<BQ, D, PQ, kBT>(dOs, dout, q0, N, D);
  stage_rows<BK, D, PQ, kBT>(Ks, k, 0, N, D);
  stage_rows<BK, D, PQ, kBT>(Vs, v, 0, N, D);
  cp_async_commit();

  // lse (first half) or D (second half) of queries rgs + RGS*i
  float r[TRS];
#pragma unroll
  for (int i = 0; i < TRS; ++i) {
    const int row = q0 + rgs + RGS * i;
    r[i] = row < N ? stats[half * pitch + row] : 0.f;
  }
  float gq[TRG][TCG];  // queries rgg + RGG*i, float4 column groups 4*kgg + 4*KGG*c
#pragma unroll
  for (int i = 0; i < TRG; ++i)
#pragma unroll
    for (int c = 0; c < TCG; ++c) gq[i][c] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // key tile t has landed; tile t - 1 and its ds are consumed
    if (t + 1 < tiles) {
      const int nx = (t + 1) % kBStages, k1 = (t + 1) * BK;
      stage_rows<BK, D, PQ, kBT>(Ks + nx * BK * PQ, k, k1, N, D);
      stage_rows<BK, D, PQ, kBT>(Vs + nx * BK * PQ, v, k1, N, D);
    }
    cp_async_commit();
    const float* Kt = Ks + (t % kBStages) * BK * PQ;
    const float* Vt = Vs + (t % kBStages) * BK * PQ;

    // s (first half) or dp (second half) for queries rgs + RGS*i, keys kgs + KGS*j
    float a[TRS][TKS];
#pragma unroll
    for (int i = 0; i < TRS; ++i)
#pragma unroll
      for (int j = 0; j < TKS; ++j) a[i][j] = 0.f;
    tile_dot<TRS, TKS, RGS, KGS, D, PQ, PQ>(a, half ? dOs : Qs, half ? Vt : Kt, rgs, kgs);
    const int k0 = t * BK;
#pragma unroll
    for (int j = 0; j < TKS; ++j) {
      const bool ok = k0 + kgs + KGS * j < N;
#pragma unroll
      for (int i = 0; i < TRS; ++i) {
        if (half == 0) Es[(rgs + RGS * i) * PS + kgs + KGS * j] = ok ? expf(a[i][j] - r[i]) : 0.f;
        a[i][j] = ok ? a[i][j] - r[i] : 0.f;
      }
    }
    __syncthreads();  // e is written
    if (half) {
#pragma unroll
      for (int j = 0; j < TKS; ++j)
#pragma unroll
        for (int i = 0; i < TRS; ++i) {
          const int at = (rgs + RGS * i) * PS + kgs + KGS * j;
          Es[at] = Es[at] * a[i][j];
        }
    }
    __syncthreads();  // ds is written
    tile_pv<TRG, TCG, RGG, KGG, BK, PS, PQ>(gq, Es, Kt, rgg, kgg);
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
static int launch_attn_bwd(const void* qs, const void* k, const void* v, const float* stats,
                           int pitch, const void* dout, void* dq, void* dk, void* dv, int BH,
                           int N, cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t s1 = bwd_dkdv_f32_smem_bytes<D>(), s2 = bwd_dq_f32_smem_bytes<D>();
  cudaFuncSetAttribute(attn_bwd_dkdv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s1);
  cudaFuncSetAttribute(attn_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s2);
  const dim3 g1((N + DkdvTiles<D>::BKV - 1) / DkdvTiles<D>::BKV, BH);
  attn_bwd_dkdv_f32_kernel<D><<<g1, kBT, s1, stream>>>(f(qs), f(k), f(v), stats, f(dout),
                                                       static_cast<float*>(dk),
                                                       static_cast<float*>(dv), N, pitch);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 g2((N + DqTiles<D>::BQ - 1) / DqTiles<D>::BQ, BH);
  attn_bwd_dq_f32_kernel<D><<<g2, kBT, s2, stream>>>(f(qs), f(k), f(v), stats, f(dout),
                                                     static_cast<float*>(dq), N, pitch,
                                                     1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// bf16 storage takes the wgmma kernels of attention_bwd_wgmma.cu, which read
// the stats through TMA (rows `pitch` floats apart, as here)
template <int D>
int launch_attn_bwd_wgmma(const void* qs, const void* k, const void* v, const float* stats,
                          int pitch, const void* dout, void* dq, void* dk, void* dv, int BH,
                          int N, cudaStream_t stream);

template <int D>
static int launch_any_bwd(int dtype, const void* qs, const void* k, const void* v, const void* o,
                          const float* lse, const void* dout, void* dq, void* dk, void* dv,
                          float* stats, int BH, int N, cudaStream_t s) {
  const int pitch = (N + 3) / 4 * 4;  // 16-byte rows for cp.async and TMA
  const int rc = attn_row_stats(dtype, D, lse, dout, o, stats, BH, N, pitch, s);
  if (rc != 0) return rc;
  if (dtype == kF32)
    return launch_attn_bwd<D>(qs, k, v, stats, pitch, dout, dq, dk, dv, BH, N, s);
  if (dtype == kBF16)
    return launch_attn_bwd_wgmma<D>(qs, k, v, stats, pitch, dout, dq, dk, dv, BH, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace vitocm

// qs, k, v, o, dout, dq, dk, dv (BH, N, d) contiguous in the storage type;
// lse (BH, N) f32; stats an f32 workspace of 2 * BH * round_up(N, 4) values.
// d in {64, 128}. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int vitocm_flash_bwd(int dtype, const void* qs, const void* k, const void* v,
                                const void* o, const void* lse, const void* dout, void* dq,
                                void* dk, void* dv, void* stats, int BH, int N, int head_dim,
                                void* stream) {
  using namespace vitocm;
  if (BH < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* st = static_cast<float*>(stats);
  if (head_dim == 64)
    return launch_any_bwd<64>(dtype, qs, k, v, o, l, dout, dq, dk, dv, st, BH, N, s);
  if (head_dim == 128)
    return launch_any_bwd<128>(dtype, qs, k, v, o, l, dout, dq, dk, dv, st, BH, N, s);
  return (int)cudaErrorInvalidValue;
}
