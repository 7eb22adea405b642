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
// (attention_bwd.cu): the row statistics once (inv and D = rowsum(do * o)),
// one CTA per 64 keys owning dk/dv rows, one CTA per 64 queries owning dq
// rows. What changes:
// the s-recompute product and the exp are gone; each CTA stages the P tile
// it needs (coalesced along keys) and forms e = P * inv with one row
// broadcast multiply. The dk/dv kernel no longer needs K, the dq kernel no
// longer needs Q. e, ds = e (do v^T - D), dv = e^T do, dk = ds^T qs,
// dq = ds k * d^-0.5. Each kernel reads all of P once: 1.02 GB twice a layer
// in f32, under the products' FMA time here; the bf16 kernels of
// attention_savep_mma.cu are where P's bytes bound the backward.

#include <math.h>

#include "common.cuh"

namespace vitocm {

constexpr int kPB = 64;   // query rows (forward, dq) or keys (dk/dv) per CTA, and per tile
constexpr int kPT = 256;  // threads
constexpr int kPS = kPB + 1;

template <int D>
constexpr size_t savep_fwd_smem_bytes() {
  return sizeof(float) * (kPB * (D + 1) * 2 + kPB * D + kPB * kPS);
}

template <int D>
constexpr size_t savep_dkdv_smem_bytes() {
  return sizeof(float) * (3 * kPB * (D + 1) + 2 * kPB * kPS + 2 * kPB);
}

template <int D>
constexpr size_t savep_dq_smem_bytes() {
  return sizeof(float) * (3 * kPB * (D + 1) + kPB * kPS + 2 * kPB);
}

// rows r0.. of one (N, D) slice into shared memory (pitch P), zeros past N
template <int D, int P>
__device__ __forceinline__ void savep_rows(float* dst, const float* src, int r0, int N) {
  for (int i = threadIdx.x; i < kPB * D; i += kPT) {
    const int r = i / D, c = i % D;
    dst[r * P + c] = r0 + r < N ? src[(long long)(r0 + r) * D + c] : 0.f;
  }
}

// the (64 queries, 64 keys) tile of P at (q0, k0) into shared memory, zeros
// for queries past N; TRANS stores it key-major (dst[key * kPS + query])
template <bool TRANS>
__device__ __forceinline__ void savep_p_tile(float* dst, const float* P, int q0, int k0, int N,
                                             int Np) {
  for (int i = threadIdx.x; i < kPB * kPB; i += kPT) {
    const int qq = i / kPB, key = i % kPB;
    const float val = q0 + qq < N ? P[(long long)(q0 + qq) * Np + k0 + key] : 0.f;
    dst[TRANS ? key * kPS + qq : qq * kPS + key] = val;
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

template <int D>
__global__ void __launch_bounds__(kPT)
attn_bwd_savep_dkdv_kernel(const float* __restrict__ qs, const float* __restrict__ v,
                           const float* __restrict__ P, const float* __restrict__ stats,
                           const float* __restrict__ dout, float* __restrict__ dk,
                           float* __restrict__ dv, int N, int Np) {
  constexpr int PQ = D + 1, OJ = D / 16;
  extern __shared__ float sm[];
  float* Vs = sm;               // (PB keys, PQ)
  float* Qs = Vs + kPB * PQ;    // (PB queries, PQ)
  float* dOs = Qs + kPB * PQ;
  float* Es = dOs + kPB * PQ;   // (PB keys, PS): P, then e = P * inv
  float* dSs = Es + kPB * kPS;  // (PB keys, PS): ds
  float* inv_s = dSs + kPB * kPS;
  float* dd_s = inv_s + kPB;

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int k0 = blockIdx.x * kPB;
  const long long off = (long long)blockIdx.y * N * D;
  qs += off; v += off; dout += off; dk += off; dv += off;
  P += (long long)blockIdx.y * N * Np;
  stats += (long long)blockIdx.y * 2 * N;

  savep_rows<D, PQ>(Vs, v, k0, N);
  float gk[4][OJ], gv[4][OJ];  // keys tr + 16i, columns tc + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) gk[i][j] = gv[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kPB) {
    __syncthreads();  // the previous q tile is consumed
    savep_rows<D, PQ>(Qs, qs, q0, N);
    savep_rows<D, PQ>(dOs, dout, q0, N);
    stage_row_stats(inv_s, dd_s, stats, q0, kPB, N);
    savep_p_tile<true>(Es, P, q0, k0, N, Np);
    __syncthreads();

    // dp^T for keys tr + 16i, queries tc + 16j
    float dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float vv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) vv[i] = Vs[(tr + 16 * i) * PQ + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) ov[j] = dOs[(tc + 16 * j) * PQ + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
    }
    // padded keys and queries hold P = 0, so e = 0 there
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tc + 16 * j, key = tr + 16 * i;
        const float e = Es[key * kPS + qc] * inv_s[qc];
        Es[key * kPS + qc] = e;
        dSs[key * kPS + qc] = e * (dp[i][j] - dd_s[qc]);
      }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kPB; ++qq) {
      float pv[4], sv[4], dov[OJ], qv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Es[(tr + 16 * i) * kPS + qq];
        sv[i] = dSs[(tr + 16 * i) * kPS + qq];
      }
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        dov[j] = dOs[qq * PQ + tc + 16 * j];
        qv[j] = Qs[qq * PQ + tc + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          gv[i][j] = fmaf(pv[i], dov[j], gv[i][j]);
          gk[i][j] = fmaf(sv[i], qv[j], gk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tr + 16 * i;
    if (key >= N) continue;
#pragma unroll
    for (int j = 0; j < OJ; ++j) {
      dk[(long long)key * D + tc + 16 * j] = gk[i][j];
      dv[(long long)key * D + tc + 16 * j] = gv[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kPT)
attn_bwd_savep_dq_kernel(const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ P, const float* __restrict__ stats,
                         const float* __restrict__ dout, float* __restrict__ dq, int N, int Np,
                         float scale) {
  constexpr int PQ = D + 1, OJ = D / 16;
  extern __shared__ float sm[];
  float* dOs = sm;              // (PB queries, PQ)
  float* Ks = dOs + kPB * PQ;   // (PB keys, PQ)
  float* Vs = Ks + kPB * PQ;
  float* Es = Vs + kPB * PQ;    // (PB queries, PS): P, then ds
  float* inv_s = Es + kPB * kPS;
  float* dd_s = inv_s + kPB;

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int q0 = blockIdx.x * kPB;
  const long long off = (long long)blockIdx.y * N * D;
  k += off; v += off; dout += off; dq += off;
  P += (long long)blockIdx.y * N * Np;
  stats += (long long)blockIdx.y * 2 * N;

  savep_rows<D, PQ>(dOs, dout, q0, N);
  stage_row_stats(inv_s, dd_s, stats, q0, kPB, N);
  float gq[4][OJ];  // queries tr + 16i, columns tc + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) gq[i][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kPB) {
    __syncthreads();  // the previous key tile is consumed
    savep_rows<D, PQ>(Ks, k, k0, N);
    savep_rows<D, PQ>(Vs, v, k0, N);
    savep_p_tile<false>(Es, P, q0, k0, N, Np);
    __syncthreads();

    // dp for queries tr + 16i, keys tc + 16j
    float dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float ov[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = dOs[(tr + 16 * i) * PQ + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[(tc + 16 * j) * PQ + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tr + 16 * i, kc = tc + 16 * j;
        Es[qr * kPS + kc] = Es[qr * kPS + kc] * inv_s[qr] * (dp[i][j] - dd_s[qr]);
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kPB; ++kk) {
      float sv[4], kv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Es[(tr + 16 * i) * kPS + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) kv[j] = Ks[kk * PQ + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) gq[i][j] = fmaf(sv[i], kv[j], gq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < OJ; ++j) dq[(long long)row * D + tc + 16 * j] = gq[i][j] * scale;
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
                            const float* stats, const void* dout, void* dq, void* dk, void* dv,
                            int BH, int N, int Np, cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const dim3 grid((N + kPB - 1) / kPB, BH);
  const size_t s1 = savep_dkdv_smem_bytes<D>(), s2 = savep_dq_smem_bytes<D>();
  cudaFuncSetAttribute(attn_bwd_savep_dkdv_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  cudaFuncSetAttribute(attn_bwd_savep_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s2);
  attn_bwd_savep_dkdv_kernel<D><<<grid, kPT, s1, stream>>>(
      f(qs), f(v), f(P), stats, f(dout), static_cast<float*>(dk), static_cast<float*>(dv), N,
      Np);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  attn_bwd_savep_dq_kernel<D><<<grid, kPT, s2, stream>>>(
      f(k), f(v), f(P), stats, f(dout), static_cast<float*>(dq), N, Np, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// bf16 storage takes the tensor-core kernels of attention_savep_mma.cu
template <int D>
int launch_fwd_savep_mma(const void* qs, const void* k, const void* v, void* out, void* P,
                         float* inv, int BH, int N, int Np, cudaStream_t stream);
template <int D>
int launch_bwd_savep_mma(const void* qs, const void* k, const void* v, const void* P,
                         const float* stats, const void* dout, void* dq, void* dk, void* dv,
                         int BH, int N, int Np, cudaStream_t stream);

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
// workspace of 2 * BH * N values. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int vitocm_flash_bwd_savep(int dtype, const void* qs, const void* k, const void* v,
                                      const void* o, const void* P, const void* inv,
                                      const void* dout, void* dq, void* dk, void* dv, void* stats,
                                      int BH, int N, int Np, int head_dim, void* stream) {
  using namespace vitocm;
  if (BH < 1 || N < 1 || Np < N || Np % kPB != 0 || (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  int rc =
      attn_row_stats(dtype, head_dim, static_cast<const float*>(inv), dout, o, st, BH, N, N, s);
  if (rc != 0) return rc;
  if (dtype == kF32 && head_dim == 64)
    return launch_bwd_savep<64>(qs, k, v, P, st, dout, dq, dk, dv, BH, N, Np, s);
  if (dtype == kF32 && head_dim == 128)
    return launch_bwd_savep<128>(qs, k, v, P, st, dout, dq, dk, dv, BH, N, Np, s);
  if (head_dim == 64)
    return launch_bwd_savep_mma<64>(qs, k, v, P, st, dout, dq, dk, dv, BH, N, Np, s);
  return launch_bwd_savep_mma<128>(qs, k, v, P, st, dout, dq, dk, dv, BH, N, Np, s);
}
