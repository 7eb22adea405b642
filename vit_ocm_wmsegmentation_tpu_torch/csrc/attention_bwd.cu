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
// one CTA per 64 keys walks every q block and owns its dk/dv rows; one CTA
// per 64 queries walks every key block and owns its dq rows. D and the
// guarded lse are computed once per row by a small kernel ahead of both,
// not again in every CTA that reads the row. 256 threads, 4 x 4 score
// blocks and 4 x (d/16) gradient blocks a thread; 99 KB (d = 64) or 166 KB
// (d = 128) of shared memory for the dk/dv kernel. Bound, as the forward: f32 FMA
// issue and shared-memory loads on the CUDA cores (no TF32). bf16 storage
// takes attention_bwd_wgmma.cu.
//
// Numerics: as the TPU kernel, whose rounding of e and ds to the storage
// type is the identity in f32; dk and dv accumulate over all q in f32 and
// are written once (at the MIM shape the TPU kernel runs one q block, so
// it too rounds once). Padded q rows and keys are masked in the kernel, and
// a non-finite lse counts as 0, as nan_to_num does in _flash_bwd_impl.

#include <math.h>

#include "common.cuh"

namespace vitocm {

constexpr int kGB = 64;   // rows (keys or queries) per CTA and per tile
constexpr int kGT = 256;  // threads
constexpr int kGS = kGB + 1;

template <int D>
constexpr size_t bwd_dkdv_smem_bytes() {
  return sizeof(float) * (4 * kGB * (D + 1) + 2 * kGB * kGS + 2 * kGB);
}

template <int D>
constexpr size_t bwd_dq_smem_bytes() {
  return sizeof(float) * (4 * kGB * (D + 1) + kGB * kGS + 2 * kGB);
}

// rows r0.. of one (N, d) slice into shared memory (pitch P), zeros past N
template <int D, int P>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int r0, int N) {
  for (int i = threadIdx.x; i < kGB * D; i += kGT) {
    const int r = i / D, c = i % D;
    dst[r * P + c] = r0 + r < N ? src[(long long)(r0 + r) * D + c] : 0.f;
  }
}

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

template <int D>
__global__ void __launch_bounds__(kGT)
attn_bwd_dkdv_kernel(const float* __restrict__ qs, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ stats,
                     const float* __restrict__ dout,
                     float* __restrict__ dk, float* __restrict__ dv, int N) {
  constexpr int P = D + 1, OJ = D / 16;
  extern __shared__ float sm[];
  float* Ks = sm;               // (GB keys, P)
  float* Vs = Ks + kGB * P;
  float* Qs = Vs + kGB * P;     // (GB queries, P)
  float* dOs = Qs + kGB * P;
  float* Ps = dOs + kGB * P;    // (GB keys, GS): e
  float* dSs = Ps + kGB * kGS;  // (GB keys, GS): ds
  float* lse_s = dSs + kGB * kGS;
  float* dd_s = lse_s + kGB;

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int k0 = blockIdx.x * kGB;
  const long long off = (long long)blockIdx.y * N * D;
  qs += off; k += off; v += off; dout += off; dk += off; dv += off;
  stats += (long long)blockIdx.y * 2 * N;

  load_rows_f32<D, P>(Ks, k, k0, N);
  load_rows_f32<D, P>(Vs, v, k0, N);
  float gk[4][OJ], gv[4][OJ];  // keys tr + 16i, columns tc + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) gk[i][j] = gv[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kGB) {
    __syncthreads();  // the previous q tile is consumed
    load_rows_f32<D, P>(Qs, qs, q0, N);
    load_rows_f32<D, P>(dOs, dout, q0, N);
    stage_row_stats(lse_s, dd_s, stats, q0, kGB, N);
    __syncthreads();

    // s^T and dp^T for keys tr + 16i, queries tc + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float kv[4], vv[4], qv[4], dv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(tr + 16 * i) * P + c];
        vv[i] = Vs[(tr + 16 * i) * P + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tc + 16 * j) * P + c];
        dv4[j] = dOs[(tc + 16 * j) * P + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dv4[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tc + 16 * j, key = tr + 16 * i;
        const float e = (q0 + qc < N && k0 + key < N) ? expf(s[i][j] - lse_s[qc]) : 0.f;
        Ps[key * kGS + qc] = e;
        dSs[key * kGS + qc] = e * (dp[i][j] - dd_s[qc]);
      }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kGB; ++qq) {
      float pv[4], sv[4], dov[OJ], qv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(tr + 16 * i) * kGS + qq];
        sv[i] = dSs[(tr + 16 * i) * kGS + qq];
      }
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        dov[j] = dOs[qq * P + tc + 16 * j];
        qv[j] = Qs[qq * P + tc + 16 * j];
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
__global__ void __launch_bounds__(kGT)
attn_bwd_dq_kernel(const float* __restrict__ qs, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ stats,
                   const float* __restrict__ dout,
                   float* __restrict__ dq, int N, float scale) {
  constexpr int P = D + 1, OJ = D / 16;
  extern __shared__ float sm[];
  float* Qs = sm;               // (GB queries, P)
  float* dOs = Qs + kGB * P;
  float* Ks = dOs + kGB * P;    // (GB keys, P)
  float* Vs = Ks + kGB * P;
  float* dSs = Vs + kGB * P;    // (GB queries, GS)
  float* lse_s = dSs + kGB * kGS;
  float* dd_s = lse_s + kGB;

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int q0 = blockIdx.x * kGB;
  const long long off = (long long)blockIdx.y * N * D;
  qs += off; k += off; v += off; dout += off; dq += off;
  stats += (long long)blockIdx.y * 2 * N;

  load_rows_f32<D, P>(Qs, qs, q0, N);
  load_rows_f32<D, P>(dOs, dout, q0, N);
  stage_row_stats(lse_s, dd_s, stats, q0, kGB, N);
  float gq[4][OJ];  // queries tr + 16i, columns tc + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) gq[i][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kGB) {
    __syncthreads();  // the previous key tile is consumed
    load_rows_f32<D, P>(Ks, k, k0, N);
    load_rows_f32<D, P>(Vs, v, k0, N);
    __syncthreads();

    // s and dp for queries tr + 16i, keys tc + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(tr + 16 * i) * P + c];
        dov[i] = dOs[(tr + 16 * i) * P + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tc + 16 * j) * P + c];
        vv[j] = Vs[(tc + 16 * j) * P + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tr + 16 * i, kc = tc + 16 * j;
        const float e = (q0 + qr < N && k0 + kc < N) ? expf(s[i][j] - lse_s[qr]) : 0.f;
        dSs[qr * kGS + kc] = e * (dp[i][j] - dd_s[qr]);
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kGB; ++kk) {
      float sv[4], kv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(tr + 16 * i) * kGS + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) kv[j] = Ks[kk * P + tc + 16 * j];
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
static int launch_attn_bwd(const void* qs, const void* k, const void* v, const float* stats,
                           const void* dout, void* dq, void* dk, void* dv, int BH, int N,
                           cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const dim3 grid((N + kGB - 1) / kGB, BH);
  const size_t s1 = bwd_dkdv_smem_bytes<D>(), s2 = bwd_dq_smem_bytes<D>();
  cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s1);
  cudaFuncSetAttribute(attn_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s2);
  attn_bwd_dkdv_kernel<D><<<grid, kGT, s1, stream>>>(f(qs), f(k), f(v), stats, f(dout),
                                                     static_cast<float*>(dk),
                                                     static_cast<float*>(dv), N);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  attn_bwd_dq_kernel<D><<<grid, kGT, s2, stream>>>(f(qs), f(k), f(v), stats, f(dout),
                                                   static_cast<float*>(dq), N, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// bf16 storage takes the wgmma kernels of attention_bwd_wgmma.cu, which read
// the stats through TMA: rows `pitch` floats apart, pitch a multiple of 4
template <int D>
int launch_attn_bwd_wgmma(const void* qs, const void* k, const void* v, const float* stats,
                          int pitch, const void* dout, void* dq, void* dk, void* dv, int BH,
                          int N, cudaStream_t stream);

template <int D>
static int launch_any_bwd(int dtype, const void* qs, const void* k, const void* v, const void* o,
                          const float* lse, const void* dout, void* dq, void* dk, void* dv,
                          float* stats, int BH, int N, cudaStream_t s) {
  const int pitch = dtype == kF32 ? N : (N + 3) / 4 * 4;
  const int rc = attn_row_stats(dtype, D, lse, dout, o, stats, BH, N, pitch, s);
  if (rc != 0) return rc;
  if (dtype == kF32) return launch_attn_bwd<D>(qs, k, v, stats, dout, dq, dk, dv, BH, N, s);
  if (dtype == kBF16)
    return launch_attn_bwd_wgmma<D>(qs, k, v, stats, pitch, dout, dq, dk, dv, BH, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace vitocm

// qs, k, v, o, dout, dq, dk, dv (BH, N, d) contiguous in the storage type;
// lse (BH, N) f32; stats an f32 workspace of 2 * BH * round_up(N, 4) values
// (the f32 route uses the first 2 * BH * N of them). d in
// {64, 128}. Returns cudaGetLastError() after the launches (0 on success).
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
