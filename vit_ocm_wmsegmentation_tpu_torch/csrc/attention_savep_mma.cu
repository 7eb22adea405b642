// bf16 variant of csrc/attention_savep.cu on the tensor cores (mma.sync
// m16n8k16, f32 accumulation): the saved-P forward and backward. Same
// contract and the TPU kernels' rounding points
// (ops/flash_attention.py::_attn_fwd_kernel with want_p,
// ::_attn_bwd_savep_kernel and _flash_bwd_savep_impl):
//   forward:  P = bf16(exp(s - m)) with m the true row max, o = (P V) / sum(P)
//             rounded once, inv = 1 / sum(P) in f32 (the sum of the rounded P,
//             as the TPU kernel's ones column of V sums it);
//   backward: e = P * inv in f32, dv = bf16(e)^T do, ds = bf16(e (do v^T - D)),
//             dk = ds^T qs, dq = bf16(bf16(ds k) * d^-0.5).
//
// Forward: a CTA owns 64 query rows, four warps of 16, Q as A fragments in
// registers (mma.cuh's A fragment). Pass 1 stages each 64-key K
// tile and keeps the row max of S = Q K^T (padded keys masked); pass 2
// stages K and V, recomputes S, rounds P in registers, stores it to P (two
// bf16 a lane per fragment row) and re-packs it as the A operand of P V.
//
// Backward: two deterministic kernels, as the lse route's
// (attention_bwd_wgmma.cu), without the s-recompute product and the exp.
// dk/dv kernel: 64 keys a CTA, query tiles of QT (64 at d = 64, 32 at
// d = 128); per tile it stages Q, dO and the (QT, 64) P tile
// (16-byte loads along keys), computes dp^T = V dO^T, reads e from the P tile
// at the fragment's (query, key) positions and multiplies by inv, then
// dV += bf16(e)^T dO and dK += dS^T Q. dq kernel: 64 queries a CTA, key tiles
// of QT; dp = dO V^T, ds from the staged P tile, dQ += dS K. Bound: at the
// MIM shape P is 510 MB a layer, read once by each kernel (0.30 ms of HBM
// time against ~0.1 ms of tensor-core time for the three remaining products
// of each kernel): bytes, not the exp the lse route spends.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace vitocm {

constexpr int kVQ = 64;   // query rows (forward, dq) or keys (dk/dv) per CTA
constexpr int kVK = 64;   // keys per forward tile
constexpr int kVT = 128;  // threads: four warps of 16 rows

template <int D>
constexpr int kSavepTile = D == 64 ? 64 : 32;  // the backward's inner tile

template <int D>
constexpr size_t savep_dkdv_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kVQ * (D + 8) + 2 * kSavepTile<D> * (D + 8) +
                                  kSavepTile<D> * (kVQ + 8)) +
         sizeof(float) * 2 * kVQ;
}

template <int D>
constexpr size_t savep_dq_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kVQ * (D + 8) + 2 * kSavepTile<D> * (D + 8) +
                                  kVQ * (kSavepTile<D> + 8)) +
         sizeof(float) * 2 * kVQ;
}

// rows r0 .. r0+rows-1 of one (N, D) slice into shared memory (pitch D+8),
// zeros past N, 16 bytes a load
template <int D>
__device__ __forceinline__ void savep_stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                            int rows, int N) {
  for (int i = threadIdx.x; i < rows * D / 8; i += kVT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const uint4 val =
        *reinterpret_cast<const uint4*>(src + (long long)min(r0 + r, N - 1) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = r0 + r < N ? val : make_uint4(0, 0, 0, 0);
  }
}

// the (rows, COLS) tile of P at (q0, k0) into shared memory (pitch COLS+8),
// zeros for queries past N; k0 + COLS <= Np and every P row is 16-byte aligned
template <int COLS>
__device__ __forceinline__ void savep_stage_p(__nv_bfloat16* dst, const __nv_bfloat16* P, int q0,
                                              int k0, int rows, int N, int Np) {
  for (int i = threadIdx.x; i < rows * COLS / 8; i += kVT) {
    const int r = i / (COLS / 8), c = (i % (COLS / 8)) * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(
        P + (long long)min(q0 + r, N - 1) * Np + k0 + c);
    *reinterpret_cast<uint4*>(dst + r * (COLS + 8) + c) =
        q0 + r < N ? val : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ float bf(const __nv_bfloat16 v) { return __bfloat162float(v); }

template <int D>
__global__ void __launch_bounds__(kVT, D == 64 ? 4 : 3)
attn_fwd_savep_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          __nv_bfloat16* __restrict__ P, float* __restrict__ inv, int N, int Np) {
  constexpr int PD = D + 8, KD = D / 16;
  __shared__ __align__(16) __nv_bfloat16 Ks[kVK * PD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kVK * PD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long off = (long long)blockIdx.y * N * D;
  q += off; k += off; v += off; out += off;
  P += (long long)blockIdx.y * N * Np;
  inv += (long long)blockIdx.y * N;
  const int r0 = blockIdx.x * kVQ + warp * 16 + g, r1 = r0 + 8;  // this lane's rows

  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = 16 * kk + 2 * t;
    qa[kk][0] = r0 < N ? ld_pair(q + (long long)r0 * D + c) : 0u;
    qa[kk][1] = r1 < N ? ld_pair(q + (long long)r1 * D + c) : 0u;
    qa[kk][2] = r0 < N ? ld_pair(q + (long long)r0 * D + c + 8) : 0u;
    qa[kk][3] = r1 < N ? ld_pair(q + (long long)r1 * D + c + 8) : 0u;
  }

  // S = Q K^T of the staged tile at k0, padded keys at -inf
  auto scores = [&](float (&s)[8][4], int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* bp = Ks + (8 * j + g) * PD + 16 * kk + 2 * t;
        mma_bf16_16816(s[j], qa[kk], ld_pair(bp), ld_pair(bp + 8));
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + 8 * j + 2 * t;
      if (key >= N) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= N) s[j][1] = s[j][3] = -INFINITY;
    }
  };

  // pass 1: the true row max
  float m0 = -INFINITY, m1 = -INFINITY;
  float s[8][4];
  for (int k0 = 0; k0 < N; k0 += kVK) {
    __syncthreads();  // the previous K tile is consumed
    savep_stage<D>(Ks, k, k0, kVK, N);
    __syncthreads();
    scores(s, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }

  // pass 2: P = bf16(exp(s - m)) stored and multiplied by V
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < N; k0 += kVK) {
    __syncthreads();  // the previous K and V tiles are consumed
    savep_stage<D>(Ks, k, k0, kVK, N);
    savep_stage<D>(Vs, v, k0, kVK, N);
    __syncthreads();
    scores(s, k0);
    uint32_t pk[8][2];  // the rounded P of rows r0 and r1, two keys a register
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = round_bf16(expf(s[j][0] - m0)), p1 = round_bf16(expf(s[j][1] - m0));
      const float p2 = round_bf16(expf(s[j][2] - m1)), p3 = round_bf16(expf(s[j][3] - m1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pk[j][0] = pack_bf16(p0, p1);
      pk[j][1] = pack_bf16(p2, p3);
      const int col = k0 + 8 * j + 2 * t;  // < Np: Np is a multiple of the key tile
      if (r0 < N) *reinterpret_cast<uint32_t*>(P + (long long)r0 * Np + col) = pk[j][0];
      if (r1 < N) *reinterpret_cast<uint32_t*>(P + (long long)r1 * Np + col) = pk[j][1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t vf[4];
        ld_b_frag2(vf, Vs, PD, 16 * kk, 8 * j, lane);
        mma_bf16_16816(o[j], pa, vf[0], vf[1]);
        mma_bf16_16816(o[j + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int off2 = 1; off2 <= 2; off2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off2);
  }
  if (t == 0) {  // l >= 1: the max term is exp(0)
    if (r0 < N) inv[r0] = 1.f / l0;
    if (r1 < N) inv[r1] = 1.f / l1;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(out + (long long)r0 * D + c) = pack_bf16(o[j][0] / l0, o[j][1] / l0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(out + (long long)r1 * D + c) = pack_bf16(o[j][2] / l1, o[j][3] / l1);
  }
}

template <int D>
__global__ void __launch_bounds__(kVT)
attn_bwd_savep_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ qs,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ P,
                               const float* __restrict__ stats,
                               const __nv_bfloat16* __restrict__ dout,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               int N, int Np) {
  constexpr int PD = D + 8, QT = kSavepTile<D>, NJ = QT / 8, KD = D / 16, PP = kVQ + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (VQ keys, PD)
  __nv_bfloat16* Qs = Vs + kVQ * PD;                                // (QT queries, PD)
  __nv_bfloat16* dOs = Qs + QT * PD;
  __nv_bfloat16* Pt = dOs + QT * PD;                                // (QT queries, PP)
  float* inv_s = reinterpret_cast<float*>(Pt + QT * PP);
  float* dd_s = inv_s + kVQ;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kVQ, kr = warp * 16;  // this warp's keys: k0 + kr ..
  const long long off = (long long)blockIdx.y * N * D;
  qs += off; v += off; dout += off; dk += off; dv += off;
  P += (long long)blockIdx.y * N * Np;
  stats += (long long)blockIdx.y * 2 * N;

  savep_stage<D>(Vs, v, k0, kVQ, N);
  float gk[D / 8][4], gv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;

  for (int q0 = 0; q0 < N; q0 += QT) {
    __syncthreads();  // the previous q tile is consumed
    savep_stage<D>(Qs, qs, q0, QT, N);
    savep_stage<D>(dOs, dout, q0, QT, N);
    savep_stage_p<kVQ>(Pt, P, q0, k0, QT, N, Np);
    stage_row_stats(inv_s, dd_s, stats, q0, QT, N);
    __syncthreads();

    // dp^T = V dO^T: rows kr + g (+8), query columns 8j + 2t (+1)
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t va[4];
      ld_a_frag(va, Vs + kr * PD + 16 * kk, PD, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* op = dOs + (8 * j + g) * PD + 16 * kk + 2 * t;
        mma_bf16_16816(dp[j], va, ld_pair(op), ld_pair(op + 8));
      }
    }
    // e = P * inv; p = bf16(e) into s, ds = bf16(e (dp - D)) into dp. Padded
    // keys and queries hold P = 0.
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const float ev = bf(Pt[qc * PP + kr + g + (e >> 1) * 8]) * inv_s[qc];
        s[j][e] = round_bf16(ev);
        dp[j][e] = round_bf16(ev * (dp[j][e] - dd_s[qc]));
      }

#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t bo[4], bq[4];
        ld_b_frag2(bo, dOs, PD, 16 * kk, 8 * j, lane);
        ld_b_frag2(bq, Qs, PD, 16 * kk, 8 * j, lane);
        mma_bf16_16816(gv[j], pa, bo[0], bo[1]);
        mma_bf16_16816(gv[j + 1], pa, bo[2], bo[3]);
        mma_bf16_16816(gk[j], da, bq[0], bq[1]);
        mma_bf16_16816(gk[j + 1], da, bq[2], bq[3]);
      }
    }
  }

  const int r0 = k0 + kr + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < N) {
      *reinterpret_cast<uint32_t*>(dk + (long long)r0 * D + c) = pack_bf16(gk[j][0], gk[j][1]);
      *reinterpret_cast<uint32_t*>(dv + (long long)r0 * D + c) = pack_bf16(gv[j][0], gv[j][1]);
    }
    if (r1 < N) {
      *reinterpret_cast<uint32_t*>(dk + (long long)r1 * D + c) = pack_bf16(gk[j][2], gk[j][3]);
      *reinterpret_cast<uint32_t*>(dv + (long long)r1 * D + c) = pack_bf16(gv[j][2], gv[j][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kVT)
attn_bwd_savep_dq_mma_kernel(const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ P, const float* __restrict__ stats,
                             const __nv_bfloat16* __restrict__ dout,
                             __nv_bfloat16* __restrict__ dq, int N, int Np, float scale) {
  constexpr int PD = D + 8, KT = kSavepTile<D>, NJ = KT / 8, KD = D / 16, PP = KT + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (VQ queries, PD)
  __nv_bfloat16* Ks = dOs + kVQ * PD;                                // (KT keys, PD)
  __nv_bfloat16* Vs = Ks + KT * PD;
  __nv_bfloat16* Pt = Vs + KT * PD;                                  // (VQ queries, PP)
  float* inv_s = reinterpret_cast<float*>(Pt + kVQ * PP);
  float* dd_s = inv_s + kVQ;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kVQ, qr = warp * 16;  // this warp's queries: q0 + qr ..
  const long long off = (long long)blockIdx.y * N * D;
  k += off; v += off; dout += off; dq += off;
  P += (long long)blockIdx.y * N * Np;
  stats += (long long)blockIdx.y * 2 * N;

  savep_stage<D>(dOs, dout, q0, kVQ, N);
  stage_row_stats(inv_s, dd_s, stats, q0, kVQ, N);
  __syncthreads();
  const float inv0 = inv_s[qr + g], inv1 = inv_s[qr + g + 8];
  const float dd0 = dd_s[qr + g], dd1 = dd_s[qr + g + 8];

  float gq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gq[j][e] = 0.f;

  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();  // the previous key tile is consumed
    savep_stage<D>(Ks, k, k0, KT, N);
    savep_stage<D>(Vs, v, k0, KT, N);
    savep_stage_p<KT>(Pt, P, q0, k0, kVQ, N, Np);
    __syncthreads();

    // dp = dO V^T: rows qr + g (+8), key columns 8j + 2t (+1)
    float dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t oa[4];
      ld_a_frag(oa, dOs + qr * PD + 16 * kk, PD, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* vp = Vs + (8 * j + g) * PD + 16 * kk + 2 * t;
        mma_bf16_16816(dp[j], oa, ld_pair(vp), ld_pair(vp + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const float ev = bf(Pt[(qr + g + (hi ? 8 : 0)) * PP + 8 * j + 2 * t + (e & 1)]) *
                         (hi ? inv1 : inv0);
        dp[j][e] = round_bf16(ev * (dp[j][e] - (hi ? dd1 : dd0)));
      }

#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t bk[4];
        ld_b_frag2(bk, Ks, PD, 16 * kk, 8 * j, lane);
        mma_bf16_16816(gq[j], da, bk[0], bk[1]);
        mma_bf16_16816(gq[j + 1], da, bk[2], bk[3]);
      }
    }
  }

  const int r0 = q0 + qr + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(dq + (long long)r0 * D + c) =
          pack_bf16(round_bf16(gq[j][0]) * scale, round_bf16(gq[j][1]) * scale);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(dq + (long long)r1 * D + c) =
          pack_bf16(round_bf16(gq[j][2]) * scale, round_bf16(gq[j][3]) * scale);
  }
}

template <int D>
int launch_fwd_savep_mma(const void* qs, const void* k, const void* v, void* out, void* P,
                         float* inv, int BH, int N, int Np, cudaStream_t stream) {
  using T = __nv_bfloat16;
  attn_fwd_savep_mma_kernel<D><<<dim3((N + kVQ - 1) / kVQ, BH), kVT, 0, stream>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<T*>(P), inv, N, Np);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_savep_mma(const void* qs, const void* k, const void* v, const void* P,
                         const float* stats, const void* dout, void* dq, void* dk, void* dv,
                         int BH, int N, int Np, cudaStream_t stream) {
  using T = __nv_bfloat16;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  const dim3 grid((N + kVQ - 1) / kVQ, BH);
  const size_t s1 = savep_dkdv_mma_smem_bytes<D>(), s2 = savep_dq_mma_smem_bytes<D>();
  cudaFuncSetAttribute(attn_bwd_savep_dkdv_mma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  cudaFuncSetAttribute(attn_bwd_savep_dq_mma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  attn_bwd_savep_dkdv_mma_kernel<D><<<grid, kVT, s1, stream>>>(
      c(qs), c(v), c(P), stats, c(dout), static_cast<T*>(dk), static_cast<T*>(dv), N, Np);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  attn_bwd_savep_dq_mma_kernel<D><<<grid, kVT, s2, stream>>>(
      c(k), c(v), c(P), stats, c(dout), static_cast<T*>(dq), N, Np, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

#define VITOCM_SAVEP_MMA(D)                                                                   \
  template int launch_fwd_savep_mma<D>(const void*, const void*, const void*, void*, void*,   \
                                       float*, int, int, int, cudaStream_t);                  \
  template int launch_bwd_savep_mma<D>(const void*, const void*, const void*, const void*,    \
                                       const float*, const void*, void*, void*, void*, int,   \
                                       int, int, cudaStream_t);
VITOCM_SAVEP_MMA(64)
VITOCM_SAVEP_MMA(128)
#undef VITOCM_SAVEP_MMA

}  // namespace vitocm
