// bf16 variant of csrc/attention_bwd.cu on the tensor cores (mma.sync
// m16n8k16, f32 accumulation). Same contract, the same two deterministic
// kernels and the same rounding points as the TPU kernel
// (ops/flash_attention.py::_attn_bwd_kernel): e = exp(s - lse) in f32 from
// f32 scores, p = bf16(e) for dv, ds = bf16(e * (dp - D)), dk and dv
// accumulated in f32 over every q and rounded once, dq rounded, then scaled
// by d^-0.5 and rounded again.
//
// dk/dv kernel: a CTA owns 64 keys, four warps of 16 keys each, and walks
// the queries in tiles of QT (64 at d = 64, 32 at d = 128, which keeps the
// two 16 x d f32 accumulators and the score fragments of a warp in
// registers). Per tile a warp computes s^T = K Q^T and dp^T = V dO^T with
// K and V as A operands from shared memory, turns them into p and ds in
// registers, and re-packs those as A operands of dV += P^T dO and
// dK += dS^T Q (dO and Q through ldmatrix.trans), FlashAttention-2's
// layout trick applied to the transposed scores. dq kernel: a CTA owns 64
// queries and walks the keys in tiles of QT: s = Q K^T, dp = dO V^T,
// dQ += dS K. Bound: tensor-core issue, the shared-memory staging of each
// tile (not overlapped with compute yet), and the recomputation of s and
// dp in both kernels (14 N^2 d FLOPs against the 10 of one fused pass).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace vitocm {

constexpr int kBB = 64;   // keys (dk/dv kernel) or queries (dq kernel) per CTA
constexpr int kBT = 128;  // threads: four warps of 16 rows

template <int D>
constexpr int kBwdTile = D == 64 ? 64 : 32;

template <int D>
constexpr size_t bwd_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 2 * (kBB + kBwdTile<D>) * (D + 8) + sizeof(float) * 2 * kBB;
}

// rows r0 .. r0+rows-1 of one (N, D) slice into shared memory (pitch D+8),
// zeros past N, 16 bytes a load (from a clamped row, so no branch holds
// the loads back)
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                           int rows, int N) {
  for (int i = threadIdx.x; i < rows * D / 8; i += kBT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const uint4 val =
        *reinterpret_cast<const uint4*>(src + (long long)min(r0 + r, N - 1) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) =
        r0 + r < N ? val : make_uint4(0, 0, 0, 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kBT)
attn_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ stats,
                         const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int N) {
  constexpr int P = D + 8, QT = kBwdTile<D>, NJ = QT / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (BB keys, P)
  __nv_bfloat16* Vs = Ks + kBB * P;
  __nv_bfloat16* Qs = Vs + kBB * P;  // (QT queries, P)
  __nv_bfloat16* dOs = Qs + QT * P;
  float* lse_s = reinterpret_cast<float*>(dOs + QT * P);
  float* dd_s = lse_s + kBB;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBB, kr = warp * 16;  // this warp's keys: k0 + kr ..
  const long long off = (long long)blockIdx.y * N * D;
  qs += off; k += off; v += off; dout += off; dk += off; dv += off;
  stats += (long long)blockIdx.y * 2 * N;

  stage_rows<D>(Ks, k, k0, kBB, N);
  stage_rows<D>(Vs, v, k0, kBB, N);
  float gk[D / 8][4], gv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;

  for (int q0 = 0; q0 < N; q0 += QT) {
    __syncthreads();  // the previous q tile is consumed
    stage_rows<D>(Qs, qs, q0, QT, N);
    stage_rows<D>(dOs, dout, q0, QT, N);
    stage_row_stats(lse_s, dd_s, stats, q0, QT, N);
    __syncthreads();

    // s^T = K Q^T and dp^T = V dO^T: rows kr + g (+8), query columns 8j + 2t (+1)
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ld_a_frag(ka, Ks + kr * P + 16 * kk, P, g, t);
      ld_a_frag(va, Vs + kr * P + 16 * kk, P, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* qp = Qs + (8 * j + g) * P + 16 * kk + 2 * t;
        const __nv_bfloat16* op = dOs + (8 * j + g) * P + 16 * kk + 2 * t;
        mma_bf16_16816(s[j], ka, ld_pair(qp), ld_pair(qp + 8));
        mma_bf16_16816(dp[j], va, ld_pair(op), ld_pair(op + 8));
      }
    }
    // p = bf16(e) into s, ds = bf16(e (dp - D)) into dp
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const int key = k0 + kr + g + (e >> 1) * 8;
        const float ev = (q0 + qc < N && key < N) ? expf(s[j][e] - lse_s[qc]) : 0.f;
        s[j][e] = round_bf16(ev);
        dp[j][e] = round_bf16(ev * (dp[j][e] - dd_s[qc]));
      }

    // dV += P^T dO, dK += dS^T Q over the tile's QT/16 query steps
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
        ld_b_frag2(bo, dOs, P, 16 * kk, 8 * j, lane);
        ld_b_frag2(bq, Qs, P, 16 * kk, 8 * j, lane);
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
__global__ void __launch_bounds__(kBT)
attn_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ stats,
                       const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                       int N, float scale) {
  constexpr int P = D + 8, KT = kBwdTile<D>, NJ = KT / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (BB queries, P)
  __nv_bfloat16* dOs = Qs + kBB * P;
  __nv_bfloat16* Ks = dOs + kBB * P;  // (KT keys, P)
  __nv_bfloat16* Vs = Ks + KT * P;
  float* lse_s = reinterpret_cast<float*>(Vs + KT * P);
  float* dd_s = lse_s + kBB;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBB, qr = warp * 16;  // this warp's queries: q0 + qr ..
  const long long off = (long long)blockIdx.y * N * D;
  qs += off; k += off; v += off; dout += off; dq += off;
  stats += (long long)blockIdx.y * 2 * N;

  stage_rows<D>(Qs, qs, q0, kBB, N);
  stage_rows<D>(dOs, dout, q0, kBB, N);
  stage_row_stats(lse_s, dd_s, stats, q0, kBB, N);
  __syncthreads();
  const float lse0 = lse_s[qr + g], lse1 = lse_s[qr + g + 8];
  const float dd0 = dd_s[qr + g], dd1 = dd_s[qr + g + 8];
  const bool ok0 = q0 + qr + g < N, ok1 = q0 + qr + g + 8 < N;

  float gq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gq[j][e] = 0.f;

  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();  // the previous key tile is consumed
    stage_rows<D>(Ks, k, k0, KT, N);
    stage_rows<D>(Vs, v, k0, KT, N);
    __syncthreads();

    // s = Q K^T and dp = dO V^T: rows qr + g (+8), key columns 8j + 2t (+1)
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      ld_a_frag(qa, Qs + qr * P + 16 * kk, P, g, t);
      ld_a_frag(oa, dOs + qr * P + 16 * kk, P, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* kp = Ks + (8 * j + g) * P + 16 * kk + 2 * t;
        const __nv_bfloat16* vp = Vs + (8 * j + g) * P + 16 * kk + 2 * t;
        mma_bf16_16816(s[j], qa, ld_pair(kp), ld_pair(kp + 8));
        mma_bf16_16816(dp[j], oa, ld_pair(vp), ld_pair(vp + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const bool ok = (hi ? ok1 : ok0) && k0 + 8 * j + 2 * t + (e & 1) < N;
        const float ev = ok ? expf(s[j][e] - (hi ? lse1 : lse0)) : 0.f;
        dp[j][e] = round_bf16(ev * (dp[j][e] - (hi ? dd1 : dd0)));
      }

    // dQ += dS K over the tile's KT/16 key steps
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t bk[4];
        ld_b_frag2(bk, Ks, P, 16 * kk, 8 * j, lane);
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
int launch_attn_bwd_mma(const void* qs, const void* k, const void* v, const float* stats,
                        const void* dout, void* dq, void* dk, void* dv, int BH, int N,
                        cudaStream_t stream) {
  using T = __nv_bfloat16;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  const dim3 grid((N + kBB - 1) / kBB, BH);
  const size_t smem = bwd_mma_smem_bytes<D>();
  cudaFuncSetAttribute(attn_bwd_dkdv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cudaFuncSetAttribute(attn_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  attn_bwd_dkdv_mma_kernel<D><<<grid, kBT, smem, stream>>>(
      c(qs), c(k), c(v), stats, c(dout), static_cast<T*>(dk), static_cast<T*>(dv), N);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  attn_bwd_dq_mma_kernel<D><<<grid, kBT, smem, stream>>>(
      c(qs), c(k), c(v), stats, c(dout), static_cast<T*>(dq), N, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template int launch_attn_bwd_mma<64>(const void*, const void*, const void*, const float*,
                                     const void*, void*, void*, void*, int, int, cudaStream_t);
template int launch_attn_bwd_mma<128>(const void*, const void*, const void*, const float*,
                                      const void*, void*, void*, void*, int, int, cudaStream_t);

}  // namespace vitocm
