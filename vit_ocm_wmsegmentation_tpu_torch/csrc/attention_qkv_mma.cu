// bf16 variant of csrc/attention_qkv.cu on the tensor cores (mma.sync
// m16n8k16, f32 accumulation). Same contract, layouts (attention.cuh) and
// numerics: f32 scores, an online softmax over 64-key tiles shifted by the
// running row max, P rounded to bf16 before P.V, the denominator summed
// from the rounded P and clamped at 1e-35, lse = max + log(sum) in f32,
// keys >= n masked. Replaces the same TPU kernel on its logsumexp route
// (ops/flash_attention.py::_attn_fwd_kernel, the training forward) for bf16
// storage, folded layout only: the flat inference layout
// (_attn_fwd_qkvflat_kernel) takes attention_qkv_wgmma.cu; f32 storage keeps
// the CUDA-core kernel, which never rounds through TF32.
//
// A CTA owns (batch, head, 64 query rows), four warps of 16 rows each. Each
// warp keeps its Q rows as A fragments in registers; per 64-key tile the K
// and V rows are staged in shared memory (18 KB at d = 64, 34 KB at
// d = 128, padded rows so fragment loads hit 32 banks), S = Q K^T is
// 8 * d/16 mma per warp, the softmax runs on the S fragments (a row's 64
// scores live in the 4 lanes of a quad), the rounded P is re-packed in
// registers as the A operand of P.V (FlashAttention-2's layout trick), and
// V's B fragments come from ldmatrix.trans. The score tile never leaves
// registers; at d = 128 a thread holds a 64-float O accumulator. Bound:
// tensor-core issue and the K/V staging (not overlapped with compute yet).

#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace vitocm {

constexpr int kAQ = 64;   // query rows per CTA (16 per warp)
constexpr int kAK = 64;   // keys per tile
constexpr int kAT = 128;  // threads

// at most 128 (d = 64) or 168 (d = 128) registers a thread, so that 4 or 3
// CTAs fit an SM's 64 K registers: at 134 registers the d = 64 kernel held
// 3 CTAs an SM and ran 8 % slower (H100, 1152^2 mosaic shapes)
template <int D, bool FOLDED>
__global__ void __launch_bounds__(kAT, D == 64 ? 4 : 3)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int N, int n, int nh) {
  constexpr int P = D + 8;  // padded pitch of the K and V tiles
  constexpr int KD = D / 16;
  __shared__ __align__(16) __nv_bfloat16 Ks[kAK * P];
  __shared__ __align__(16) __nv_bfloat16 Vs[kAK * P];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int hh = blockIdx.y, b = blockIdx.z;
  const AttnRows<__nv_bfloat16, D, FOLDED> L(q, k, v, out, N, nh, b, hh);
  const long long rs = L.rs;
  const __nv_bfloat16 *qb = L.q, *kb = L.k, *vb = L.v;
  const int q0 = blockIdx.x * kAQ + warp * 16;  // this warp's first row

  // Q rows q0 + g and q0 + g + 8 as A fragments over the d/16 d-steps
  uint32_t qa[KD][4];
  {
    const int r0 = q0 + g, r1 = q0 + g + 8;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = 16 * kk + 2 * t;
      qa[kk][0] = r0 < N ? ld_pair(qb + r0 * rs + c) : 0u;
      qa[kk][1] = r1 < N ? ld_pair(qb + r1 * rs + c) : 0u;
      qa[kk][2] = r0 < N ? ld_pair(qb + r0 * rs + c + 8) : 0u;
      qa[kk][3] = r1 < N ? ld_pair(qb + r1 * rs + c + 8) : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g, g + 8
  float l0 = 0.f, l1 = 0.f;               // this lane's share of the row sums

  for (int k0 = 0; k0 < n; k0 += kAK) {
    __syncthreads();  // the previous tile's K and V are consumed
    for (int i = tid; i < kAK * D / 8; i += kAT) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8, key = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < n) {
        kv = *reinterpret_cast<const uint4*>(kb + key * rs + c);
        vv = *reinterpret_cast<const uint4*>(vb + key * rs + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * P + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * P + c) = vv;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* bp = Ks + (8 * j + g) * P + 16 * kk + 2 * t;
        mma_bf16_16816(s[j], qa[kk], ld_pair(bp), ld_pair(bp + 8));
      }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + 8 * j + 2 * t;
      if (key >= n) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= n) s[j][1] = s[j][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = round_bf16(expf(s[j][0] - mn0));
      s[j][1] = round_bf16(expf(s[j][1] - mn0));
      s[j][2] = round_bf16(expf(s[j][2] - mn1));
      s[j][3] = round_bf16(expf(s[j][3] - mn1));
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

    // O += P V over the tile's 4 key-steps of 16; the S fragments of key
    // tiles 2kk and 2kk+1 are exactly P's A fragment for key-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t vf[4];
        ld_b_frag2(vf, Vs, P, 16 * kk, 8 * j, lane);
        mma_bf16_16816(o[j], pa, vf[0], vf[1]);
        mma_bf16_16816(o[j + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + g, r1 = q0 + g + 8;
  if (FOLDED && t == 0) {  // only the training route keeps the logsumexp
    float* lrow = lse + ((long long)b * nh + hh) * N;
    if (r0 < N) lrow[r0] = m0 + logf(l0);
    if (r1 < N) lrow[r1] = m1 + logf(l1);
  }
  l0 = fmaxf(l0, 1e-35f);
  l1 = fmaxf(l1, 1e-35f);
  __nv_bfloat16* ob = L.out;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + r0 * L.os + c) = pack_bf16(o[j][0] / l0, o[j][1] / l0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + r1 * L.os + c) = pack_bf16(o[j][2] / l1, o[j][3] / l1);
  }
}

template <int D, bool FOLDED>
int launch_attention_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int B, int N, int n, int nh, cudaStream_t stream) {
  using T = __nv_bfloat16;
  dim3 grid((N + kAQ - 1) / kAQ, nh, B);
  attention_mma_kernel<D, FOLDED><<<grid, kAT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, N, n, nh);
  return (int)cudaGetLastError();
}

#define VITOCM_ATTN_MMA(D, FOLDED)                                                          \
  template int launch_attention_mma<D, FOLDED>(const void*, const void*, const void*, void*, \
                                               float*, int, int, int, int, cudaStream_t);
VITOCM_ATTN_MMA(64, true)
VITOCM_ATTN_MMA(128, true)
#undef VITOCM_ATTN_MMA

}  // namespace vitocm
