// bf16 variant of csrc/attention_savep.cu's forward on the tensor cores
// (mma.sync m16n8k16, f32 accumulation). Same contract and the TPU kernel's
// rounding points (ops/flash_attention.py::_attn_fwd_kernel with want_p):
// P = bf16(exp(s - m)) with m the true row max, o = (P V) / sum(P) rounded
// once, inv = 1 / sum(P) in f32 (the sum of the rounded P, as the TPU
// kernel's ones column of V sums it). The backward that reads P is
// attention_savep_bwd_wgmma.cu.
//
// A CTA owns 64 query rows, four warps of 16, Q as A fragments in registers
// (mma.cuh's A fragment). Pass 1 stages each 64-key K tile and keeps the
// row max of S = Q K^T (padded keys masked); pass 2 stages K and V,
// recomputes S, rounds P in registers, stores it to P (two bf16 a lane per
// fragment row) and re-packs it as the A operand of P V.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace vitocm {

constexpr int kVQ = 64;   // query rows per CTA
constexpr int kVK = 64;   // keys per forward tile
constexpr int kVT = 128;  // threads: four warps of 16 rows

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
int launch_fwd_savep_mma(const void* qs, const void* k, const void* v, void* out, void* P,
                         float* inv, int BH, int N, int Np, cudaStream_t stream) {
  using T = __nv_bfloat16;
  attn_fwd_savep_mma_kernel<D><<<dim3((N + kVQ - 1) / kVQ, BH), kVT, 0, stream>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<T*>(P), inv, N, Np);
  return (int)cudaGetLastError();
}

template int launch_fwd_savep_mma<64>(const void*, const void*, const void*, void*, void*,
                                      float*, int, int, int, cudaStream_t);
template int launch_fwd_savep_mma<128>(const void*, const void*, const void*, void*, void*,
                                       float*, int, int, int, cudaStream_t);

}  // namespace vitocm
