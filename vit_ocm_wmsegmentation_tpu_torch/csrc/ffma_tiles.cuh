// Register-tiled f32 products on the CUDA cores, and the cp.async staging
// that feeds them: the building blocks of the f32 attention kernels
// (attention_qkv.cu, attention_bwd.cu, attention_savep.cu) and of the f32
// MLP kernels (fused_mlp.cu, fused_mlp_bwd.cu).
//
// A CTA of NT threads splits into RG row groups of KG lanes each (KG
// divides 32, so the lanes of one row group sit in one warp and reduce a
// row with __shfl_xor_sync). Thread (rg, kg) owns rows rg + RG*i and either
// columns kg + KG*j of a score tile (tile_dot) or the float4 column groups
// 4*kg + 4*KG*c of an output tile (tile_pv; tile_tn, whose operands are
// stored k-major, also takes its rows in float4 groups). Every operand is
// read from shared memory as a float4: tile_dot reads its rows along the
// inner dimension, four steps a load, so a TR x TK micro-tile costs TR + TK
// loads for 4*TR*TK FFMA; with rows a multiple of 4 floats plus 4 apart
// (pitch D + 4) the rows a quarter-warp reads start in distinct 16-byte
// bank groups. Each sum runs over its inner index in order, so the results
// do not depend on the launch.
#pragma once

#include "common.cuh"

namespace vitocm {

__device__ __forceinline__ void ld4(float (&d)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// rows r0 .. r0 + ROWS - 1 of a (rows, D) f32 slice, `stride` floats a row
// (a multiple of 4, src 16-byte aligned), into dst with pitch P, in 16-byte
// cp.async copies; rows >= limit and columns >= cols (a multiple of 4) are
// written as zeros (source size 0). The caller commits the group.
template <int ROWS, int D, int P, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int limit,
                                           long long stride, int cols = D) {
  constexpr int CH = D / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = r0 + r < limit && c < cols;
    cp_async16(dst + r * P + c, src + (ok ? (long long)(r0 + r) * stride + c : 0), ok ? 16 : 0);
  }
}

// the two row statistics of query rows q0 .. q0 + BQ - 1 (attn_row_stats'
// rows `pitch` floats apart, pitch a multiple of 4) into r0_s and r1_s in
// 16-byte cp.async copies; chunks from N on are zeros, the rest of the last
// chunk is the rows' padding. The caller commits the group.
template <int BQ, int NT>
__device__ __forceinline__ void stage_stats(float* r0_s, float* r1_s, const float* st, int q0,
                                            int N, int pitch) {
  for (int i = threadIdx.x; i < BQ / 2; i += NT) {
    const int c = (i % (BQ / 4)) * 4, ok = q0 + c < N ? 16 : 0;
    const float* src = st + (i < BQ / 4 ? 0 : pitch) + (ok ? q0 + c : 0);
    cp_async16((i < BQ / 4 ? r0_s : r1_s) + c, src, ok);
  }
}

// acc[i][j] += sum over c < DEPTH of A[(rg + RG*i)*PA + c] * B[(kg + KG*j)*PB + c]
template <int TR, int TK, int RG, int KG, int DEPTH, int PA, int PB>
__device__ __forceinline__ void tile_dot(float (&acc)[TR][TK], const float* A, const float* B,
                                         int rg, int kg) {
#pragma unroll 4
  for (int c = 0; c < DEPTH; c += 4) {
    float a[TR][4], b[TK][4];
#pragma unroll
    for (int i = 0; i < TR; ++i) ld4(a[i], A + (rg + RG * i) * PA + c);
#pragma unroll
    for (int j = 0; j < TK; ++j) ld4(b[j], B + (kg + KG * j) * PB + c);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) acc[i][j] = fmaf(a[i][e], b[j][e], acc[i][j]);
  }
}

// acc[i][4*g + e] += sum over k < DEPTH of P[(rg + RG*i)*PP + k] * V[k*PV + 4*kg + 4*KG*g + e]
template <int TR, int TC, int RG, int KG, int DEPTH, int PP, int PV>
__device__ __forceinline__ void tile_pv(float (&acc)[TR][TC], const float* P, const float* V,
                                        int rg, int kg) {
#pragma unroll 4
  for (int k = 0; k < DEPTH; k += 4) {
    float p[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i) ld4(p[i], P + (rg + RG * i) * PP + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v[TC / 4][4];
#pragma unroll
      for (int g = 0; g < TC / 4; ++g) ld4(v[g], V + (k + e) * PV + 4 * kg + 4 * KG * g);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int g = 0; g < TC / 4; ++g)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[i][4 * g + f] = fmaf(p[i][e], v[g][f], acc[i][4 * g + f]);
    }
  }
}

// acc[4*a + e][4*g + f] += sum over k < DEPTH of
//   A[k*PA + 4*rg + 4*RG*a + e] * B[k*PB + 4*kg + 4*KG*g + f]:
// both operands k-major (a row per k), so one row of A and one of B are read
// as float4s each step, TR + TC floats for TR*TC FFMA
template <int TR, int TC, int RG, int KG, int DEPTH, int PA, int PB>
__device__ __forceinline__ void tile_tn(float (&acc)[TR][TC], const float* A, const float* B,
                                        int rg, int kg) {
#pragma unroll 4
  for (int k = 0; k < DEPTH; ++k) {
    float a[TR / 4][4], b[TC / 4][4];
#pragma unroll
    for (int i = 0; i < TR / 4; ++i) ld4(a[i], A + k * PA + 4 * rg + 4 * RG * i);
#pragma unroll
    for (int g = 0; g < TC / 4; ++g) ld4(b[g], B + k * PB + 4 * kg + 4 * KG * g);
#pragma unroll
    for (int i = 0; i < TR / 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int g = 0; g < TC / 4; ++g)
#pragma unroll
          for (int f = 0; f < 4; ++f)
            acc[4 * i + e][4 * g + f] = fmaf(a[i][e], b[g][f], acc[4 * i + e][4 * g + f]);
  }
}

// the sum or max of v over the KG lanes of a row group
template <int KG>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = KG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KG>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = KG / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace vitocm
