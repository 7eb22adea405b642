// Multi-head softmax attention forward, f32 storage, CUDA cores.
//
// Replaces two TPU kernels of vit_ocm_wmsegmentation_tpu/ops/
// flash_attention.py (layouts in attention.cuh):
//   * _attn_fwd_qkvflat_kernel (attention_qkv, inference): read straight
//     from the fused qkv projection, q section already scaled by 1/sqrt(d);
//   * _attn_fwd_kernel on its logsumexp route (_flash_fwd with want_lse,
//     training): folded (B*h, N, d) q, k, v, q already scaled and rounded by
//     the wrapper, plus the f32 logsumexp the backward recomputes P from.
// Head dims 64 (every DINO ViT) and 128 (the MIM ViT).
//
// The TPU kernels keep whole (Np, Np) f32 score matrices on chip (about 60
// MB at the mosaic's Np = 2432), far past an SM's 227 KB of shared memory.
// Here one CTA of 256 threads owns (batch, head, 128 query rows) and walks
// the keys in tiles with an online softmax, so nothing but q, k, v, out and
// lse touches device memory. The products run in exact f32 on the CUDA
// cores (FFMA, no TF32, no tensor-core instruction): 4 N^2 d flops against
// 67 TFLOP/s. What bounds it is the path from shared memory to registers:
// an SM moves 32 floats a cycle there and issues 128 FFMA, so a micro-tile
// of R x C outputs, which loads R + C floats for R * C FFMA, keeps the FFMA
// pipes fed only from R * C / (R + C) = 4 on (8 x 8). The design:
//   * register micro-tiles read as float4 (ffma_tiles.cuh), 16 row groups
//     of 16 lanes: a thread holds the scores of 8 rows x TK keys and the
//     output of the same 8 rows x d/16 columns; d = 64: 128-key tiles, 8 x 8
//     scores and 8 x 4 outputs; d = 128: 64-key tiles, 8 x 4 scores and
//     8 x 8 outputs (8 x 8 scores would need 128-key tiles, 344 KB);
//   * K and V tiles come in 16-byte cp.async copies through a ring of three
//     slots that holds K_t, V_t and K_t+1 in turn, so each copy has a whole
//     phase (S or P.V) to land; the ragged last tile is zero-filled through
//     the copy's source size;
//   * the softmax stays in registers: the 16 lanes of a row are one warp's,
//     so max and sum reduce with shuffles, and P is written to shared memory
//     once, in the rows the P.V micro-tile reads as float4. Two barriers a
//     key tile.
// Shared memory: Q (128 x (d + 4)), three K/V slots, P (128 x (tile +
// 16)): 208 KB at d = 64, 205 KB at d = 128. One CTA an SM, 8 warps; on
// the H100 more warps with smaller micro-tiles (512 threads, or two CTAs of
// 64 rows) ran slower, and so did two groups of 4 warps a phase apart (one
// group's softmax beside the other's P.V). bf16 storage, both layouts, takes the wgmma kernel of
// attention_qkv_wgmma.cu.
//
// Numerics, kept from the TPU kernels: scores, P and accumulators in f32
// (the TPU kernels' rounding of P to the storage type is the identity in
// f32); expf and logf; the denominator is the sum of P, clamped at 1e-35
// for the division; lse = max + log(sum). Deliberate differences: the TPU
// kernels shift exp by the whole row's max (or by the Cauchy-Schwarz bound
// |q|*max|k|); this kernel shifts by the running row max, as the online
// softmax must: it is the same softmax. The key tile is 128 at d = 64, not
// the twin's KEY_TILE = 64: in f32 P is never rounded, so the tile changes
// only the order of the sums, which the 1e-5 tolerance covers; the twin
// keeps 64 because bf16 rounds P per tile and the wgmma kernel's tile is
// 64. The keys' ragged last tile is masked here: the port's token stream is
// not padded to a tile multiple.

#include <math.h>

#include "attention.cuh"
#include "common.cuh"
#include "ffma_tiles.cuh"

namespace vitocm {

constexpr int kFT = 256;  // threads

// query rows a CTA, keys a tile, row groups, lanes a row group
template <int D>
struct FwdTiles;
template <>
struct FwdTiles<64> {
  static constexpr int BQ = 128, BK = 128, RG = 16, KG = 16;
};
template <>
struct FwdTiles<128> {
  static constexpr int BQ = 128, BK = 64, RG = 16, KG = 16;
};
constexpr int kFSlots = 3;  // the K/V ring: K_t, V_t, K_t+1 or V_t, K_t+1, V_t+1

template <int D>
constexpr size_t attn_f32_smem_bytes() {
  using T = FwdTiles<D>;
  return sizeof(float) * ((T::BQ + kFSlots * T::BK) * (D + 4) + T::BQ * (T::BK + T::KG));
}

template <int D, bool FOLDED>
__global__ void __launch_bounds__(kFT, 1)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int N, int n, int nh) {
  using T = FwdTiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, RG = T::RG, KG = T::KG;
  constexpr int TR = BQ / RG, TK = BK / KG, TC = D / KG;
  constexpr int PQ = D + 4, PP = BK + KG;  // PP: a warp's P stores hit distinct banks
  static_assert(RG * KG == kFT && TR * RG == BQ && TK * KG == BK && TC % 4 == 0 && 32 % KG == 0,
                "tile shape");
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                      // (BQ, PQ)
  float* ring = Qs + BQ * PQ;          // (slots, BK, PQ): K_0, V_0, K_1, V_1, ... in turn
  float* Ps = ring + kFSlots * BK * PQ;  // (BQ, PP)
  auto slot = [&](int i) { return ring + (i % kFSlots) * BK * PQ; };

  const int lane = threadIdx.x & 31;
  const int kg = lane % KG, rg = (threadIdx.x >> 5) * (32 / KG) + lane / KG;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const AttnRows<float, D, FOLDED> L(q, k, v, out, N, nh, b, hh);
  const int tiles = (n + BK - 1) / BK;

  stage_rows<BQ, D, PQ, kFT>(Qs, L.q, q0, N, L.rs);
  stage_rows<BK, D, PQ, kFT>(slot(0), L.k, 0, n, L.rs);
  cp_async_commit();
  stage_rows<BK, D, PQ, kFT>(slot(1), L.v, 0, n, L.rs);
  cp_async_commit();

  float o[TR][TC], m_run[TR], l_run[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) o[i][c] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<1>();
    __syncthreads();  // K_t has landed; V_t-1 and P are consumed
    if (t + 1 < tiles) stage_rows<BK, D, PQ, kFT>(slot(2 * t + 2), L.k, (t + 1) * BK, n, L.rs);
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
        if (k0 + kg + KG * j >= n) s[i][j] = -INFINITY;
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
      const float alpha = expf(m_run[i] - m_new);  // 0 on the first tile
      l_run[i] = l_run[i] * alpha + group_sum<KG>(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < TC; ++c) o[i][c] *= alpha;
    }
    cp_async_wait<1>();
    __syncthreads();  // V_t has landed; P is written; K_t is consumed
    if (t + 1 < tiles) stage_rows<BK, D, PQ, kFT>(slot(2 * t + 3), L.v, (t + 1) * BK, n, L.rs);
    cp_async_commit();
    tile_pv<TR, TC, RG, KG, BK, PP, PQ>(o, Ps, slot(2 * t + 1), rg, kg);
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + rg + RG * i;
    if (row >= N) continue;
    const float l = fmaxf(l_run[i], 1e-35f);
    float* orow = L.out + row * L.os + 4 * kg;
#pragma unroll
    for (int g = 0; g < TC / 4; ++g)
      st4(orow + 4 * KG * g, o[i][4 * g] / l, o[i][4 * g + 1] / l, o[i][4 * g + 2] / l,
          o[i][4 * g + 3] / l);
    if (FOLDED && kg == 0)  // only the training route keeps the logsumexp
      lse[((long long)b * nh + hh) * N + row] = m_run[i] + logf(l_run[i]);
  }
}

template <int D, bool FOLDED>
static int launch_attention(const void* q, const void* k, const void* v, void* out, float* lse,
                            int B, int N, int n, int nh, cudaStream_t stream) {
  const size_t smem = attn_f32_smem_bytes<D>();
  auto kern = attention_f32_kernel<D, FOLDED>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((N + FwdTiles<D>::BQ - 1) / FwdTiles<D>::BQ, nh, B);
  kern<<<grid, kFT, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                    static_cast<const float*>(v), static_cast<float*>(out), lse,
                                    N, n, nh);
  return (int)cudaGetLastError();
}

// bf16 storage takes the wgmma kernel of attention_qkv_wgmma.cu: the folded
// (training) layout through here, the flat one through its own entry point,
// vitocm_attention_qkv_wgmma
template <int D, bool FOLDED>
int launch_attention_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                           int B, int N, int n, int nh, cudaStream_t stream);

template <bool FOLDED>
static int launch_any(int dtype, int d, const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int N, int n, int nh, cudaStream_t s) {
  if (n < 1 || n > N || B < 1 || nh < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kF32 && d == 64)
    return launch_attention<64, FOLDED>(q, k, v, out, lse, B, N, n, nh, s);
  if (dtype == kF32 && d == 128)
    return launch_attention<128, FOLDED>(q, k, v, out, lse, B, N, n, nh, s);
  if constexpr (FOLDED) {
    if (dtype == kBF16 && d == 64)
      return launch_attention_wgmma<64, true>(q, k, v, out, lse, B, N, n, nh, s);
    if (dtype == kBF16 && d == 128)
      return launch_attention_wgmma<128, true>(q, k, v, out, lse, B, N, n, nh, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace vitocm

// Inference route, f32 (bf16: vitocm_attention_qkv_wgmma): qkv (B, N,
// 3*nh*d), out (B, N, nh*d); keys masked at rows >= n. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int vitocm_attention_qkv(int dtype, const void* qkv, void* out, int B, int N, int n,
                                    int nh, int head_dim, void* stream) {
  using namespace vitocm;
  return launch_any<false>(dtype, head_dim, qkv, nullptr, nullptr, out, nullptr, B, N, n, nh,
                           static_cast<cudaStream_t>(stream));
}

// Training route: q (already scaled), k, v, out (BH, N, d) contiguous; lse
// (BH, N) f32. Returns cudaGetLastError() after the launch.
extern "C" int vitocm_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                                void* lse, int BH, int N, int head_dim, void* stream) {
  using namespace vitocm;
  return launch_any<true>(dtype, head_dim, q, k, v, out, static_cast<float*>(lse), BH, N, N, 1,
                          static_cast<cudaStream_t>(stream));
}
