// Attention on Hopper's warpgroup tensor cores, bf16 storage: wgmma fed by
// TMA through an mbarrier ring. One kernel, two layouts (attention.cuh),
// chosen at compile time:
//   * FOLDED = false, inference: straight from the fused qkv projection
//     (B, N, 3*nh*D), q section pre-scaled, out (B, N, nh*D), keys at rows
//     >= n masked. Replaces vit_ocm_wmsegmentation_tpu/ops/flash_attention.py
//     ::_attn_fwd_qkvflat_kernel (attention_qkv).
//   * FOLDED = true, training: q (pre-scaled), k, v and out (BH, N, D), and
//     the f32 logsumexp lse (BH, N) = max + log(sum), written before the
//     sum's clamp. Replaces ::_attn_fwd_kernel on its lse route
//     (flash_attention, the forward of flash_attention_trainable).
// Head dims 64 (every DINO ViT) and 128 (the MIM ViT).
//
// Numerics of the twin (ops/flash_attention.py::_softmax_tiles): f32 scores,
// an online softmax over 64-key tiles shifted by the running row max, expf,
// P rounded to bf16 before P.V, the denominator summed from the rounded P
// and clamped at 1e-35. Only the order of the f32 sums inside each product
// differs. (exp as ex2.approx of x log2 e is faster on an H100 but moved the
// seed-0 bf16 mask gate of chip_smoke.py under its 0.99: not taken.)
//
// What bounds it on the H100: at the mosaic's (49, 2305, 3*384), 400 GFLOP of
// products (0.40 ms at 989 TFLOP/s) and 1.7 G exp (0.46 ms on the SFU's 16
// a clock an SM); at the MIM step's folded (48, 2305, 128), 131 GFLOP (0.13
// ms) and 0.26 G exp (0.07 ms). The bytes are far below either. The
// mma.sync kernels this replaced copied K and V with all threads between two
// __syncthreads (tensor cores idle) and re-read each head's K and V once per
// 64 query rows. Here a CTA owns 128 query rows of one (batch, head) flat
// or one batch*head folded: two consumer warpgroups of 64 rows each and one
// producer warp. The producer loads the CTA's Q once and then keeps K and V
// tiles (64 keys x D) in flight with TMA into a ring of stages (3 at D = 64,
// 2 at D = 128), each guarded by a "full" mbarrier (its bytes arrived) and
// an "empty" one (all 8 consumer warps done with it). TMA reads through 3-D
// maps, over (B, N, 3*nh*D) or over each of the folded q, k, v, with 64 x 64
// boxes and the 128-byte swizzle; rows past N read as 0, so the ragged last
// tile needs no copy code. Per tile a consumer warpgroup computes S = Q K^T with wgmma
// (both operands from shared memory, K-major), runs the softmax on the S
// accumulators (a row's 64 scores in the 4 lanes of a quad; P rounded and
// packed once, as the A operand and for the row sums; a warp whose rows kept
// their max skips the rescale of O, a x 1), and O += P V with P as the
// register A operand and V read MN-major from shared memory. Two CTAs fit an
// SM at D = 64 (66 KB of shared memory, 96 registers a thread), so one
// warpgroup's softmax overlaps another's products. At D = 64 a last key tile
// of at most 8 keys (the mosaic's 2305 = 36 x 64 + 1) runs alone: S over 8
// keys (m64n8k16) and one k-step of P V; its other keys are masked, so their
// P is 0 and they add 0 to the row sums and nothing to O, and the bits are
// those of the whole tile (2-3 % off the flat call at the mosaic's shape).
//
// Where the time goes at D = 64 (the flat call at the mosaic's shape, H100 at
// its 700 W limit, ~1.78 GHz): ~830 clocks of an SM per warpgroup-tile (64
// rows x 64 keys) against ~256 of tensor cores, ~270 of SFU (34 MUFU a
// thread) and ~520 of issue (~16 instructions an element: expf's 9, the max,
// the bf16 pack, the unpacked row sums, the zeroed S). No single unit bounds
// it: exp as ex2.approx (40 % fewer softmax instructions) took 12 % off, and
// packing P without F2FP nothing. What holds it is the latency of each
// warpgroup's S -> softmax -> P.V chain, hidden only by the other three
// consumer warpgroups of the SM; two CTAs keep their warpgroups' phases apart,
// where warpgroups sharing one K/V ring fall into step. Slower on an H100, all
// with the same bits: sharing each K/V tile between the CTAs of a cluster by
// TMA multicast; 4 stages; 3 or 4 consumer warpgroups a CTA; a producer
// warpgroup giving the consumers its registers (setmaxnreg) so that each
// warpgroup's softmax runs under its own products, with two score tiles (S(t
// + 1) and P(t - 1).V(t - 1) under the softmax of tile t: 2 warpgroups at 240
// registers, +11 %; at 160 ptxas serializes the wgmma for want of registers)
// or with S(t + 1) and P(t).V(t) issued together (3 warpgroups at 160: +1-3
// %; 4 at 112 spill: +7 %); the same with a ping-pong of two warpgroups by
// named barriers (+12 %), with P staged in shared memory for two CTAs an SM
// at 104 registers (+6-10 %), with Q in registers (+5-12 %), and with
// 128-key score tiles (+3 %); a persistent grid of one or two CTAs an SM
// walking the units in a fixed order (+2-5 % against the same kernel on the
// hardware's grid); one consumer warpgroup a CTA, three or four CTAs an SM
// (+0-6 %); and skipping the softmax of a warp whose rows all lie past N
// (it spills at the 96 registers two CTAs an SM allow: +10 %). At D = 128,
// one CTA an SM already, issuing the next tile's S before this tile's
// softmax ran slower too.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kWG = 2;                      // consumer warpgroups, 64 query rows each
constexpr int kWQ = 64 * kWG;               // query rows per CTA
constexpr int kWK = 64;                     // keys per tile
constexpr int kWThreads = 128 * kWG + 32;   // the consumers + the producer warp

template <int D>
struct AttnWgmma {
  static constexpr int CH = D / 64;              // 64-column (128-byte) chunks
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int Q_BYTES = CH * kWQ * 128;  // chunk c: kWQ rows at c * kWQ * 128
  static constexpr int KV_BYTES = CH * kWK * 128; // K (or V) of one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
};

// S = Q K^T of one tile, issued (not waited for): 64 rows x 64 keys
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[32], const unsigned char* qw,
                                             const unsigned char* ks) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk >> 2, off = (kk & 3) * 32;
    wgmma_ss_m64n64k16(sc, desc_k128(qw + c * kWQ * 128 + off), desc_k128(ks + c * kWK * 128 + off));
  }
  wgmma_commit();
}

// The online softmax of one score tile (keys k0 .., masked at n): updates
// the running max m and sum l of rows g, g + 8, returns P rounded to bf16
// and packed in pairs (the A operand of P.V) and the rescale factors a.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], int k0, int n, int t4, float& m0,
                                             float& m1, float& l0, float& l1, uint32_t (&p01)[8],
                                             uint32_t (&p23)[8], float& a0, float& a1) {
  // sc[4j + e]: row g + 8 (e >> 1), key k0 + 8j + 2 t4 + (e & 1)
  if (k0 + kWK > n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + 8 * j + 2 * t4;
      if (key >= n) sc[4 * j] = sc[4 * j + 2] = -INFINITY;
      if (key + 1 >= n) sc[4 * j + 1] = sc[4 * j + 3] = -INFINITY;
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  a0 = expf(m0 - mn0);  // 0 on the first tile
  a1 = expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p01[j] = pack_bf16(expf(sc[4 * j] - mn0), expf(sc[4 * j + 1] - mn0));
    p23[j] = pack_bf16(expf(sc[4 * j + 2] - mn1), expf(sc[4 * j + 3] - mn1));
    sum0 += __uint_as_float(p01[j] << 16) + __uint_as_float(p01[j] & 0xffff0000u);
    sum1 += __uint_as_float(p23[j] << 16) + __uint_as_float(p23[j] & 0xffff0000u);
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// O = O * a + P V of one tile, issued (not waited for); x 1 changes no bit,
// so a warp whose rows kept their max skips the rescale
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 64][32], const uint32_t (&p01)[8],
                                         const uint32_t (&p23)[8], float a0, float a1,
                                         const unsigned char* vs) {
  if (!__all_sync(0xffffffffu, a0 == 1.f && a1 == 1.f)) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= a0;
        o[c][4 * j + 1] *= a0;
        o[c][4 * j + 2] *= a1;
        o[c][4 * j + 3] *= a1;
      }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // key-step kk: columns 16 kk .. 16 kk + 15
    const uint32_t pa[4] = {p01[2 * kk], p23[2 * kk], p01[2 * kk + 1], p23[2 * kk + 1]};
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      wgmma_rs_m64n64k16<1>(o[c], pa, desc_mn128(vs + c * kWK * 128 + kk * 16 * 128, kWK * 128));
  }
  wgmma_commit();
}

// A last tile of at most 8 keys (k0 .. n - 1) at D = 64, with the arithmetic
// of softmax_tile and issue_pv on the whole tile: its keys at or past n are
// masked, so their P is 0, they add 0 to the row sums and nothing to O.
// S over 8 keys (m64n8k16), P.V over the first 16 (one k-step), waited for.
__device__ __forceinline__ void last_tile_k8(float (&o)[32], const unsigned char* qw,
                                             const unsigned char* st, int k0, int n, int t4,
                                             float& m0, float& m1, float& l0, float& l1) {
  float sc[4] = {0.f, 0.f, 0.f, 0.f};  // rows g, g + 8; keys k0 + 2 t4, + 1
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_m64n8k16<0, 0>(sc, desc_k128(qw + kk * 32), desc_k128(st + kk * 32));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  const int key = k0 + 2 * t4;
  if (key >= n) sc[0] = sc[2] = -INFINITY;
  if (key + 1 >= n) sc[1] = sc[3] = -INFINITY;
  float mx0 = fmaxf(-INFINITY, fmaxf(sc[0], sc[1]));
  float mx1 = fmaxf(-INFINITY, fmaxf(sc[2], sc[3]));
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  const uint32_t p01 = pack_bf16(expf(sc[0] - mn0), expf(sc[1] - mn0));
  const uint32_t p23 = pack_bf16(expf(sc[2] - mn1), expf(sc[3] - mn1));
  float sum0 = 0.f, sum1 = 0.f;
  sum0 += __uint_as_float(p01 << 16) + __uint_as_float(p01 & 0xffff0000u);
  sum1 += __uint_as_float(p23 << 16) + __uint_as_float(p23 & 0xffff0000u);
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
  if (!__all_sync(0xffffffffu, a0 == 1.f && a1 == 1.f)) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
  }
  const uint32_t pa[4] = {p01, p23, 0u, 0u};
  wgmma_fence();
  wgmma_rs_m64n64k16<1>(o, pa, desc_mn128(st + kWK * 128, kWK * 128));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// q_map, k_map, v_map: the one qkv map three times (flat), or the maps of
// the folded q, k, v (nh = 1); lse only with FOLDED
template <int D, bool FOLDED>
__global__ void __launch_bounds__(kWThreads, D == 64 ? 2 : 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int N, int n,
                       int nh) {
  using C = AttnWgmma<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ring = qs + C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hh = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kWQ;
  const int tiles = (n + kWK - 1) / kWK;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);  // every consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kWG) {  // producer: one lane issues every copy
    if (lane == 0) {
      // first column of this head's q, k, v in its map
      const int qc = FOLDED ? 0 : hh * D, kc = FOLDED ? 0 : (nh + hh) * D,
                vc = FOLDED ? 0 : (2 * nh + hh) * D;
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < C::CH; ++c)
        for (int r = 0; r < kWQ; r += 64)
          tma_load_3d(qs + c * kWQ * 128 + r * 128, &q_map, qbar, qc + 64 * c, q0 + r, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % C::STAGES;
        mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        for (int c = 0; c < C::CH; ++c) {
          tma_load_3d(st + c * kWK * 128, &k_map, &full[s], kc + 64 * c, t * kWK, b);
          tma_load_3d(st + C::KV_BYTES + c * kWK * 128, &v_map, &full[s], vc + 64 * c,
                      t * kWK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg ..; warp wl of it owns rows
  // 16 wl + g and 16 wl + g + 8 of those. A warpgroup with no row below N
  // only releases the tiles.
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const bool live = q0 + 64 * wg < N;
  const unsigned char* qw = qs + wg * 64 * 128;
  float o[C::CH][32];
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g, g + 8
  float l0 = 0.f, l1 = 0.f;               // this lane's share of the row sums
  auto stage = [&](int t) { return ring + (t % C::STAGES) * C::STAGE_BYTES; };
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(&empty[t % C::STAGES]);
  };
  auto await = [&](int t) { mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1); };
  mbar_wait(qbar, 0);

  if (!live) {
    for (int t = 0; t < tiles; ++t) {
      await(t);
      release(t);
    }
    return;
  }
  // at D = 64 a last tile of at most 8 keys runs alone, after the others
  const int whole = D == 64 && n - (tiles - 1) * kWK <= 8 ? tiles - 1 : tiles;
  for (int t = 0; t < whole; ++t) {
    await(t);
    float sc[32];
    issue_scores<D>(sc, qw, stage(t));
    wgmma_wait<0>();
    fence_regs(sc);
    uint32_t p01[8], p23[8];
    float a0, a1;
    softmax_tile(sc, t * kWK, n, t4, m0, m1, l0, l1, p01, p23, a0, a1);
    issue_pv<D>(o, p01, p23, a0, a1, stage(t) + C::KV_BYTES);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::CH; ++c) fence_regs(o[c]);
    release(t);
  }
  if constexpr (D == 64) {
    if (whole < tiles) {
      await(whole);
      last_tile_k8(o[0], qw, stage(whole), whole * kWK, n, t4, m0, m1, l0, l1);
      release(whole);
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + 64 * wg + 16 * wl + g, r1 = r0 + 8;
  if (FOLDED && t4 == 0) {  // the training route keeps the logsumexp
    float* lrow = lse + (long long)b * N;
    if (r0 < N) lrow[r0] = m0 + logf(l0);
    if (r1 < N) lrow[r1] = m1 + logf(l1);
  }
  l0 = fmaxf(l0, 1e-35f);
  l1 = fmaxf(l1, 1e-35f);
  const long long os = (long long)nh * D;
  __nv_bfloat16* ob = out + (long long)b * N * os + hh * D;
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * t4;
      if (r0 < N)
        *reinterpret_cast<uint32_t*>(ob + r0 * os + col) =
            pack_bf16(o[c][4 * j] / l0, o[c][4 * j + 1] / l0);
      if (r1 < N)
        *reinterpret_cast<uint32_t*>(ob + r1 * os + col) =
            pack_bf16(o[c][4 * j + 2] / l1, o[c][4 * j + 3] / l1);
    }
}

// flat: q is the fused qkv (B, N, 3*nh*D), k and v unused; folded: q, k, v
// (B, N, D) with nh = 1, n = N
template <int D, bool FOLDED>
int launch_attention_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                           int B, int N, int n, int nh, cudaStream_t stream) {
  using C = AttnWgmma<D>;
  const uint64_t cols = FOLDED ? D : 3ull * nh * D;
  const uint64_t dims[3] = {cols, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {cols * 2, cols * 2 * N};
  const uint32_t box[3] = {64, kWK, 1};
  CUtensorMap maps[3];
  const void* bases[3] = {q, FOLDED ? k : q, FOLDED ? v : q};
  for (int i = 0; i < 3; ++i)
    if (!make_tmap_bf16(&maps[i], bases[i], 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  auto kern = attention_wgmma_kernel<D, FOLDED>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  dim3 grid((N + kWQ - 1) / kWQ, nh, B);
  kern<<<grid, kWThreads, C::SMEM, stream>>>(maps[0], maps[1], maps[2],
                                             static_cast<__nv_bfloat16*>(out), lse, N, n, nh);
  return (int)cudaGetLastError();
}

// the training route's entry (attention_qkv.cu, vitocm_flash_fwd)
template int launch_attention_wgmma<64, true>(const void*, const void*, const void*, void*,
                                              float*, int, int, int, int, cudaStream_t);
template int launch_attention_wgmma<128, true>(const void*, const void*, const void*, void*,
                                               float*, int, int, int, int, cudaStream_t);

}  // namespace vitocm

// Inference route, bf16: qkv (B, N, 3*nh*d) 16-byte aligned, out (B, N,
// nh*d); keys masked at rows >= n; d in {64, 128}. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int vitocm_attention_qkv_wgmma(const void* qkv, void* out, int B, int N, int n, int nh,
                                          int head_dim, void* stream) {
  using namespace vitocm;
  if (n < 1 || n > N || B < 1 || nh < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_attention_wgmma<64, false>(qkv, nullptr, nullptr, out, nullptr, B, N, n, nh, s);
  if (head_dim == 128)
    return launch_attention_wgmma<128, false>(qkv, nullptr, nullptr, out, nullptr, B, N, n, nh,
                                              s);
  return (int)cudaErrorInvalidValue;
}
