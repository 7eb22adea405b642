// Attention backward on the saved-P route (TRAIN.ATTN_SAVE_P on), bf16
// storage, on Hopper's warpgroup tensor cores: wgmma fed by TMA through
// mbarrier rings.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/flash_attention.py::
// _attn_bwd_savep_kernel (_flash_bwd_savep_impl) for bf16. Contract of
// attention_savep.cu: qs = q * d^-0.5 rounded to bf16, k, v, dout, dq, dk,
// dv folded (BH, N, D), D in {64, 128}; P (BH, N, Np) as the forward wrote
// it (Np = N rounded up to 64, its padded columns 0); the per-row statistics
// [inv = 1 / denominator | D = rowsum(dout * o)] from attn_row_stats
// (attention_bwd.cu), rows padded to 4 floats so that TMA can read them.
// Rounding points of the TPU kernel and of the twin (ops/flash_attention.py::
// flash_attention_bwd_savep_plain): e = P * inv in f32, p = bf16(e) for dv,
// ds = bf16(e (dp - D)), dk and dv accumulated in f32 over every query and
// rounded once, dq rounded, then scaled by d^-0.5 and rounded again. Only
// the order of the f32 sums inside each product differs.
//
// What bounds it on the H100: at the MIM step's (48, 2305, 128), 10 N^2 d =
// 326 GFLOP of products with no exp (8 N^2 d without the dq kernel's second
// dP: 0.26 ms at 989 TFLOP/s), and P (0.52 GB) read once by each kernel
// (0.31 ms of HBM time for the two, overlapped with the products). The
// mma.sync kernels this replaced staged every tile, P included, with all
// threads between two __syncthreads (tensor cores idle during the copies),
// shrank the query tile to 32 at D = 128, and read P transposed one bf16 at
// a time.
//
// The lse route's two deterministic kernels (attention_bwd_wgmma.cu) without
// the S product and the exp; no atomics, each output row summed by one
// thread in a fixed order, so two calls give the same bits:
//   * dk/dv: a CTA owns 128 keys, two consumer warpgroups of 64, and a
//     producer warpgroup. V stays in shared memory (K is not needed); the
//     producer keeps the query tiles (64 rows of Q and dO, the (64 query x
//     128 key) P tile, and the tile's inv and D rows) in flight with TMA
//     into a ring of stages (4 at D = 64, 3 at D = 128). Per tile a
//     warpgroup computes dP^T = V dO^T with wgmma, reads its (query, key)
//     half of the P tile transposed with ldmatrix.trans (rows of the
//     128-byte swizzle: chunk c of row r at c ^ (r & 7)), so that each lane
//     gets P at its accumulators' (key, query) positions, forms e = P * inv
//     of the query column, and then dV += p^T dO and dK += dS^T Q with p^T
//     and dS^T rounded and packed as the register A operand and dO and Q
//     read MN-major from the stage. The dk and dv accumulators are 128
//     floats a thread at D = 128, so the consumers raise their register
//     limit to 240 with setmaxnreg, out of what the producer warpgroup
//     gives back by dropping to 24.
//   * dq: a CTA owns 128 queries (two consumer warpgroups of 64, one
//     producer warp) with dO resident (Q is not needed) and walks the keys
//     in tiles of 64 (K, V and the (128 query x 64 key) P tile, one swizzled
//     128-byte row a query, in the TMA ring): dP = dO V^T by wgmma, e = P *
//     inv of the row read at the accumulators' own (query, key) positions, a
//     4-byte pair a lane, dS in registers, dQ += dS K with K read MN-major.
// P's map is 3-D over (BH, N, Np), so query rows past N and key columns past
// Np read as zeros, as do the statistics past N; padded queries and keys
// hold P = 0, hence e = 0, with no mask.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kSpKvThreads = 384;  // dk/dv: two consumer warpgroups + the producer warpgroup
constexpr int kSpKvKeys = 128;     // dk/dv: keys per CTA, 64 a consumer warpgroup
constexpr int kSpKvQ = 64;         // dk/dv: queries per tile
constexpr int kSpDqThreads = 288;  // dq: two consumer warpgroups + the producer warp
constexpr int kSpDqRows = 128;     // dq: queries per CTA, 64 a consumer warpgroup
constexpr int kSpDqK = 64;         // dq: keys per tile

template <int D>
struct SavepKv {
  static constexpr int CH = D / 64;                     // 64-column (128-byte) chunks
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int V_BYTES = CH * kSpKvKeys * 128;  // chunk c at c * kSpKvKeys * 128
  static constexpr int T_BYTES = CH * kSpKvQ * 128;     // Q (or dO) of one stage
  static constexpr int P_BYTES = kSpKvKeys / 64 * kSpKvQ * 128;  // key chunk c at c * kSpKvQ * 128
  static constexpr int ST_BYTES = 2 * kSpKvQ * 4;       // inv, D of one stage
  static constexpr int STAGE_BYTES = (2 * T_BYTES + P_BYTES + ST_BYTES + 1023) / 1024 * 1024;
  static constexpr size_t SMEM = 1024 + V_BYTES + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
};

template <int D>
struct SavepDq {
  static constexpr int CH = D / 64;
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int O_BYTES = CH * kSpDqRows * 128;  // dO; chunk c at c * kSpDqRows * 128
  static constexpr int KV_BYTES = CH * kSpDqK * 128;    // K (or V) of one stage
  static constexpr int P_BYTES = kSpDqRows * 128;       // 128 queries x 64 keys
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + P_BYTES;
  static constexpr size_t SMEM = 1024 + O_BYTES + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
};

// the two bf16 of a packed pair, low half first, as floats
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

template <int D>
__global__ void __launch_bounds__(kSpKvThreads, 1)
attn_bwd_savep_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap do_map,
                                 const __grid_constant__ CUtensorMap p_map,
                                 const __grid_constant__ CUtensorMap st_map,
                                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                 int N) {
  using C = SavepKv<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* vs = align1024(smem_raw);
  unsigned char* ring = vs + C::V_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* vbar = empty + C::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, k0 = blockIdx.x * kSpKvKeys;
  const int tiles = (N + kSpKvQ - 1) / kSpKvQ;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init(vbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one lane issues every copy
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(vbar, C::V_BYTES);
      for (int c = 0; c < C::CH; ++c)
        for (int r = 0; r < kSpKvKeys; r += 64)
          tma_load_3d(vs + c * kSpKvKeys * 128 + r * 128, &v_map, vbar, 64 * c, k0 + r, bh);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % C::STAGES;
        mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::T_BYTES + C::P_BYTES + C::ST_BYTES);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        for (int c = 0; c < C::CH; ++c) {
          tma_load_3d(st + c * kSpKvQ * 128, &q_map, &full[s], 64 * c, t * kSpKvQ, bh);
          tma_load_3d(st + C::T_BYTES + c * kSpKvQ * 128, &do_map, &full[s], 64 * c, t * kSpKvQ,
                      bh);
        }
        for (int c = 0; c < kSpKvKeys / 64; ++c)
          tma_load_3d(st + 2 * C::T_BYTES + c * kSpKvQ * 128, &p_map, &full[s], k0 + 64 * c,
                      t * kSpKvQ, bh);
        tma_load_3d(st + 2 * C::T_BYTES + C::P_BYTES, &st_map, &full[s], t * kSpKvQ, 0, bh);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumer warpgroup wg: keys k0 + 64 wg ..; warp wl of it owns keys
  // 16 wl + g and 16 wl + g + 8 of those. A warpgroup with no key below N
  // only releases the tiles.
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const bool live = k0 + 64 * wg < N;
  const unsigned char* vw = vs + wg * 64 * 128;
  // ldmatrix.trans of the warpgroup's key chunk of P (rows = queries): lane
  // l gives row 8 (l >> 4) + (l & 7) of an 8-query pair of blocks, at the
  // chunk of keys 16 wl + 8 ((l >> 3) & 1), swizzled
  const int lr = lane & 7;
  const int p_lane = (8 * (lane >> 4) + lr) * 128 + (((2 * wl + ((lane >> 3) & 1)) ^ lr) << 4);
  float gk[C::CH][32], gv[C::CH][32];
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) gk[c][i] = gv[c][i] = 0.f;
  auto stage = [&](int t) { return ring + (t % C::STAGES) * C::STAGE_BYTES; };
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(&empty[t % C::STAGES]);
  };
  auto await = [&](int t) { mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1); };
  mbar_wait(vbar, 0);

  if (!live) {
    for (int t = 0; t < tiles; ++t) {
      await(t);
      release(t);
    }
    return;
  }
  for (int t = 0; t < tiles; ++t) {
    await(t);
    const unsigned char* st = stage(t);
    // dp^T [4i + e]: key row g + 8 (e >> 1), query column 8i + 2 t4 + (e & 1)
    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    wgmma_fence();
    issue_abt<D>(dp, vw, kSpKvKeys * 128, st + C::T_BYTES, kSpKvQ * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dp);

    const unsigned char* pw = st + 2 * C::T_BYTES + wg * kSpKvQ * 128;
    const float* ls = reinterpret_cast<const float*>(st + 2 * C::T_BYTES + C::P_BYTES);  // inv, D
    uint32_t pa[16], da[16];  // p^T and dS^T, packed: the A operands of k-step i / 2
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      // pr[2h + u]: P of queries 8 (i + h) + 2 t4 (+1) at key g + 8u
      uint32_t pr[4];
      ldsm_x4_trans(pr, reinterpret_cast<const __nv_bfloat16*>(pw + p_lane + i * 1024));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ii = i + h, col = 8 * ii + 2 * t4;
        const float2 iv = *reinterpret_cast<const float2*>(ls + col);
        const float2 dd = *reinterpret_cast<const float2*>(ls + kSpKvQ + col);
        const float e0 = bf_lo(pr[2 * h]) * iv.x, e1 = bf_hi(pr[2 * h]) * iv.y;
        const float e2 = bf_lo(pr[2 * h + 1]) * iv.x, e3 = bf_hi(pr[2 * h + 1]) * iv.y;
        pa[2 * ii] = pack_bf16(e0, e1);
        pa[2 * ii + 1] = pack_bf16(e2, e3);
        da[2 * ii] = pack_bf16(e0 * (dp[4 * ii] - dd.x), e1 * (dp[4 * ii + 1] - dd.y));
        da[2 * ii + 1] = pack_bf16(e2 * (dp[4 * ii + 2] - dd.x), e3 * (dp[4 * ii + 3] - dd.y));
      }
    }
    wgmma_fence();
    issue_ab<D>(gv, pa, st + C::T_BYTES, kSpKvQ * 128);
    issue_ab<D>(gk, da, st, kSpKvQ * 128);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::CH; ++c) {
      fence_regs(gk[c]);
      fence_regs(gv[c]);
    }
    release(t);
  }

  const int r0 = k0 + 64 * wg + 16 * wl + g, r1 = r0 + 8;
  const long long base = (long long)bh * N * D;
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * t4;
      if (r0 < N) {
        *reinterpret_cast<uint32_t*>(dk + base + (long long)r0 * D + col) =
            pack_bf16(gk[c][4 * j], gk[c][4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dv + base + (long long)r0 * D + col) =
            pack_bf16(gv[c][4 * j], gv[c][4 * j + 1]);
      }
      if (r1 < N) {
        *reinterpret_cast<uint32_t*>(dk + base + (long long)r1 * D + col) =
            pack_bf16(gk[c][4 * j + 2], gk[c][4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dv + base + (long long)r1 * D + col) =
            pack_bf16(gv[c][4 * j + 2], gv[c][4 * j + 3]);
      }
    }
}

template <int D>
__global__ void __launch_bounds__(kSpDqThreads, 1)
attn_bwd_savep_dq_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const __grid_constant__ CUtensorMap p_map,
                               const float* __restrict__ stats, int pitch,
                               __nv_bfloat16* __restrict__ dq, int N, float scale) {
  using C = SavepDq<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* os = align1024(smem_raw);
  unsigned char* ring = os + C::O_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* obar = empty + C::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * kSpDqRows;
  const int tiles = (N + kSpDqK - 1) / kSpDqK;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init(obar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(obar, C::O_BYTES);
      for (int c = 0; c < C::CH; ++c)
        for (int r = 0; r < kSpDqRows; r += 64)
          tma_load_3d(os + c * kSpDqRows * 128 + r * 128, &do_map, obar, 64 * c, q0 + r, bh);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % C::STAGES;
        mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        for (int c = 0; c < C::CH; ++c) {
          tma_load_3d(st + c * kSpDqK * 128, &k_map, &full[s], 64 * c, t * kSpDqK, bh);
          tma_load_3d(st + C::KV_BYTES + c * kSpDqK * 128, &v_map, &full[s], 64 * c, t * kSpDqK,
                      bh);
        }
        for (int r = 0; r < kSpDqRows; r += 64)
          tma_load_3d(st + 2 * C::KV_BYTES + r * 128, &p_map, &full[s], t * kSpDqK, q0 + r, bh);
      }
    }
    return;
  }

  // consumer warpgroup wg: queries q0 + 64 wg ..; warp wl of it owns rows
  // 16 wl + g and 16 wl + g + 8 of those
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const bool live = q0 + 64 * wg < N;
  const int r0 = q0 + 64 * wg + 16 * wl + g, r1 = r0 + 8;
  const float* srow = stats + (long long)bh * 2 * pitch;
  const float inv0 = r0 < N ? srow[r0] : 0.f, inv1 = r1 < N ? srow[r1] : 0.f;
  const float dd0 = r0 < N ? srow[pitch + r0] : 0.f, dd1 = r1 < N ? srow[pitch + r1] : 0.f;
  const unsigned char* ow = os + wg * 64 * 128;
  // this lane's rows of the P tile: 128 bytes a query, 16-byte chunk j of
  // the row at j ^ g (the 128-byte swizzle; both rows are g mod 8)
  const int prow0 = (64 * wg + 16 * wl + g) * 128 + 4 * t4, prow1 = prow0 + 8 * 128;
  float gq[C::CH][32];
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) gq[c][i] = 0.f;
  auto stage = [&](int t) { return ring + (t % C::STAGES) * C::STAGE_BYTES; };
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(&empty[t % C::STAGES]);
  };
  auto await = [&](int t) { mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1); };
  mbar_wait(obar, 0);

  if (!live) {
    for (int t = 0; t < tiles; ++t) {
      await(t);
      release(t);
    }
    return;
  }
  for (int t = 0; t < tiles; ++t) {
    await(t);
    const unsigned char* st = stage(t);
    // dp [4j + e]: query row g + 8 (e >> 1), key column 8j + 2 t4 + (e & 1)
    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    wgmma_fence();
    issue_abt<D>(dp, ow, kSpDqRows * 128, st + C::KV_BYTES, kSpDqK * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dp);

    const unsigned char* pt = st + 2 * C::KV_BYTES;
    uint32_t da[16];  // dS, packed: the A operands of k-step j / 2
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cj = (j ^ g) << 4;
      const uint32_t p0 = *reinterpret_cast<const uint32_t*>(pt + prow0 + cj);
      const uint32_t p1 = *reinterpret_cast<const uint32_t*>(pt + prow1 + cj);
      const float e0 = bf_lo(p0) * inv0, e1 = bf_hi(p0) * inv0;
      const float e2 = bf_lo(p1) * inv1, e3 = bf_hi(p1) * inv1;
      da[2 * j] = pack_bf16(e0 * (dp[4 * j] - dd0), e1 * (dp[4 * j + 1] - dd0));
      da[2 * j + 1] = pack_bf16(e2 * (dp[4 * j + 2] - dd1), e3 * (dp[4 * j + 3] - dd1));
    }
    wgmma_fence();
    issue_ab<D>(gq, da, st, kSpDqK * 128);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::CH; ++c) fence_regs(gq[c]);
    release(t);
  }

  const long long base = (long long)bh * N * D;
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * t4;
      if (r0 < N)
        *reinterpret_cast<uint32_t*>(dq + base + (long long)r0 * D + col) = pack_bf16(
            round_bf16(gq[c][4 * j]) * scale, round_bf16(gq[c][4 * j + 1]) * scale);
      if (r1 < N)
        *reinterpret_cast<uint32_t*>(dq + base + (long long)r1 * D + col) = pack_bf16(
            round_bf16(gq[c][4 * j + 2]) * scale, round_bf16(gq[c][4 * j + 3]) * scale);
    }
}

// P (BH, N, Np) bf16, Np a multiple of 64; stats: attn_row_stats' (BH, 2,
// pitch) f32, pitch a multiple of 4
template <int D>
int launch_bwd_savep_wgmma(const void* qs, const void* k, const void* v, const void* P,
                           const float* stats, int pitch, const void* dout, void* dq, void* dk,
                           void* dv, int BH, int N, int Np, cudaStream_t stream) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)N, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)D * 2 * N};
  const uint32_t box[3] = {64, 64, 1};
  CUtensorMap maps[4];  // qs, k, v, dout
  const void* bases[4] = {qs, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (!make_tmap_bf16(&maps[i], bases[i], 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  const uint64_t pdims[3] = {(uint64_t)Np, (uint64_t)N, (uint64_t)BH};
  const uint64_t pstrides[2] = {(uint64_t)Np * 2, (uint64_t)Np * 2 * N};
  CUtensorMap p_map;
  if (Np % 64 || !make_tmap_bf16(&p_map, P, 3, pdims, pstrides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const uint64_t sdims[3] = {(uint64_t)N, 2, (uint64_t)BH};
  const uint64_t sstrides[2] = {(uint64_t)pitch * 4, (uint64_t)pitch * 8};
  const uint32_t sbox[3] = {kSpKvQ, 2, 1};
  CUtensorMap st_map;
  if (pitch % 4 || !make_tmap(&st_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, stats, 3, sdims, sstrides,
                              sbox, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;

  auto kv = attn_bwd_savep_dkdv_wgmma_kernel<D>;
  cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SavepKv<D>::SMEM);
  kv<<<dim3((N + kSpKvKeys - 1) / kSpKvKeys, BH), kSpKvThreads, SavepKv<D>::SMEM, stream>>>(
      maps[0], maps[2], maps[3], p_map, st_map, static_cast<T*>(dk), static_cast<T*>(dv), N);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  auto qk = attn_bwd_savep_dq_wgmma_kernel<D>;
  cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SavepDq<D>::SMEM);
  qk<<<dim3((N + kSpDqRows - 1) / kSpDqRows, BH), kSpDqThreads, SavepDq<D>::SMEM, stream>>>(
      maps[1], maps[2], maps[3], p_map, stats, pitch, static_cast<T*>(dq), N,
      1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template int launch_bwd_savep_wgmma<64>(const void*, const void*, const void*, const void*,
                                        const float*, int, const void*, void*, void*, void*, int,
                                        int, int, cudaStream_t);
template int launch_bwd_savep_wgmma<128>(const void*, const void*, const void*, const void*,
                                         const float*, int, const void*, void*, void*, void*, int,
                                         int, int, cudaStream_t);

}  // namespace vitocm
