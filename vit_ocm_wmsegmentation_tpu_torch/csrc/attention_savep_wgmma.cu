// The saved-P attention forward (TRAIN.ATTN_SAVE_P on), bf16 storage, on
// Hopper's warpgroup tensor cores: wgmma fed by TMA through an mbarrier ring,
// P written by TMA stores. Entry: attention_savep.cu's vitocm_flash_fwd_savep.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/flash_attention.py::_attn_fwd_kernel
// on its want_p route (_flash_fwd with want_p) for bf16, with the TPU
// kernel's rounding points (twin: ops/flash_attention.py
// ::flash_attention_savep_plain): s = q k^T in f32 (q pre-scaled), m the
// true row max (padded keys left out), P = bf16(exp(s - m)) stored to P (BH,
// N, Np) with its padded columns 0, l the f32 sum of the rounded P (what the
// TPU's ones column of V sums), out = bf16((P V) / l) rounded once, inv =
// 1 / l in f32. l is P . 1 on the tensor cores (an m64n8 product against a
// tile of ones beside P . V, as probe_attention_wgmma.cu sums its
// denominator): the twin sums the rounded P in f32 over the keys in order,
// the tensor cores in 16-key steps, so l differs from the twin's in the
// order of its f32 sums only.
//
// What bounds it on the H100: at the MIM step's folded (48, 2305, 128), P is
// (48, 2305, 2368) bf16, 524 MB of stores (0.156 ms at 3.35 TB/s), and the
// products are 3 x 65 GFLOP (S twice, then P V: 0.198 ms at 989 TFLOP/s)
// beside 0.26 G exp. The mma.sync kernel this replaced ran 64 query rows a
// CTA (K read twice and V once per 64 rows), copied every K and V tile with
// all threads between two __syncthreads (tensor cores idle, nothing in
// flight meanwhile), and stored P 4 bytes a lane (each 32-byte sector half
// used). Here, as in attention_qkv_wgmma.cu's folded instance, a CTA owns 128
// query rows of one batch*head: two consumer warpgroups of 64 rows and a
// producer warpgroup, whose one lane loads the CTA's Q once and then keeps
// 64-key tiles in flight through a ring of 3 stages ("full" and "empty"
// mbarriers; TMA through 3-D maps over the folded q, k, v with the 128-byte
// swizzle, rows past N read as 0). As probe_attention_wgmma.cu's row-max
// instances do, pass 1 streams K alone and keeps each row's max of S = Q K^T
// (wgmma from shared memory, K-major); pass 2 streams K and V, recomputes S,
// rounds P in registers, packs it as the register A operand of O += P V (V
// read MN-major) and P . 1, and stages each warp's (16 x 64) P tile in
// shared memory in the 128-byte swizzle, from where one TMA store through a
// 3-D map over (BH, N, Np) writes it whole (rows >= N clipped by the map),
// while the products run; each warp double-buffers its tile, and its lane 0
// waits for the store of two tiles back before the buffer is rewritten.
// The producer warpgroup gives its registers to the consumers by setmaxnreg:
// at d = 64 two CTAs fit an SM (97 KB of shared memory; consumers at 104
// registers), at d = 128 one (164 KB; consumers at 240).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kSpRows = 128;     // query rows a CTA, 64 a consumer warpgroup
constexpr int kSpKeys = 64;      // keys a tile
constexpr int kSpThreads = 384;  // two consumer warpgroups + the producer warpgroup

template <int D>
struct SavepFwd {
  static constexpr int CH = D / 64;                    // 64-column (128-byte) chunks
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = CH * kSpRows * 128;   // chunk c: 128 rows at c * 16 KB
  static constexpr int KV_BYTES = CH * kSpKeys * 128;  // K (or V) of a stage: chunk c at c * 8 KB
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int P_BYTES = 8 * 2 * 2048;  // every consumer warp's two (16 x 64) P tiles
  static constexpr int ONES = 1024;             // bf16 ones: B of the row sums P . 1
  static constexpr int MIN_CTAS = D == 64 ? 2 : 1;
  static constexpr int REGS = D == 64 ? 104 : 240;  // the consumers' registers after setmaxnreg
  static constexpr size_t SMEM =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + P_BYTES + ONES + 8 * (2 * STAGES + 1);
};

// S = Q K^T of one tile into sc, waited for: 64 rows x 64 keys
template <int D>
__device__ __forceinline__ void savep_scores(float (&sc)[32], const unsigned char* qw,
                                             const unsigned char* ks) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  wgmma_fence();
  issue_abt<D>(sc, qw, kSpRows * 128, ks, kSpKeys * 128);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
}

// keys k0 + 8 j + 2 t4 (+1) of sc[4 j + e] at or past N to -inf
__device__ __forceinline__ void savep_mask(float (&sc)[32], int k0, int N, int t4) {
  if (k0 + kSpKeys <= N) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = k0 + 8 * j + 2 * t4;
    if (key >= N) sc[4 * j] = sc[4 * j + 2] = -INFINITY;
    if (key + 1 >= N) sc[4 * j + 1] = sc[4 * j + 3] = -INFINITY;
  }
}

template <int D>
__global__ void __launch_bounds__(kSpThreads, SavepFwd<D>::MIN_CTAS)
attn_fwd_savep_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap p_map,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ inv, int N) {
  using C = SavepFwd<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ring = qs + C::Q_BYTES;
  unsigned char* pst = ring + C::STAGES * C::STAGE_BYTES;  // P staging, 4 KB a consumer warp
  unsigned char* ones = pst + C::P_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ones + C::ONES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * kSpRows;
  const int tiles = (N + kSpKeys - 1) / kSpKeys;
  const int uses = 2 * tiles;  // ring uses: pass 1's K tiles, then pass 2's K and V
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  if (tid < C::ONES / 4) reinterpret_cast<uint32_t*>(ones)[tid] = 0x3F803F80u;  // bf16 1.0 twice
  fence_proxy_async();
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one lane issues every copy
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < C::CH; ++c)
        for (int r = 0; r < kSpRows; r += 64)
          tma_load_3d(qs + c * kSpRows * 128 + r * 128, &q_map, qbar, 64 * c, q0 + r, bh);
      for (int it = 0; it < uses; ++it) {
        const int s = it % C::STAGES, t = it < tiles ? it : it - tiles;
        const bool with_v = it >= tiles;
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], with_v ? C::STAGE_BYTES : C::KV_BYTES);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        for (int c = 0; c < C::CH; ++c) {
          tma_load_3d(st + c * kSpKeys * 128, &k_map, &full[s], 64 * c, t * kSpKeys, bh);
          if (with_v)
            tma_load_3d(st + C::KV_BYTES + c * kSpKeys * 128, &v_map, &full[s], 64 * c,
                        t * kSpKeys, bh);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<C::REGS>();

  // consumer warpgroup wg: query rows q0 + 64 wg ..; warp wl of it owns rows
  // 16 wl + g and 16 wl + g + 8 of those. A warpgroup with no row below N
  // only releases the tiles.
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const unsigned char* qw = qs + wg * 64 * 128;
  auto stage = [&](int it) { return ring + (it % C::STAGES) * C::STAGE_BYTES; };
  auto await = [&](int it) { mbar_wait(&full[it % C::STAGES], (it / C::STAGES) & 1); };
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(&empty[it % C::STAGES]);
  };
  mbar_wait(qbar, 0);
  if (q0 + 64 * wg >= N) {
    for (int it = 0; it < uses; ++it) {
      await(it);
      release(it);
    }
    return;
  }

  // pass 1: the true row max of rows g, g + 8, from K alone
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int t = 0; t < tiles; ++t) {
    float sc[32];
    await(t);
    savep_scores<D>(sc, qw, stage(t));
    release(t);
    savep_mask(sc, t * kSpKeys, N, t4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m0 = fmaxf(m0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      m1 = fmaxf(m1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }

  // pass 2: P = bf16(exp(s - m)), staged and stored; O += P V, l += P . 1
  float o[C::CH][32];
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float ld[4] = {0.f, 0.f, 0.f, 0.f};  // P . 1: every column a whole row's sum
  const uint64_t ones_desc = smem_desc(ones, 128, 256, 0);  // no swizzle; every byte pair 1.0
  unsigned char* pw = pst + warp * 4096;  // this warp's two P tiles
  const int prow = q0 + 64 * wg + 16 * wl;  // this warp's first query row
  for (int t = 0; t < tiles; ++t) {
    const int it = tiles + t, k0 = t * kSpKeys;
    float sc[32];
    await(it);
    savep_scores<D>(sc, qw, stage(it));
    savep_mask(sc, k0, N, t4);
    // pk[2 j + h]: the rounded P of keys k0 + 8 j + 2 t4 (+1), row g + 8 h
    uint32_t pk[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pk[2 * j] = pack_bf16(expf(sc[4 * j] - m0), expf(sc[4 * j + 1] - m0));
      pk[2 * j + 1] = pack_bf16(expf(sc[4 * j + 2] - m1), expf(sc[4 * j + 3] - m1));
    }
    // the warp's P tile into buffer t % 2 (128-byte swizzle: row r's 16-byte
    // chunk j at chunk j ^ (r % 8)) once the store of tile t - 2 has read it
    unsigned char* pb = pw + (t & 1) * 2048;
    if (lane == 0) bulk_wait_read<1>();
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int off = g * 128 + ((j ^ g) << 4) + 4 * t4;
      *reinterpret_cast<uint32_t*>(pb + off) = pk[2 * j];
      *reinterpret_cast<uint32_t*>(pb + off + 8 * 128) = pk[2 * j + 1];
    }
    const unsigned char* vs = stage(it) + C::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15
      const uint32_t pa[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < C::CH; ++c)
        wgmma_rs_m64n64k16<1>(o[c], pa,
                              desc_mn128(vs + c * kSpKeys * 128 + kk * 16 * 128, kSpKeys * 128));
      wgmma_rs_m64n8k16(ld, pa, ones_desc);
    }
    wgmma_commit();
    fence_proxy_async();  // the tile's writes, seen by the TMA store
    __syncwarp();
    if (lane == 0 && prow < N) {
      tma_store_3d(&p_map, pb, k0, prow, bh);
      bulk_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::CH; ++c) fence_regs(o[c]);
    fence_regs(ld);
    release(it);
  }

  const float l0 = ld[0], l1 = ld[2];  // l >= 1: the max term is exp(0)
  const int r0 = prow + g, r1 = r0 + 8;
  if (t4 == 0) {
    float* irow = inv + (long long)bh * N;
    if (r0 < N) irow[r0] = 1.f / l0;
    if (r1 < N) irow[r1] = 1.f / l1;
  }
  __nv_bfloat16* ob = out + (long long)bh * N * D;
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * t4;
      if (r0 < N)
        *reinterpret_cast<uint32_t*>(ob + (long long)r0 * D + col) =
            pack_bf16(o[c][4 * j] / l0, o[c][4 * j + 1] / l0);
      if (r1 < N)
        *reinterpret_cast<uint32_t*>(ob + (long long)r1 * D + col) =
            pack_bf16(o[c][4 * j + 2] / l1, o[c][4 * j + 3] / l1);
    }
  if (lane == 0) bulk_wait_read<0>();  // the P tiles read before shared memory is freed
}

template <int D>
int launch_fwd_savep_wgmma(const void* qs, const void* k, const void* v, void* out, void* P,
                           float* inv, int BH, int N, int Np, cudaStream_t stream) {
  using C = SavepFwd<D>;
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)N, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)D * 2 * N};
  const uint32_t box[3] = {64, 64, 1};
  const uint64_t pdims[3] = {(uint64_t)Np, (uint64_t)N, (uint64_t)BH};
  const uint64_t pstrides[2] = {(uint64_t)Np * 2, (uint64_t)Np * 2 * N};
  const uint32_t pbox[3] = {64, 16, 1};
  CUtensorMap maps[4];
  const void* bases[3] = {qs, k, v};
  for (int i = 0; i < 3; ++i)
    if (!make_tmap_bf16(&maps[i], bases[i], 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  if (!make_tmap_bf16(&maps[3], P, 3, pdims, pstrides, pbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kern = attn_fwd_savep_wgmma_kernel<D>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  const dim3 grid((N + kSpRows - 1) / kSpRows, BH);
  kern<<<grid, kSpThreads, C::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                              static_cast<__nv_bfloat16*>(out), inv, N);
  return (int)cudaGetLastError();
}

template int launch_fwd_savep_wgmma<64>(const void*, const void*, const void*, void*, void*,
                                        float*, int, int, int, cudaStream_t);
template int launch_fwd_savep_wgmma<128>(const void*, const void*, const void*, void*, void*,
                                         float*, int, int, int, cudaStream_t);

}  // namespace vitocm
