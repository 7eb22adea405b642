// Attention backward from the saved logsumexp, bf16 storage, on Hopper's
// warpgroup tensor cores: wgmma fed by TMA through mbarrier rings.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/flash_attention.py::
// _attn_bwd_kernel (_flash_bwd_impl, the backward of
// flash_attention_trainable) for bf16. Contract of attention_bwd.cu: qs = q
// * d^-0.5 rounded to bf16 (as the forward saw it), k, v, dout, dq, dk, dv
// folded (BH, N, D), D in {64, 128}; the per-row statistics [lse with
// non-finite values as 0 | D = rowsum(dout * o)] come from attn_row_stats
// (attention_bwd.cu, shared with the saved-P route), here with a row pitch
// rounded up to 4 floats so that TMA can read them. Rounding points of the
// TPU kernel and of the twin (ops/flash_attention.py::
// flash_attention_bwd_plain): e = exp(s - lse) in f32 (expf) from f32
// scores, p = bf16(e) for dv, ds = bf16(e (dp - D)), dk and dv accumulated
// in f32 over every query and rounded once, dq rounded, then scaled by
// d^-0.5 and rounded again. Only the order of the f32 sums inside each
// product differs.
//
// What bounds it on the H100: at the MIM step's (48, 2305, 128), 10 N^2 d =
// 327 GFLOP of products (0.33 ms at 989 TFLOP/s) and 0.26 G exp; the bytes
// (0.2 GB) are far below. The mma.sync kernels this replaced staged every
// tile with all threads between two __syncthreads (tensor cores idle) and
// shrank the query tile to 32 at D = 128 to keep their accumulators in
// registers.
//
// Two kernels, both deterministic (no atomics; each output row is summed by
// one thread in a fixed order), so that two calls give the same bits:
//   * dk/dv: a CTA owns 128 keys, two consumer warpgroups of 64, and a
//     producer warpgroup. K and V stay in shared memory; the producer keeps
//     the query tiles (64 rows of Q and dO, and their lse and D rows) in
//     flight with TMA into a ring of stages (4 at D = 64, 3 at D = 128)
//     guarded by "full" and "empty" mbarriers. Per tile a warpgroup computes
//     S^T = K Q^T and dP^T = V dO^T with wgmma (both operands from shared
//     memory, K-major), turns them into p^T and dS^T on the accumulators (a
//     key row's 64 queries in the 4 lanes of a quad; each lane reads the lse
//     and D of its 16 query columns from the stage), and dV += P^T dO,
//     dK += dS^T Q with p^T and dS^T rounded and packed as the register A
//     operand and dO and Q read MN-major from the same stage. The dk and dv
//     accumulators are 128 floats a thread at D = 128, so the consumers raise
//     their register limit from the launch's 168 to 240 with setmaxnreg, out
//     of what the producer warpgroup gives back by dropping to 24.
//   * dq: the construction of attention_qkv_wgmma.cu's forward. A CTA owns
//     128 queries (two consumer warpgroups of 64, one producer warp) with Q
//     and dO resident and walks the keys in tiles of 64 (K and V in the TMA
//     ring): S = Q K^T and dP = dO V^T by wgmma, dS in registers from the
//     row's lse and D, dQ += dS K with K read MN-major. (Issuing the next
//     tile's S and dP before this tile's dQ product, to compute dS while it
//     runs, made the call slower on an H100, as in the forward.)
// The dq kernel recomputes S and dP, so the pair does 14 N^2 d FLOPs against
// the 10 of one pass. FlashAttention-3's deterministic alternative, dq
// accumulated by the dk/dv CTAs into an f32 workspace in a fixed key-tile
// order, makes each CTA wait for the one before it on every query tile;
// the two-kernel split keeps the CTAs independent and needs no workspace.
// Rows past N read as zeros through TMA; padded queries (dk/dv) and padded
// keys (dq) are masked to e = 0.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kKvThreads = 384;  // dk/dv: two consumer warpgroups + the producer warpgroup
constexpr int kKvKeys = 128;     // dk/dv: keys per CTA, 64 a consumer warpgroup
constexpr int kKvQ = 64;         // dk/dv: queries per tile
constexpr int kDqThreads = 288;  // dq: two consumer warpgroups + the producer warp
constexpr int kDqRows = 128;     // dq: queries per CTA, 64 a consumer warpgroup
constexpr int kDqK = 64;         // dq: keys per tile

template <int D>
struct BwdKv {
  static constexpr int CH = D / 64;                     // 64-column (128-byte) chunks
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int KV_BYTES = CH * kKvKeys * 128;   // K (or V); chunk c at c * kKvKeys * 128
  static constexpr int T_BYTES = CH * kKvQ * 128;       // Q (or dO) of one stage
  static constexpr int ST_BYTES = 2 * kKvQ * 4;         // lse, D of one stage
  static constexpr int STAGE_BYTES = (2 * T_BYTES + ST_BYTES + 1023) / 1024 * 1024;
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
};

template <int D>
struct BwdDq {
  static constexpr int CH = D / 64;
  static constexpr int STAGES = 3;
  static constexpr int QO_BYTES = CH * kDqRows * 128;  // Q (or dO); chunk c at c * kDqRows * 128
  static constexpr int KV_BYTES = CH * kDqK * 128;     // K (or V) of one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr size_t SMEM = 1024 + 2 * QO_BYTES + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
};

template <int D>
__global__ void __launch_bounds__(kKvThreads, 1)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap st_map,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N) {
  using C = BwdKv<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + C::KV_BYTES;
  unsigned char* ring = vs + C::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* kvbar = empty + C::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, k0 = blockIdx.x * kKvKeys;
  const int tiles = (N + kKvQ - 1) / kKvQ;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one lane issues every copy
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(kvbar, 2 * C::KV_BYTES);
      for (int c = 0; c < C::CH; ++c)
        for (int r = 0; r < kKvKeys; r += 64) {
          tma_load_3d(ks + c * kKvKeys * 128 + r * 128, &k_map, kvbar, 64 * c, k0 + r, bh);
          tma_load_3d(vs + c * kKvKeys * 128 + r * 128, &v_map, kvbar, 64 * c, k0 + r, bh);
        }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % C::STAGES;
        mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::T_BYTES + C::ST_BYTES);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        for (int c = 0; c < C::CH; ++c) {
          tma_load_3d(st + c * kKvQ * 128, &q_map, &full[s], 64 * c, t * kKvQ, bh);
          tma_load_3d(st + C::T_BYTES + c * kKvQ * 128, &do_map, &full[s], 64 * c, t * kKvQ, bh);
        }
        tma_load_3d(st + 2 * C::T_BYTES, &st_map, &full[s], t * kKvQ, 0, bh);
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
  const unsigned char* kw = ks + wg * 64 * 128;
  const unsigned char* vw = vs + wg * 64 * 128;
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
  mbar_wait(kvbar, 0);

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
    // s^T, dp^T [4i + e]: key row g + 8 (e >> 1), query column 8i + 2 t4 + (e & 1)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    issue_abt<D>(s, kw, kKvKeys * 128, st, kKvQ * 128);
    issue_abt<D>(dp, vw, kKvKeys * 128, st + C::T_BYTES, kKvQ * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const float* ls = reinterpret_cast<const float*>(st + 2 * C::T_BYTES);  // lse, then D
    const int q0 = t * kKvQ;
    const bool ragged = q0 + kKvQ > N;
    uint32_t pa[16], da[16];  // p^T and dS^T, packed: the A operands of k-step i / 2
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + 2 * t4;
      const float2 l = *reinterpret_cast<const float2*>(ls + col);
      const float2 dd = *reinterpret_cast<const float2*>(ls + kKvQ + col);
      float e0 = expf(s[4 * i] - l.x), e1 = expf(s[4 * i + 1] - l.y);
      float e2 = expf(s[4 * i + 2] - l.x), e3 = expf(s[4 * i + 3] - l.y);
      if (ragged) {
        if (q0 + col >= N) e0 = e2 = 0.f;
        if (q0 + col + 1 >= N) e1 = e3 = 0.f;
      }
      pa[2 * i] = pack_bf16(e0, e1);
      pa[2 * i + 1] = pack_bf16(e2, e3);
      da[2 * i] = pack_bf16(e0 * (dp[4 * i] - dd.x), e1 * (dp[4 * i + 1] - dd.y));
      da[2 * i + 1] = pack_bf16(e2 * (dp[4 * i + 2] - dd.x), e3 * (dp[4 * i + 3] - dd.y));
    }
    wgmma_fence();
    issue_ab<D>(gv, pa, st + C::T_BYTES, kKvQ * 128);
    issue_ab<D>(gk, da, st, kKvQ * 128);
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
__global__ void __launch_bounds__(kDqThreads, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ stats, int pitch,
                         __nv_bfloat16* __restrict__ dq, int N, float scale) {
  using C = BwdDq<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* os = qs + C::QO_BYTES;
  unsigned char* ring = os + C::QO_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * kDqRows;
  const int tiles = (N + kDqK - 1) / kDqK;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * C::QO_BYTES);
      for (int c = 0; c < C::CH; ++c)
        for (int r = 0; r < kDqRows; r += 64) {
          tma_load_3d(qs + c * kDqRows * 128 + r * 128, &q_map, qbar, 64 * c, q0 + r, bh);
          tma_load_3d(os + c * kDqRows * 128 + r * 128, &do_map, qbar, 64 * c, q0 + r, bh);
        }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % C::STAGES;
        mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        for (int c = 0; c < C::CH; ++c) {
          tma_load_3d(st + c * kDqK * 128, &k_map, &full[s], 64 * c, t * kDqK, bh);
          tma_load_3d(st + C::KV_BYTES + c * kDqK * 128, &v_map, &full[s], 64 * c, t * kDqK, bh);
        }
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
  const float lse0 = r0 < N ? srow[r0] : 0.f, lse1 = r1 < N ? srow[r1] : 0.f;
  const float dd0 = r0 < N ? srow[pitch + r0] : 0.f, dd1 = r1 < N ? srow[pitch + r1] : 0.f;
  const unsigned char* qw = qs + wg * 64 * 128;
  const unsigned char* ow = os + wg * 64 * 128;
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
  mbar_wait(qbar, 0);

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
    // s, dp [4j + e]: query row g + 8 (e >> 1), key column 8j + 2 t4 + (e & 1)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    issue_abt<D>(s, qw, kDqRows * 128, st, kDqK * 128);
    issue_abt<D>(dp, ow, kDqRows * 128, st + C::KV_BYTES, kDqK * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const int kb = t * kDqK;
    const bool ragged = kb + kDqK > N;
    uint32_t da[16];  // dS, packed: the A operands of k-step j / 2
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = kb + 8 * j + 2 * t4;
      float e0 = expf(s[4 * j] - lse0), e1 = expf(s[4 * j + 1] - lse0);
      float e2 = expf(s[4 * j + 2] - lse1), e3 = expf(s[4 * j + 3] - lse1);
      if (ragged) {
        if (key >= N) e0 = e2 = 0.f;
        if (key + 1 >= N) e1 = e3 = 0.f;
      }
      da[2 * j] = pack_bf16(e0 * (dp[4 * j] - dd0), e1 * (dp[4 * j + 1] - dd0));
      da[2 * j + 1] = pack_bf16(e2 * (dp[4 * j + 2] - dd1), e3 * (dp[4 * j + 3] - dd1));
    }
    wgmma_fence();
    issue_ab<D>(gq, da, st, kDqK * 128);
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

// stats: attn_row_stats' (BH, 2, pitch) f32, pitch a multiple of 4
template <int D>
int launch_attn_bwd_wgmma(const void* qs, const void* k, const void* v, const float* stats,
                          int pitch, const void* dout, void* dq, void* dk, void* dv, int BH,
                          int N, cudaStream_t stream) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)N, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)D * 2 * N};
  const uint32_t box[3] = {64, 64, 1};
  CUtensorMap maps[4];  // qs, k, v, dout
  const void* bases[4] = {qs, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (!make_tmap_bf16(&maps[i], bases[i], 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  const uint64_t sdims[3] = {(uint64_t)N, 2, (uint64_t)BH};
  const uint64_t sstrides[2] = {(uint64_t)pitch * 4, (uint64_t)pitch * 8};
  const uint32_t sbox[3] = {kKvQ, 2, 1};
  CUtensorMap st_map;
  if (pitch % 4 || !make_tmap(&st_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, stats, 3, sdims, sstrides,
                              sbox, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;

  auto kv = attn_bwd_dkdv_wgmma_kernel<D>;
  cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BwdKv<D>::SMEM);
  kv<<<dim3((N + kKvKeys - 1) / kKvKeys, BH), kKvThreads, BwdKv<D>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], st_map, static_cast<T*>(dk), static_cast<T*>(dv), N);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  auto qk = attn_bwd_dq_wgmma_kernel<D>;
  cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BwdDq<D>::SMEM);
  qk<<<dim3((N + kDqRows - 1) / kDqRows, BH), kDqThreads, BwdDq<D>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], stats, pitch, static_cast<T*>(dq), N,
      1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template int launch_attn_bwd_wgmma<64>(const void*, const void*, const void*, const float*, int,
                                       const void*, void*, void*, void*, int, int, cudaStream_t);
template int launch_attn_bwd_wgmma<128>(const void*, const void*, const void*, const float*, int,
                                        const void*, void*, void*, void*, int, int, cudaStream_t);

}  // namespace vitocm
