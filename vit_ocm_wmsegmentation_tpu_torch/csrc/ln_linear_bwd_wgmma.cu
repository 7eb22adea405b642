// Backward of the fused LayerNorm -> linear (TRAIN.LN_QKV kernel), bf16
// storage, on Hopper's warpgroup tensor cores: wgmma fed by TMA through
// mbarrier rings, dx and xn written by TMA stores. Entry: ln_linear.cu's
// vitocm_ln_linear_bwd.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/ln_linear.py::_ln_linear_bwd_kernel
// for bf16, with the TPU kernel's rounding points (twin: ops/ln_linear.py
// ::ln_linear_bwd_plain): the LN statistics recomputed from x in f32, xn =
// bf16(xh s + bn) before dW's product, dxn = dy W with f32 accumulation, dx =
// rstd (dxh - mean(dxh) - xh mean(dxh xh)) with dxh = dxn s rounded once, and
// ds = sum dxn xh, dbb = sum dxn, dW = dy^T xn (K, D), db = sum dy in f32.
//
// What bounds it on the H100: at the MIM step's x (36880, 384), W (1152,
// 384), two products of 2 R D K (dxn and dW: 65 GFLOP, 0.066 ms at 989
// TFLOP/s) on ~0.15 GB of HBM traffic (x, dy, dx, xn twice). The mma.sync
// kernels this replaced staged a 64 x 64 dy tile and 64 rows of W with all
// threads for every 64 columns of K (tensor cores idle, every one of 577 row
// CTAs reading all of W from L2 that way), and their weight kernel re-staged
// its split's 64 x D xn tile for every 32 columns of K (xn read 36 times
// over) and summed db with 32 threads walking 64 rows. The design is
// fused_mlp_bwd_wgmma.cu's, with dy in place of dh1 and W in place of W1:
//   * dx (ln_bwd_dx_wgmma_kernel): a CTA owns 128 rows, two consumer
//     warpgroups of 64, and a producer warpgroup. Per chunk of 64 columns of
//     K the producer brings the (128 x 64) dy tile and W's 64 rows (64 x D),
//     both in the 128-byte swizzle, into one stage of a ring; dxn += dy_c W_c
//     by wgmma (m64n192, dy K-major, W read MN-major), 64 x D f32 in
//     registers a warpgroup (192 a thread at D = 384: setmaxnreg 240 for the
//     consumers, 24 for the producer), one chunk's products in flight while
//     the next is issued. After the last chunk the producer brings x (128 x
//     D) into the freed ring, and each thread computes its two rows' LN
//     statistics and the LN backward on the accumulators, with x, s and bn
//     read from shared memory (a row's D columns in the 4 lanes of a quad:
//     its sums take two shuffles). Each warp stages its 16 rows of dx and xn
//     per 64 columns in shared memory (128-byte swizzle, double-buffered) and
//     writes them with one TMA store each (rows past R clipped by the map).
//     The [ds | dbb] column partials are summed over the warp's 16 rows by
//     shuffles, then over the 4 warps in order, into ln_part: one row of 2 D
//     a 64-row tile, as the f32 kernel writes them.
//   * weights (ln_bwd_w_wgmma_kernel): dW = dy^T xn, an A^T B product over a
//     row split (K = rows), a CTA a (128 units of K x D) output tile and a
//     split. TMA brings 64-row slices of dy (128 units) and xn (D columns)
//     into a ring; both are row-major, so wgmma reads both MN-major (m64n192,
//     64 units a warpgroup), and db = sum dy comes out of the same slices by
//     one more m64n8 product against a tile of ones. The split count (at most
//     the caller's) fills the SMs in the fullest last wave, one CTA an SM
//     (14 at the MIM step's 9 tiles); each split writes one partial.
// Then ln_linear.cu's fixed-order reductions (reduce_splits over the split
// partials, reduce_rows over ln_part's rows): two calls give the same bits
// (no atomics). Shared memory at D = 384: three stages of 64 KB for both
// kernels, one CTA an SM. Both kernels read 64 KB of operand tiles from L2
// for every 6.3 MFLOP, yet on an H100 sharing W (dx kernel, clusters of
// two) or xn (weight kernel, clusters of three) by TMA multicast was no
// faster for the dx kernel and slower for the weight kernel (PERF.md).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kLbRows = 128;     // dx: rows a CTA, 64 a warpgroup
constexpr int kLbChunk = 64;     // dx: columns of K (rows of W) a chunk
constexpr int kLbThreads = 384;  // two consumer warpgroups + the producer warpgroup
constexpr int kLbUnits = 128;    // weights: units of K an output tile, 64 a warpgroup
constexpr int kLbSlice = 64;     // weights: rows a slice

template <int D>
struct LnBwdDx {
  static constexpr int CH = D / 64, HALVES = D / 192;
  static constexpr int STAGES = D == 384 ? 3 : 4;
  static constexpr int DY_BYTES = kLbRows * 128;        // 128 rows of 64 units
  static constexpr int W_BYTES = CH * kLbChunk * 128;   // chunk c: 64 rows at c * 8 KB
  static constexpr int STAGE_BYTES = DY_BYTES + W_BYTES;
  static constexpr int X_BYTES = CH * kLbRows * 128;    // chunk c: 128 rows at c * 16 KB
  static constexpr int OUT_BYTES = 8 * 4 * 2048;        // a warp's dx and xn tiles, twice
  static constexpr int RED_BYTES = 2 * 2 * 4 * D * 4;   // each warpgroup's (4, D) ds, dbb
  // after the last chunk x, the output staging and the tables take the ring
  static_assert(STAGES * STAGE_BYTES >= X_BYTES + OUT_BYTES + RED_BYTES, "ring");
  static constexpr size_t SMEM = 1024 + STAGES * STAGE_BYTES + 2 * D * 4 + 8 * (2 * STAGES + 1);
};

template <int D>
struct LnBwdW {
  static constexpr int CH = D / 64, HALVES = D / 192;
  static constexpr int STAGES = D == 384 ? 3 : 4;
  static constexpr int A_BYTES = kLbUnits * kLbSlice * 2;  // warpgroup w's 64 units at w * 8 KB
  static constexpr int B_BYTES = CH * kLbSlice * 128;      // chunk c: 64 rows at c * 8 KB
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr size_t SMEM = 1024 + STAGES * STAGE_BYTES + 1024 + 8 * 2 * STAGES;
};

template <int D>
__global__ void __launch_bounds__(kLbThreads, 1)
ln_bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap dy_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap dx_map,
                       const __grid_constant__ CUtensorMap xn_map, const float* __restrict__ s,
                       const float* __restrict__ bn, float* __restrict__ ln_part, int R, int K,
                       float eps) {
  using C = LnBwdDx<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // then x, the output staging and the tables
  float* ss = reinterpret_cast<float*>(ring + C::STAGES * C::STAGE_BYTES);
  float* bns = ss + D;
  uint64_t* full = reinterpret_cast<uint64_t*>(bns + D);
  uint64_t* empty = full + C::STAGES;
  uint64_t* xbar = empty + C::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = K / kLbChunk;
  const int r0 = blockIdx.x * kLbRows;
  if (tid == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // every consumer warp
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  for (int i = tid; i < D; i += kLbThreads) {
    ss[i] = s[i];
    bns[i] = bn[i];
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one lane issues every copy
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int st = c % C::STAGES;
        unsigned char* sp = ring + st * C::STAGE_BYTES;
        mbar_wait(&empty[st], ((c / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::STAGE_BYTES);
        tma_load_2d(sp, &dy_map, &full[st], c * kLbChunk, r0);
        for (int j = 0; j < C::CH; ++j)
          tma_load_2d(sp + C::DY_BYTES + j * kLbChunk * 128, &w_map, &full[st], 64 * j,
                      c * kLbChunk);
      }
      // x into the ring once every consumer warp has freed its last stages
      for (int c = chunks > C::STAGES ? chunks - C::STAGES : 0; c < chunks; ++c)
        mbar_wait(&empty[c % C::STAGES], (c / C::STAGES) & 1);
      mbar_expect_tx(xbar, C::X_BYTES);
      for (int j = 0; j < C::CH; ++j)
        tma_load_2d(ring + j * kLbRows * 128, &x_map, xbar, 64 * j, r0);
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumer warpgroup wg: rows rb ..; warp wl of it holds accumulator rows
  // 16 wl + g (+ 8). A warpgroup with no row below R only releases the chunks.
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int rb = r0 + 64 * wg;
  auto await = [&](int c) { mbar_wait(&full[c % C::STAGES], (c / C::STAGES) & 1); };
  auto release = [&](int c) {
    if (lane == 0) mbar_arrive(&empty[c % C::STAGES]);
  };
  if (rb >= R) {
    for (int c = 0; c < chunks; ++c) {
      await(c);
      release(c);
    }
    return;
  }

  // dxn: [4i + e] at row g + 8 (e >> 1), column 192 hf + 8i + 2 t4 + (e & 1)
  float acc[C::HALVES][96];
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[hf][i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    await(c);
    const unsigned char* sp = ring + (c % C::STAGES) * C::STAGE_BYTES;
    // descriptors: a base plus byte offsets / 16
    const uint64_t a = desc_k128(sp + wg * 64 * 128), b = desc_mn128(sp + C::DY_BYTES, 8192);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kLbChunk / 16; ++kk)
#pragma unroll
      for (int hf = 0; hf < C::HALVES; ++hf)
        wgmma_ss_m64n192k16<0, 1>(acc[hf], a + (kk * 32 >> 4),
                                  b + ((3 * hf * 8192 + kk * 16 * 128) >> 4));
    wgmma_commit();
    wgmma_wait<1>();  // the chunk before this one is done: free its stage
    if (c > 0) release(c - 1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf) fence_regs(acc[hf]);
  release(chunks - 1);

  // LN statistics and backward of this thread's rows ra, ra + 8, x read from
  // shared memory (it arrives in the ring, rows past R as zeros)
  const unsigned char* xs = ring;
  const int ra = 64 * wg + 16 * wl + g;  // CTA row
  mbar_wait(xbar, 0);
  auto xat = [&](int e, int col) { return bf16x2_at(xs + sw128_offset(ra + 8 * e, col)); };
  float mu[2], rs[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float2 xv = xat(e, 8 * i + 2 * t4);
      sum += xv.x + xv.y;
    }
    mu[e] = sum_over_quad(sum) / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float2 xv = xat(e, 8 * i + 2 * t4);
      const float d0 = xv.x - mu[e], d1 = xv.y - mu[e];
      q += d0 * d0 + d1 * d1;
    }
    rs[e] = 1.f / sqrtf(sum_over_quad(q) / D + eps);
  }
  float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};  // mean(dxh), mean(dxh xh)
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int col = 192 * hf + 8 * i + 2 * t4;
      const float2 sc = *reinterpret_cast<const float2*>(ss + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 xv = xat(e, col);
        const float xh0 = (xv.x - mu[e]) * rs[e], xh1 = (xv.y - mu[e]) * rs[e];
        const float d0 = acc[hf][4 * i + 2 * e] * sc.x, d1 = acc[hf][4 * i + 2 * e + 1] * sc.y;
        m1[e] += d0 + d1;
        m2[e] += d0 * xh0 + d1 * xh1;
      }
    }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    m1[e] = sum_over_quad(m1[e]) / D;
    m2[e] = sum_over_quad(m2[e]) / D;
  }

  // dx and xn, 64 columns at a time: staged in this warp's tiles (128-byte
  // swizzle, double-buffered) and written by TMA stores; the column sums of
  // dxn xh (ds) and dxn (dbb) over the warp's 16 rows (two a lane, then
  // shuffles over g) into (4, D) tables of the warpgroup, past x and the
  // staging in the ring
  unsigned char* wst = ring + C::X_BYTES + warp * 4 * 2048;
  float* red_ds = reinterpret_cast<float*>(ring + C::X_BYTES + C::OUT_BYTES) + wg * 2 * 4 * D;
  float* red_dbb = red_ds + 4 * D;
  const int wrow = rb + 16 * wl;  // this warp's first row
#pragma unroll
  for (int j = 0; j < C::CH; ++j) {
    unsigned char* bdx = wst + (j & 1) * 4096;
    unsigned char* bxn = bdx + 2048;
    if (lane == 0) bulk_wait_read<1>();  // the stores of chunk j - 2 have read these tiles
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = 64 * j + 8 * q + 2 * t4;
      const int hf = (64 * j + 8 * q) / 192, i = (64 * j + 8 * q) % 192 / 8;
      const float2 sc = *reinterpret_cast<const float2*>(ss + col);
      const float2 bb = *reinterpret_cast<const float2*>(bns + col);
      float sd0 = 0.f, sd1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 xv = xat(e, col);
        const float xh0 = (xv.x - mu[e]) * rs[e], xh1 = (xv.y - mu[e]) * rs[e];
        const float a0 = acc[hf][4 * i + 2 * e], a1 = acc[hf][4 * i + 2 * e + 1];
        const int off = (g + 8 * e) * 128 + ((q ^ g) << 4) + 4 * t4;
        *reinterpret_cast<uint32_t*>(bdx + off) =
            pack_bf16(rs[e] * (a0 * sc.x - m1[e] - xh0 * m2[e]),
                      rs[e] * (a1 * sc.y - m1[e] - xh1 * m2[e]));
        *reinterpret_cast<uint32_t*>(bxn + off) = pack_bf16(xh0 * sc.x + bb.x, xh1 * sc.y + bb.y);
        sd0 += a0 * xh0;
        sd1 += a1 * xh1;
        sb0 += a0;
        sb1 += a1;
      }
      sd0 = sum_over_g(sd0);
      sd1 = sum_over_g(sd1);
      sb0 = sum_over_g(sb0);
      sb1 = sum_over_g(sb1);
      if (g == 0) {
        *reinterpret_cast<float2*>(red_ds + wl * D + col) = make_float2(sd0, sd1);
        *reinterpret_cast<float2*>(red_dbb + wl * D + col) = make_float2(sb0, sb1);
      }
    }
    fence_proxy_async();  // the tiles' writes, seen by the TMA stores
    __syncwarp();
    if (lane == 0 && wrow < R) {
      tma_store_2d(&dx_map, bdx, 64 * j, wrow);
      tma_store_2d(&xn_map, bxn, 64 * j, wrow);
      bulk_commit();
    }
  }
  // each column of the tile's partials [ds | dbb] summed over the 4 warps in
  // order into ln_part
  named_barrier(1 + wg, 128);
  float* part = ln_part + (long long)(2 * blockIdx.x + wg) * 2 * D;
  const float* tables[2] = {red_ds, red_dbb};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* t = tables[q];
    for (int col = tid & 127; col < D; col += 128)
      part[q * D + col] = ((t[col] + t[D + col]) + t[2 * D + col]) + t[3 * D + col];
  }
  if (lane == 0) bulk_wait_read<0>();  // the tiles read before shared memory is freed
}

// One (128 units of K x D) tile of dW = dy^T xn over one row split
// (blockIdx.x the tile, blockIdx.y the split), and db = sum dy of its units;
// all f32, into the split's partial [dW (K, D) | db (K)].
template <int D>
__global__ void __launch_bounds__(kLbThreads, 1)
ln_bwd_w_wgmma_kernel(const __grid_constant__ CUtensorMap dy_map,
                      const __grid_constant__ CUtensorMap xn_map, float* __restrict__ part, int R,
                      int K, int rows_per_split) {
  using C = LnBwdW<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* ones = ring + C::STAGES * C::STAGE_BYTES;  // 8 rows x 128 bytes of bf16 1.0
  uint64_t* full = reinterpret_cast<uint64_t*>(ones + 1024);
  uint64_t* empty = full + C::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int u0 = blockIdx.x * kLbUnits;
  const int rs0 = blockIdx.y * rows_per_split;
  const int rs1 = min(R, rs0 + rows_per_split);
  const int nsl = rs1 > rs0 ? (rs1 - rs0 + kLbSlice - 1) / kLbSlice : 0;
  if (tid == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // every consumer warp
    }
    mbar_fence_init();
  }
  if (tid < 256) reinterpret_cast<uint32_t*>(ones)[tid] = 0x3F803F80u;
  fence_proxy_async();
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one lane issues every copy
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      for (int sl = 0; sl < nsl; ++sl) {
        const int st = sl % C::STAGES;
        unsigned char* sp = ring + st * C::STAGE_BYTES;
        mbar_wait(&empty[st], ((sl / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::STAGE_BYTES);
        const int k0 = rs0 + sl * kLbSlice;
        for (int w = 0; w < 2; ++w) tma_load_2d(sp + w * 8192, &dy_map, &full[st], u0 + 64 * w, k0);
        for (int c = 0; c < C::CH; ++c)
          tma_load_2d(sp + C::A_BYTES + c * 8192, &xn_map, &full[st], 64 * c, k0);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumer warpgroup wg: units u0 + 64 wg ..; warp wl of it holds
  // accumulator rows 16 wl + g (+ 8)
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  float acc[C::HALVES][96];
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[hf][i] = 0.f;
  float db[4] = {0.f, 0.f, 0.f, 0.f};  // sum over rows of A: every column the same
  const uint64_t ones_desc = desc_k128(ones);
  for (int sl = 0; sl < nsl; ++sl) {
    mbar_wait(&full[sl % C::STAGES], (sl / C::STAGES) & 1);
    const unsigned char* sp = ring + (sl % C::STAGES) * C::STAGE_BYTES;
    const uint64_t a = desc_mn128(sp + wg * 8192, 8192), b = desc_mn128(sp + C::A_BYTES, 8192);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kLbSlice / 16; ++kk) {  // descriptors: a base plus byte offsets / 16
      const uint64_t da = a + kk * (16 * 128 >> 4);
#pragma unroll
      for (int hf = 0; hf < C::HALVES; ++hf)
        wgmma_ss_m64n192k16<1, 1>(acc[hf], da, b + ((3 * hf * 8192 + kk * 16 * 128) >> 4));
      wgmma_ss_m64n8k16<1, 0>(db, da, ones_desc);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the slice before this one is done: free its stage
    if (sl > 0 && lane == 0) mbar_arrive(&empty[(sl - 1) % C::STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf) fence_regs(acc[hf]);
  fence_regs(db);

  float* out = part + blockIdx.y * ((long long)K * D + K);
  const int m[2] = {u0 + 64 * wg + 16 * wl + g, u0 + 64 * wg + 16 * wl + g + 8};
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int n = 192 * hf + 8 * i + 2 * t4;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (m[e] < K)
          *reinterpret_cast<float2*>(out + (long long)m[e] * D + n) =
              make_float2(acc[hf][4 * i + 2 * e], acc[hf][4 * i + 2 * e + 1]);
    }
  if (t4 == 0) {
    if (m[0] < K) out[(long long)K * D + m[0]] = db[0];
    if (m[1] < K) out[(long long)K * D + m[1]] = db[2];
  }
}

// x, dx, xn (R, D), dy (R, K), w (K, D) bf16; s, bn (D) f32; part holds
// max_splits x (K D + K) f32 partials, ln_part ceil(R / 64) x 2 D. Sets
// *splits to the number of partials written.
template <int D>
int launch_ln_bwd_wgmma(const void* x, const void* dy, const float* s, const float* bn,
                        const void* w, void* dx, void* xn, float* ln_part, float* part, int R,
                        int K, int max_splits, float eps, int* splits, cudaStream_t stream) {
  const uint64_t dd[2] = {(uint64_t)D, (uint64_t)R}, sd[1] = {(uint64_t)D * 2};
  const uint64_t dk[2] = {(uint64_t)K, (uint64_t)R}, sk[1] = {(uint64_t)K * 2};
  const uint64_t dw[2] = {(uint64_t)D, (uint64_t)K};
  const uint32_t box_rows[2] = {64, kLbRows}, box_64[2] = {64, 64}, box_out[2] = {64, 16};
  CUtensorMap x_m, dy_dx, w_m, dx_st, xn_st, dy_w, xn_w;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!make_tmap_bf16(&x_m, x, 2, dd, sd, box_rows, sw) ||
      !make_tmap_bf16(&dy_dx, dy, 2, dk, sk, box_rows, sw) ||
      !make_tmap_bf16(&w_m, w, 2, dw, sd, box_64, sw) ||
      !make_tmap_bf16(&dx_st, dx, 2, dd, sd, box_out, sw) ||
      !make_tmap_bf16(&xn_st, xn, 2, dd, sd, box_out, sw) ||
      !make_tmap_bf16(&dy_w, dy, 2, dk, sk, box_64, sw) ||
      !make_tmap_bf16(&xn_w, xn, 2, dd, sd, box_64, sw))
    return (int)cudaErrorInvalidValue;

  using CX = LnBwdDx<D>;
  auto kx = ln_bwd_dx_wgmma_kernel<D>;
  cudaFuncSetAttribute(kx, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CX::SMEM);
  kx<<<(R + kLbRows - 1) / kLbRows, kLbThreads, CX::SMEM, stream>>>(
      x_m, dy_dx, w_m, dx_st, xn_st, s, bn, ln_part, R, K, eps);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;

  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (K + kLbUnits - 1) / kLbUnits;
  const int sp = weight_splits(tiles, min(max_splits, (R + kLbSlice - 1) / kLbSlice), sms);
  const int rps = ((R + sp - 1) / sp + kLbSlice - 1) / kLbSlice * kLbSlice;  // whole slices
  using CW = LnBwdW<D>;
  auto kw = ln_bwd_w_wgmma_kernel<D>;
  cudaFuncSetAttribute(kw, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CW::SMEM);
  kw<<<dim3(tiles, sp), kLbThreads, CW::SMEM, stream>>>(dy_w, xn_w, part, R, K, rps);
  *splits = sp;
  return (int)cudaGetLastError();
}

template int launch_ln_bwd_wgmma<384>(const void*, const void*, const float*, const float*,
                                      const void*, void*, void*, float*, float*, int, int, int,
                                      float, int*, cudaStream_t);
template int launch_ln_bwd_wgmma<192>(const void*, const void*, const float*, const float*,
                                      const void*, void*, void*, float*, float*, int, int, int,
                                      float, int*, cudaStream_t);

}  // namespace vitocm
